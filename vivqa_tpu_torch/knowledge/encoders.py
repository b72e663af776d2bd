"""Knowledge encoders: text / visual / multimodal (counterpart of
vivqa_tpu/knowledge/encoders.py).

Counterpart of src/modeling/knowledge_base/knowledge_encoder.py:85-735 in
the reference (HF-encoder wrappers). The encoders wrap the port's own
towers (``models/encoders``): a ``TextEncoder`` or ``ViTEncoder`` with its
weights, run on the device its parameters are on, in inference mode, in
fixed-size chunks (the last one padded by repeating its last item, as the
JAX package pads for its jitted call), reading the pooled output as f32
and L2-normalising the rows. On the card each chunk's forward launches the
attention kernel once per encoder layer. Without a model,
``TextKnowledgeEncoder`` falls back to the parameter-free
``HashingTextEncoder``, whose md5 buckets give the JAX package's
embeddings byte for byte.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from vivqa_tpu_torch.knowledge.vector_store import normalize_rows
from vivqa_tpu_torch.knowledge.vietnamese import (VietnameseTokenizer,
                                                  normalize_vietnamese_text)


class HashingTextEncoder:
    """Deterministic feature-hashing text encoder (no params): tokens ->
    signed hash buckets, L2-normalized. A dependable dense fallback when
    no trained text tower is supplied."""

    def __init__(self, dim: int = 256, ngrams: int = 2):
        self.dim = dim
        self.ngrams = ngrams

    def _tokens(self, text: str):
        toks = VietnameseTokenizer().tokenize(
            normalize_vietnamese_text(text))
        grams = list(toks)
        for n in range(2, self.ngrams + 1):
            grams += [" ".join(toks[i:i + n])
                      for i in range(len(toks) - n + 1)]
        return grams

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            for g in self._tokens(t):
                h = int(hashlib.md5(g.encode()).hexdigest(), 16)
                sign = 1.0 if (h >> 64) & 1 else -1.0
                out[i, h % self.dim] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


def _padded_chunks(items: Sequence, batch_size: int):
    """(chunk of ``batch_size`` items, number of padding rows), the last
    chunk filled up with copies of its last item."""
    for start in range(0, len(items), batch_size):
        chunk = list(items[start:start + batch_size])
        pad = batch_size - len(chunk)
        yield chunk + [chunk[-1]] * pad, pad


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class TextKnowledgeEncoder:
    """Wraps the port's ``TextEncoder`` (with its weights) for batched
    pooled embeddings (reference :85-280); falls back to
    ``HashingTextEncoder`` without one. ``tokenizer`` is the tower's
    (``encode_batch``); the forward runs where the model's parameters
    are."""

    def __init__(self, model: Optional[torch.nn.Module] = None,
                 tokenizer=None, dim: int = 256, batch_size: int = 32):
        self.model = model
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self._fallback = HashingTextEncoder(dim) if model is None else None

    @property
    def dim(self) -> int:
        if self._fallback is not None:
            return self._fallback.dim
        return self.model.config.output_dim or self.model.config.hidden_dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if self._fallback is not None:
            return self._fallback.encode(texts)
        device = _device(self.model)
        outs = []
        for chunk, pad in _padded_chunks(texts, self.batch_size):
            enc = self.tokenizer.encode_batch(chunk)
            ids = torch.from_numpy(enc["input_ids"]).long().to(device)
            mask = torch.from_numpy(enc["attention_mask"]).long().to(device)
            with torch.inference_mode():
                emb = self.model(ids, mask)["pooled"]
            emb = emb.float().cpu().numpy()
            outs.append(emb[: len(emb) - pad] if pad else emb)
        return normalize_rows(np.concatenate(outs, 0))


class VisualKnowledgeEncoder:
    """Wraps the port's visual encoder (with its weights) for image
    embeddings (reference :282-463); images go through the eval-mode
    ``ImageAugmentation``."""

    def __init__(self, model: torch.nn.Module, image_size: int = 224,
                 batch_size: int = 16):
        from vivqa_tpu_torch.data.augmentation import ImageAugmentation
        self.model = model
        self.transform = ImageAugmentation(image_size, mode="eval")
        self.batch_size = batch_size

    def encode(self, images: Sequence) -> np.ndarray:
        device = _device(self.model)
        outs = []
        for chunk, pad in _padded_chunks(images, self.batch_size):
            px = torch.from_numpy(np.stack([self.transform(im)
                                            for im in chunk])).to(device)
            with torch.inference_mode():
                emb = self.model(px)["pooled"]
            emb = emb.float().cpu().numpy()
            outs.append(emb[: len(emb) - pad] if pad else emb)
        return normalize_rows(np.concatenate(outs, 0))


class MultimodalKnowledgeEncoder:
    """Fuses text + visual embeddings: concat | add | mean
    (reference :465-682)."""

    def __init__(self, text_encoder: TextKnowledgeEncoder,
                 visual_encoder: Optional[VisualKnowledgeEncoder] = None,
                 fuse: str = "concat"):
        if fuse not in ("concat", "add", "mean"):
            raise ValueError(f"unknown fuse '{fuse}' "
                             "(choices: concat, add, mean)")
        self.text = text_encoder
        self.visual = visual_encoder
        self.fuse = fuse

    def encode(self, texts: Sequence[str],
               images: Optional[Sequence] = None) -> np.ndarray:
        t = self.text.encode(texts)
        if images is None or self.visual is None:
            return t
        v = self.visual.encode(images)
        if self.fuse == "concat":
            out = np.concatenate([t, v], axis=-1)
        elif self.fuse == "add":
            d = min(t.shape[-1], v.shape[-1])
            out = t[:, :d] + v[:, :d]
        else:
            d = min(t.shape[-1], v.shape[-1])
            out = 0.5 * (t[:, :d] + v[:, :d])
        return normalize_rows(out)


def create_text_knowledge_encoder(**kwargs) -> TextKnowledgeEncoder:
    return TextKnowledgeEncoder(**kwargs)


def create_multimodal_knowledge_encoder(**kwargs) -> MultimodalKnowledgeEncoder:
    return MultimodalKnowledgeEncoder(**kwargs)
