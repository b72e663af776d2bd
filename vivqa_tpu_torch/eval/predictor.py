"""Inference predictor for classification VQA (counterpart of
vivqa_tpu/eval/predictor.py): single and batch prediction with image
preprocessing, softmax, top-k answer decoding with confidences, and
timing. Batches pad to a multiple of ``batch_pad`` by repeating the last
request, as the JAX predictor pads to keep its jit cache warm.

Runs on the card by default; raises without CUDA unless
``device="cpu"``. The model it is given is moved to that device in
place. ``inference_ms`` is host time around the forward that ends in
``torch.cuda.synchronize()`` on the card, so it covers the device work
and not only its enqueue.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.device import resolve_device


@dataclasses.dataclass
class PredictionResult:
    question: str
    answer: str
    confidence: float
    top_answers: List[Dict]
    inference_ms: float


class VQAPredictor:
    def __init__(self, model: torch.nn.Module, tokenizer,
                 id2answer: Dict[int, str], image_size: int = 224,
                 top_k: int = 5, max_question_length: Optional[int] = None,
                 batch_pad: int = 8, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.id2answer = id2answer
        self.top_k = top_k
        self.max_q = max_question_length or getattr(tokenizer, "max_length",
                                                    64)
        self.transform = ImageAugmentation(image_size, mode="eval")
        self.batch_pad = batch_pad

    # -- internals ---------------------------------------------------------
    @torch.inference_mode()
    def _forward(self, px: np.ndarray, ids: np.ndarray,
                 mask: np.ndarray) -> tuple[np.ndarray, float]:
        """Softmax probabilities (N, A) as numpy, and the ms it took."""
        t0 = time.perf_counter()
        dev = self.device
        out = self.model(torch.from_numpy(px).to(dev),
                         torch.from_numpy(ids).to(dev),
                         torch.from_numpy(mask).to(dev))
        probs = torch.softmax(out["logits"].float(), dim=-1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        probs = probs.cpu().numpy()
        return probs, (time.perf_counter() - t0) * 1000

    def _decode(self, probs: np.ndarray, question: str,
                dt_ms: float) -> PredictionResult:
        order = np.argsort(-probs)[: self.top_k]
        top = [{"answer": self.id2answer.get(int(i), "<unk>"),
                "confidence": float(probs[i])} for i in order]
        return PredictionResult(question=question, answer=top[0]["answer"],
                                confidence=top[0]["confidence"],
                                top_answers=top, inference_ms=dt_ms)

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        pad = (-arr.shape[0]) % self.batch_pad
        if pad:
            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, 0)], 0)
        return arr

    # -- public API ---------------------------------------------------------
    def predict(self, image, question: str) -> PredictionResult:
        return self.predict_arrays(self.transform(image), question)

    def predict_arrays(self, pixel_values: np.ndarray,
                       question: str) -> PredictionResult:
        enc = self.tokenizer.encode_batch([question], self.max_q)
        probs, dt = self._forward(
            np.ascontiguousarray(pixel_values[None], np.float32),
            enc["input_ids"], enc["attention_mask"])
        return self._decode(probs[0], question, dt)

    def predict_batch(self, images: Sequence, questions: Sequence[str],
                      result_manager=None) -> List[PredictionResult]:
        px = self._pad(np.stack([self.transform(im) for im in images]))
        enc = self.tokenizer.encode_batch(list(questions), self.max_q)
        probs, dt = self._forward(px, self._pad(enc["input_ids"]),
                                  self._pad(enc["attention_mask"]))
        dt /= max(len(questions), 1)
        results = [self._decode(probs[i], q, dt)
                   for i, q in enumerate(questions)]
        if result_manager is not None:
            for r in results:
                result_manager.add(r)
        return results
