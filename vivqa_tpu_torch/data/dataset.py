"""Datasets producing fixed-shape numpy batches: a copy of
vivqa_tpu/data/dataset.py (the port imports nothing of the JAX package).

- VQADataset: lazy image load with black placeholder, tokenized
  question, majority-vote label, all_answers + answer_counts for soft
  accuracy.
- GenerativeVQADataset: teacher-forcing construction
  decoder_input_ids=[BOS]+ans, labels=ans+[EOS], label padding = -100.

Pixels go through the dataset's ``ImageAugmentation``; ``load_batch``
builds a whole batch through the native loader (``transform.batch``) and
returns None where it is not available. ``data/loader.py:BatchLoader``
takes that path only with the dataset's own collate
(``default_collate``), where the two paths are equivalent.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from vivqa_tpu_torch.data.augmentation import ImageAugmentation
from vivqa_tpu_torch.data.schema import OneSample
from vivqa_tpu_torch.data.vocab import encode_answer_counts, majority_answer
from vivqa_tpu_torch.train.losses import IGNORE_INDEX


class VQADataset:
    """Classification dataset: __getitem__ -> dict of numpy arrays."""

    def __init__(self, samples: Sequence[OneSample], tokenizer,
                 answer2id: Dict[str, int], transform: ImageAugmentation,
                 max_question_length: int = 64,
                 answer_selection: str = "majority",
                 text_transform=None):
        self.samples = list(samples)
        self.tokenizer = tokenizer
        self.answer2id = answer2id
        self.transform = transform
        self.max_question_length = max_question_length
        self.answer_selection = answer_selection
        # train-split-only TextAugmentation (reference augmentation.py:
        # 350-473); None = identity
        self.text_transform = text_transform

    def __len__(self):
        return len(self.samples)

    def _meta(self, idx: int) -> Dict[str, np.ndarray]:
        """Everything except the image tensor."""
        s = self.samples[idx]
        q = self.text_transform(s.question) if self.text_transform \
            else s.question
        enc = self.tokenizer.encode_batch([q], self.max_question_length)
        label = self.answer2id.get(majority_answer(s.answers), 0)
        return {
            "input_ids": enc["input_ids"][0],
            "attention_mask": enc["attention_mask"][0],
            "labels": np.int32(label),
            "answer_counts": encode_answer_counts(s.answers, self.answer2id),
            "all_answers": list(s.answers),
            "question": s.question,
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self._meta(idx)
        pixel = self.transform(self.samples[idx].image_path)
        item["pixel_values"] = pixel.astype(np.float32)
        return item

    def load_batch(self, indices) -> Dict | None:
        """Collated batch with images through the native loader (one
        threaded C++ call: decode + augment + normalize); None without
        it, and the BatchLoader then collates item by item."""
        pixels = self.transform.batch(
            [self.samples[int(i)].image_path for i in indices])
        if pixels is None:
            return None
        batch = vqa_collate([self._meta(int(i)) for i in indices])
        batch["pixel_values"] = pixels
        return batch


def vqa_collate(items: List[Dict]) -> Dict:
    """Stack tensors; pass through python fields (reference
    vqa_collate_fn, dataset.py:204-251). Keys absent from the items
    (e.g. pixel_values when the native batch loader supplies them) are
    skipped."""
    out = {}
    for k in ("pixel_values", "input_ids", "attention_mask", "labels"):
        if k in items[0]:
            out[k] = np.stack([it[k] for it in items])
    for k in ("answer_counts", "all_answers", "question"):
        out[k] = [it[k] for it in items]
    return out


class GenerativeVQADataset:
    """Seq2seq dataset with teacher-forcing targets."""

    def __init__(self, samples: Sequence[OneSample], tokenizer,
                 transform: ImageAugmentation,
                 max_question_length: int = 64,
                 max_answer_length: int = 64,
                 answer_selection: str = "majority",
                 seed: int = 0, text_transform=None):
        self.samples = list(samples)
        self.tokenizer = tokenizer
        self.transform = transform
        self.max_question_length = max_question_length
        self.max_answer_length = max_answer_length
        if answer_selection not in ("majority", "random", "first"):
            raise ValueError(f"unknown answer_selection '{answer_selection}'")
        self.answer_selection = answer_selection
        self._rng = np.random.RandomState(seed)
        self.text_transform = text_transform

    def __len__(self):
        return len(self.samples)

    def _pick_answer(self, answers: Sequence[str]) -> str:
        if self.answer_selection == "majority":
            return majority_answer(answers)
        if self.answer_selection == "random":
            return answers[self._rng.randint(len(answers))]
        return answers[0]

    def _meta(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.samples[idx]
        tok = self.tokenizer
        q_text = self.text_transform(s.question) if self.text_transform \
            else s.question
        q = tok.encode_batch([q_text], self.max_question_length)
        answer = self._pick_answer(s.answers)
        # raw answer ids without special tokens
        ans_ids = [i for i in tok.encode(answer, self.max_answer_length)
                   if i not in (tok.pad_token_id,)]
        ans_ids = [i for i in ans_ids
                   if i not in (tok.bos_token_id, tok.eos_token_id)]
        L = self.max_answer_length
        ans_ids = list(ans_ids)[: L - 1]
        dec_in = [tok.bos_token_id] + ans_ids
        labels = ans_ids + [tok.eos_token_id]
        dec_mask = [1] * len(dec_in)
        pad = L - len(dec_in)
        dec_in = dec_in + [tok.pad_token_id] * pad
        labels = labels + [IGNORE_INDEX] * pad
        dec_mask = dec_mask + [0] * pad
        return {
            "question_ids": q["input_ids"][0],
            "question_mask": q["attention_mask"][0],
            "decoder_input_ids": np.asarray(dec_in, np.int32),
            "decoder_mask": np.asarray(dec_mask, np.int32),
            "labels": np.asarray(labels, np.int32),
            "answer_text": answer,
            "all_answers": list(s.answers),
            "question": s.question,
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self._meta(idx)
        pixel = self.transform(self.samples[idx].image_path)
        item["pixel_values"] = pixel.astype(np.float32)
        return item

    def load_batch(self, indices) -> Dict | None:
        """Native-loader batch path (see VQADataset.load_batch)."""
        pixels = self.transform.batch(
            [self.samples[int(i)].image_path for i in indices])
        if pixels is None:
            return None
        batch = generative_collate([self._meta(int(i)) for i in indices])
        batch["pixel_values"] = pixels
        return batch


def generative_collate(items: List[Dict]) -> Dict:
    out = {}
    for k in ("pixel_values", "question_ids", "question_mask",
              "decoder_input_ids", "decoder_mask", "labels"):
        if k in items[0]:
            out[k] = np.stack([it[k] for it in items])
    for k in ("answer_text", "all_answers", "question"):
        out[k] = [it[k] for it in items]
    return out


# the native load_batch path is only equivalent to the per-item path when
# the loader uses the dataset's own collate: BatchLoader checks this
# marker before taking it (a custom collate must keep seeing every item)
VQADataset.default_collate = staticmethod(vqa_collate)
GenerativeVQADataset.default_collate = staticmethod(generative_collate)
