"""Word-level whitespace tokenizer: a copy of ``WhitespaceTokenizer`` from
vivqa_tpu/data/tokenizer.py (the port imports nothing of the JAX
package). Encoders produce fixed-length int32 numpy arrays."""

from __future__ import annotations

import json
import re
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

PAD, UNK, BOS, EOS = "<pad>", "<unk>", "<s>", "</s>"


class WhitespaceTokenizer:
    """Word-level tokenizer with special tokens pad=0, unk=1, bos=2, eos=3."""

    def __init__(self, vocab: Dict[str, int] | None = None,
                 max_length: int = 64, lowercase: bool = True):
        self.max_length = max_length
        self.lowercase = lowercase
        self.vocab = vocab or {PAD: 0, UNK: 1, BOS: 2, EOS: 3}

    # -- special ids ------------------------------------------------------
    pad_token_id = property(lambda self: self.vocab[PAD])
    unk_token_id = property(lambda self: self.vocab[UNK])
    bos_token_id = property(lambda self: self.vocab[BOS])
    eos_token_id = property(lambda self: self.vocab[EOS])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _norm(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFC", str(text))
        if self.lowercase:
            text = text.lower()
        text = re.sub(r"([.,!?;:])", r" \1 ", text)
        return text.split()

    def build_vocab(self, corpus: Sequence[str], min_freq: int = 1,
                    max_vocab: int | None = None) -> None:
        counter = Counter(w for t in corpus for w in self._norm(t))
        items = [(w, c) for w, c in counter.most_common() if c >= min_freq]
        if max_vocab:
            items = items[: max(0, max_vocab - len(self.vocab))]
        for w, _ in items:
            if w not in self.vocab:
                self.vocab[w] = len(self.vocab)
        self._inv = {i: w for w, i in self.vocab.items()}

    def encode(self, text: str, max_length: int | None = None,
               add_special_tokens: bool = False) -> np.ndarray:
        L = max_length or self.max_length
        ids = [self.vocab.get(w, self.unk_token_id) for w in self._norm(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids[: L - 2] + [self.eos_token_id]
        ids = ids[:L]
        ids = ids + [self.pad_token_id] * (L - len(ids))
        return np.asarray(ids, np.int32)

    def encode_batch(self, texts: Sequence[str], max_length: int | None = None,
                     add_special_tokens: bool = False):
        ids = np.stack([self.encode(t, max_length, add_special_tokens)
                        for t in texts])
        mask = (ids != self.pad_token_id).astype(np.int32)
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        if not hasattr(self, "_inv") or len(self._inv) != len(self.vocab):
            self._inv = {i: w for w, i in self.vocab.items()}
        special = {self.pad_token_id, self.bos_token_id, self.eos_token_id,
                   self.unk_token_id} if skip_special_tokens else set()
        words = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i == self.eos_token_id:
                break
            if i in special:
                continue
            words.append(self._inv.get(i, UNK))
        return " ".join(words)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(
            {"vocab": self.vocab, "max_length": self.max_length,
             "lowercase": self.lowercase}, ensure_ascii=False))

    @classmethod
    def load(cls, path: str | Path) -> "WhitespaceTokenizer":
        data = json.loads(Path(path).read_text())
        return cls(vocab=data["vocab"], max_length=data["max_length"],
                   lowercase=data.get("lowercase", True))
