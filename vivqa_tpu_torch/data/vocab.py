"""Answer vocabulary: a copy of vivqa_tpu/data/vocab.py (reference
build_answer_vocab, src/data/dataset.py:172-201): majority answer per
sample, min_freq filter, `<unk>` = 0. These quirks define metric
parity — keep them exactly."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence, Tuple

from vivqa_tpu_torch.data.schema import OneSample

UNK_TOKEN = "<unk>"


def majority_answer(answers: Sequence[str]) -> str:
    """Most common answer; first-seen wins ties (Counter.most_common
    preserves insertion order for equal counts, matching the reference's
    torch.mode-free Python Counter use)."""
    return Counter(answers).most_common(1)[0][0]


def build_answer_vocab(samples: Sequence[OneSample],
                       min_freq: int = 1) -> Tuple[Dict[str, int], Dict[int, str]]:
    counts = Counter(majority_answer(s.answers) for s in samples)
    answer2id = {UNK_TOKEN: 0}
    for ans, c in counts.most_common():
        if c >= min_freq:
            answer2id[ans] = len(answer2id)
    id2answer = {i: a for a, i in answer2id.items()}
    return answer2id, id2answer


def encode_answer_counts(answers: Sequence[str],
                         answer2id: Dict[str, int]) -> Dict[int, int]:
    """{answer_id: count} for VQA soft accuracy (reference dataset.py:
    140-168 passes answer_counts through the collate)."""
    out: Dict[int, int] = {}
    for a in answers:
        i = answer2id.get(a, 0)
        out[i] = out.get(i, 0) + 1
    return out
