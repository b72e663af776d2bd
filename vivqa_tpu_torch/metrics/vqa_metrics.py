"""VQA classification metrics: a copy of vivqa_tpu/metrics/vqa_metrics.py.

Counterpart of src/solvers/metrics/vqa_metrics.py in the reference:
VQAAccuracy (soft min(count/3,1), :75-155), VQASoftAccuracy (:993),
TopKAccuracy (:158), ExactMatchAccuracy (:483), F1Score (:327),
AnswerTypeAccuracy (:409), PrecisionRecallF1 token-level (:1064),
WUPS (:222 — WordNet Wu-Palmer when nltk data is present, else a
normalized-string fallback so the metric degrades gracefully offline).

The behavioral quirks that define metric parity (SURVEY §7.3.7) are kept:
answer-count dicts for soft accuracy, normalized string match vs any
reference, macro/micro/weighted F1 semantics.
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np

from vivqa_tpu_torch.metrics.base import BaseMetric, MetricResult


def normalize_answer(text: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace."""
    text = unicodedata.normalize("NFC", str(text)).lower().strip()
    text = re.sub(r"[^\w\s]", "", text, flags=re.UNICODE)
    return re.sub(r"\s+", " ", text).strip()


class VQAAccuracy(BaseMetric):
    """VQA-v2 soft accuracy: min(#humans_matching/3, 1) averaged."""
    name = "vqa_accuracy"

    def reset(self):
        self.scores: List[float] = []

    def update(self, predictions: Sequence[int],
               answer_counts: Sequence[Dict[int, int]]):
        """predictions: answer ids; answer_counts: {answer_id: count}."""
        for pred, counts in zip(predictions, answer_counts):
            count = counts.get(int(pred), 0)
            self.scores.append(min(count / 3.0, 1.0))

    def compute(self) -> MetricResult:
        value = float(np.mean(self.scores)) if self.scores else 0.0
        return MetricResult(value, per_sample=list(self.scores))


class VQASoftAccuracy(VQAAccuracy):
    """Alias used by the training loop (reference :993)."""
    name = "vqa_soft_accuracy"


class TopKAccuracy(BaseMetric):
    name = "topk_accuracy"

    def __init__(self, k: int = 5):
        self.k = k
        super().__init__()

    def reset(self):
        self.correct = 0
        self.total = 0

    def update(self, logits: np.ndarray, labels: Sequence[int]):
        logits = np.asarray(logits)
        labels = np.asarray(labels)
        topk = np.argsort(-logits, axis=-1)[:, : self.k]
        self.correct += int((topk == labels[:, None]).any(axis=1).sum())
        self.total += len(labels)

    def compute(self) -> MetricResult:
        return MetricResult(self.correct / self.total if self.total else 0.0)


class ExactMatchAccuracy(BaseMetric):
    """Normalized string match vs ANY reference (reference :483)."""
    name = "exact_match"

    def reset(self):
        self.scores: List[float] = []

    def update(self, predictions: Sequence[str],
               references: Sequence[Sequence[str] | str]):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            p = normalize_answer(pred)
            self.scores.append(
                1.0 if any(p == normalize_answer(r) for r in refs) else 0.0)

    def compute(self) -> MetricResult:
        return MetricResult(float(np.mean(self.scores)) if self.scores else 0.0,
                            per_sample=list(self.scores))


class F1Score(BaseMetric):
    """Multi-class F1: macro / micro / weighted (reference :327-407)."""
    name = "f1"

    def __init__(self, average: str = "macro"):
        if average not in ("macro", "micro", "weighted"):
            raise ValueError(f"unknown F1 average '{average}'")
        self.average = average
        super().__init__()

    def reset(self):
        self.tp = Counter()
        self.fp = Counter()
        self.fn = Counter()
        self.support = Counter()

    def update(self, predictions: Sequence[int], labels: Sequence[int]):
        for p, l in zip(predictions, labels):
            p, l = int(p), int(l)
            self.support[l] += 1
            if p == l:
                self.tp[p] += 1
            else:
                self.fp[p] += 1
                self.fn[l] += 1

    def compute(self) -> MetricResult:
        classes = sorted(set(self.tp) | set(self.fp) | set(self.fn)
                         | set(self.support))
        per_class = {}
        for c in classes:
            tp, fp, fn = self.tp[c], self.fp[c], self.fn[c]
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            per_class[c] = (2 * prec * rec / (prec + rec)
                            if prec + rec else 0.0)
        if not classes:
            return MetricResult(0.0, per_class={})
        if self.average == "micro":
            tp = sum(self.tp.values())
            fp = sum(self.fp.values())
            fn = sum(self.fn.values())
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / (tp + fn) if tp + fn else 0.0
            value = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        elif self.average == "weighted":
            total = sum(self.support.values())
            value = sum(per_class[c] * self.support[c] for c in classes) / total
        else:
            value = float(np.mean(list(per_class.values())))
        return MetricResult(value, per_class=per_class)


# Vietnamese question-type keywords (reference VQAEvaluator
# _get_question_type, vqa_evaluator.py:199-228)
QUESTION_TYPE_KEYWORDS = {
    "count": ("bao nhiêu", "mấy", "how many"),
    "color": ("màu", "color"),
    "location": ("ở đâu", "chỗ nào", "where"),
    "yes_no": ("có phải", "phải không", "đúng không", "is it", "are there"),
    "what": ("cái gì", "là gì", "what"),
    "who": ("ai", "who"),
}


def classify_question_type(question: str) -> str:
    q = question.lower()
    for qtype, kws in QUESTION_TYPE_KEYWORDS.items():
        if any(kw in q for kw in kws):
            return qtype
    return "other"


class AnswerTypeAccuracy(BaseMetric):
    """Per question-type accuracy (reference :409)."""
    name = "answer_type_accuracy"

    def reset(self):
        self.correct = defaultdict(int)
        self.total = defaultdict(int)

    def update(self, predictions: Sequence[int], labels: Sequence[int],
               questions: Sequence[str]):
        for p, l, q in zip(predictions, labels, questions):
            t = classify_question_type(q)
            self.total[t] += 1
            if int(p) == int(l):
                self.correct[t] += 1

    def compute(self) -> MetricResult:
        per_class = {t: self.correct[t] / self.total[t]
                     for t in self.total if self.total[t]}
        overall = (sum(self.correct.values()) / sum(self.total.values())
                   if self.total else 0.0)
        return MetricResult(overall, per_class=per_class)


class PrecisionRecallF1(BaseMetric):
    """Token-level bag-of-words P/R/F1 (reference :1064; also the ViVQA
    eval pipeline's custom variant, vivqa_evaluation_pipeline.py:399)."""
    name = "token_prf"

    def reset(self):
        self.p: List[float] = []
        self.r: List[float] = []
        self.f: List[float] = []

    def update(self, predictions: Sequence[str],
               references: Sequence[Sequence[str] | str]):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            pt = normalize_answer(pred).split()
            best = (0.0, 0.0, 0.0)
            for ref in refs:
                rt = normalize_answer(ref).split()
                common = Counter(pt) & Counter(rt)
                n = sum(common.values())
                prec = n / len(pt) if pt else 0.0
                rec = n / len(rt) if rt else 0.0
                f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
                if f1 >= best[2]:
                    best = (prec, rec, f1)
            self.p.append(best[0])
            self.r.append(best[1])
            self.f.append(best[2])

    def compute(self) -> MetricResult:
        f = float(np.mean(self.f)) if self.f else 0.0
        return MetricResult(f, metadata={
            "precision": float(np.mean(self.p)) if self.p else 0.0,
            "recall": float(np.mean(self.r)) if self.r else 0.0})


def _wordnet_or_none():
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("dog")  # raises LookupError if data missing
        return wordnet
    except (ImportError, LookupError):
        return None


class WUPS(BaseMetric):
    """Wu-Palmer similarity score (reference :222-324). Similarity
    backend chain: NLTK WordNet when its data is installed -> the
    built-in bilingual taxonomy (metrics/taxonomy.py, covers the common
    VQA answer vocabulary in English AND Vietnamese — strictly better
    than the reference on ViVQA, where English WordNet has no entries)
    -> exact match."""
    name = "wups"

    def __init__(self, threshold: float = 0.9):
        self.threshold = threshold
        self._wn = _wordnet_or_none()
        super().__init__()

    def reset(self):
        self.scores: List[float] = []

    def _word_sim(self, a: str, b: str) -> float:
        if a == b:
            return 1.0
        if self._wn is not None:
            sa = self._wn.synsets(a)
            sb = self._wn.synsets(b)
            best = 0.0
            for x in sa[:5]:
                for y in sb[:5]:
                    s = x.wup_similarity(y)
                    if s and s > best:
                        best = s
            if sa and sb:
                return best
        from vivqa_tpu_torch.metrics.taxonomy import taxonomy_wup
        t = taxonomy_wup(a, b)
        return t if t is not None else 0.0

    def _set_score(self, pred_tokens, ref_tokens) -> float:
        if not pred_tokens or not ref_tokens:
            return 1.0 if pred_tokens == ref_tokens else 0.0

        def side(xs, ys):
            prod = 1.0
            for x in xs:
                best = max((self._word_sim(x, y) for y in ys), default=0.0)
                if best < self.threshold:
                    best *= 0.1
                prod *= best
            return prod
        return min(side(pred_tokens, ref_tokens), side(ref_tokens, pred_tokens))

    def update(self, predictions: Sequence[str],
               references: Sequence[Sequence[str] | str]):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            pt = normalize_answer(pred).split()
            score = max((self._set_score(pt, normalize_answer(r).split())
                         for r in refs), default=0.0)
            self.scores.append(score)

    def compute(self) -> MetricResult:
        return MetricResult(float(np.mean(self.scores)) if self.scores else 0.0,
                            per_sample=list(self.scores))
