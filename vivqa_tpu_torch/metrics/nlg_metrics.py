"""NLG metrics for generative VQA: BLEU, METEOR, ROUGE, CIDEr; a copy of
vivqa_tpu/metrics/nlg_metrics.py.

Counterpart of the reference's implementations
(src/solvers/metrics/vqa_metrics.py:579-990). Self-contained (no NLTK
data dependencies, matching a zero-egress environment):

- BLEU: corpus BLEU with uniform n-gram weights and smoothing method-1
  (add-epsilon on zero counts), the configuration the reference uses via
  nltk.corpus_bleu (:579-644).
- METEOR: standard exact-match METEOR (unigram alignment, F-mean beta=3,
  chunk fragmentation penalty), best-of-references — the reference uses
  NLTK's wordnet-backed meteor (:647-712); without wordnet data the
  synonym stage is skipped (exact + stem-ish lowercase matching).
- ROUGE: own LCS DP for rouge-L plus rouge-1/2 n-gram overlap F1,
  best-of-references (:715-844).
- CIDEr: own TF-IDF n-gram (1..4) cosine with the x10 scaling (:847-990).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

import numpy as np

from vivqa_tpu_torch.metrics.base import BaseMetric, MetricResult
from vivqa_tpu_torch.metrics.vqa_metrics import normalize_answer


def _tokenize(text: str) -> List[str]:
    return normalize_answer(text).split()


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU
# ---------------------------------------------------------------------------

class BLEUScore(BaseMetric):
    """Corpus BLEU-n with smoothing method 1."""
    name = "bleu"

    def __init__(self, max_n: int = 4):
        self.max_n = max_n
        super().__init__()

    def reset(self):
        self.match = [0] * self.max_n
        self.total = [0] * self.max_n
        self.pred_len = 0
        self.ref_len = 0

    def update(self, predictions: Sequence[str],
               references: Sequence[Sequence[str] | str]):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            pt = _tokenize(pred)
            rts = [_tokenize(r) for r in refs]
            self.pred_len += len(pt)
            # closest reference length (standard corpus BLEU)
            if rts:
                self.ref_len += min((abs(len(r) - len(pt)), len(r))
                                    for r in rts)[1]
            for n in range(1, self.max_n + 1):
                pn = _ngrams(pt, n)
                max_ref = Counter()
                for rt in rts:
                    rn = _ngrams(rt, n)
                    for g, c in rn.items():
                        max_ref[g] = max(max_ref[g], c)
                clipped = sum(min(c, max_ref[g]) for g, c in pn.items())
                self.match[n - 1] += clipped
                self.total[n - 1] += max(sum(pn.values()), 0)

    def compute(self) -> MetricResult:
        eps = 0.1  # smoothing method 1: add epsilon to zero counts
        log_p = 0.0
        # effective order: orders with no n-grams at all (corpus of very
        # short answers) are skipped rather than zeroing the score
        orders = [n for n in range(self.max_n) if self.total[n] > 0]
        if not orders:
            return MetricResult(0.0)
        for n in orders:
            m = self.match[n] if self.match[n] > 0 else eps
            log_p += math.log(m / self.total[n])
        log_p /= len(orders)
        bp = (1.0 if self.pred_len > self.ref_len else
              math.exp(1 - self.ref_len / max(self.pred_len, 1)))
        return MetricResult(bp * math.exp(log_p),
                            metadata={"brevity_penalty": bp,
                                      "pred_len": self.pred_len,
                                      "ref_len": self.ref_len})


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------

def _porter():
    """NLTK's PorterStemmer is pure code (no corpus download needed)."""
    try:
        from nltk.stem import PorterStemmer
        return PorterStemmer()
    except ImportError:                                # pragma: no cover
        return None


_STEMMER = _porter()


def _meteor_align(pred: List[str], ref: List[str]) -> tuple[int, int]:
    """Staged greedy alignment (NLTK meteor stages, reference :647-712):
    1) exact, 2) Porter stem, 3) synonym via the built-in taxonomy
    (WordNet data is absent offline; the taxonomy covers the VQA answer
    vocabulary bilingually). Returns (#matches, #chunks)."""
    from vivqa_tpu_torch.metrics.taxonomy import taxonomy_synonyms

    def stages():
        yield lambda w, r: w == r
        if _STEMMER is not None:
            yield lambda w, r: _STEMMER.stem(w) == _STEMMER.stem(r)
        yield taxonomy_synonyms

    used_ref = [False] * len(ref)
    used_pred = [False] * len(pred)
    align = []  # (pred_i, ref_j)
    for match in stages():
        for i, w in enumerate(pred):
            if used_pred[i]:
                continue
            for j, r in enumerate(ref):
                if not used_ref[j] and match(w, r):
                    used_ref[j] = True
                    used_pred[i] = True
                    align.append((i, j))
                    break
    if not align:
        return 0, 0
    align.sort()
    chunks = 1
    for (pi, pj), (ci, cj) in zip(align, align[1:]):
        if ci != pi + 1 or cj != pj + 1:
            chunks += 1
    return len(align), chunks


def meteor_score(pred: str, ref: str, beta: float = 3.0,
                 gamma: float = 0.5) -> float:
    pt, rt = _tokenize(pred), _tokenize(ref)
    if not pt or not rt:
        return 0.0
    m, chunks = _meteor_align(pt, rt)
    if m == 0:
        return 0.0
    p = m / len(pt)
    r = m / len(rt)
    fmean = p * r * (1 + beta**2) / (r + beta**2 * p)
    penalty = gamma * (chunks / m) ** 3
    return fmean * (1 - penalty)


class METEORScore(BaseMetric):
    name = "meteor"

    def reset(self):
        self.scores: List[float] = []

    def update(self, predictions, references):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            self.scores.append(max((meteor_score(pred, r) for r in refs),
                                   default=0.0))

    def compute(self) -> MetricResult:
        return MetricResult(float(np.mean(self.scores)) if self.scores else 0.0)


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------

def _lcs_len(a: List[str], b: List[str]) -> int:
    """Classic DP (reference's own implementation, vqa_metrics.py:758-787)."""
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l_f1(pred: str, ref: str) -> float:
    pt, rt = _tokenize(pred), _tokenize(ref)
    if not pt or not rt:
        return 0.0
    lcs = _lcs_len(pt, rt)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(pt), lcs / len(rt)
    return 2 * p * r / (p + r)


def rouge_n_f1(pred: str, ref: str, n: int) -> float:
    pn, rn = _ngrams(_tokenize(pred), n), _ngrams(_tokenize(ref), n)
    if not pn or not rn:
        return 0.0
    overlap = sum((pn & rn).values())
    if overlap == 0:
        return 0.0
    p = overlap / sum(pn.values())
    r = overlap / sum(rn.values())
    return 2 * p * r / (p + r)


class ROUGEScore(BaseMetric):
    """rouge1/rouge2/rougeL, best-of-references; `value` is rougeL."""
    name = "rouge"

    def reset(self):
        self.r1: List[float] = []
        self.r2: List[float] = []
        self.rl: List[float] = []

    def update(self, predictions, references):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            self.r1.append(max((rouge_n_f1(pred, r, 1) for r in refs), default=0.0))
            self.r2.append(max((rouge_n_f1(pred, r, 2) for r in refs), default=0.0))
            self.rl.append(max((rouge_l_f1(pred, r) for r in refs), default=0.0))

    def compute(self) -> MetricResult:
        mean = lambda xs: float(np.mean(xs)) if xs else 0.0
        return MetricResult(mean(self.rl), metadata={
            "rouge1": mean(self.r1), "rouge2": mean(self.r2),
            "rougeL": mean(self.rl)})


# ---------------------------------------------------------------------------
# CIDEr
# ---------------------------------------------------------------------------

class CIDErScore(BaseMetric):
    """TF-IDF weighted n-gram cosine, n=1..4, x10.

    Two formula styles (documented in PARITY.md):
    - style="reference" (default): EXACTLY the reference's formula
      (src/solvers/metrics/vqa_metrics.py:847-990): lower().split()
      tokenization, RAW term frequency, idf = log((N+1)/(df+1)) with 0
      for unseen n-grams, cosine per n averaged over n then over
      references, no length penalty. Drop-in number parity.
    - style="paper": closer to Vedantam et al. 2015 — normalized
      answers, TF normalized by length, idf = log(N) - log(max(df,1)),
      gaussian length penalty (sigma).
    """
    name = "cider"

    def __init__(self, max_n: int = 4, sigma: float = 6.0,
                 style: str = "reference"):
        if style not in ("reference", "paper"):
            raise ValueError(f"unknown CIDEr style '{style}'")
        self.max_n = max_n
        self.sigma = sigma
        self.style = style
        super().__init__()

    def reset(self):
        self.preds: List[List[str]] = []
        self.refs: List[List[List[str]]] = []

    def _tok(self, text: str) -> List[str]:
        if self.style == "reference":
            # reference _get_ngrams: plain lower().split(), no punctuation
            # normalization (:889-892)
            return text.lower().split()
        return _tokenize(text)

    def update(self, predictions, references):
        for pred, refs in zip(predictions, references):
            if isinstance(refs, str):
                refs = [refs]
            self.preds.append(self._tok(pred))
            self.refs.append([self._tok(r) for r in refs])

    def _tfidf(self, tokens: List[str], n: int, df: Counter, n_docs: int):
        cnt = _ngrams(tokens, n)
        vec = {}
        if self.style == "reference":
            # raw TF; idf = log((N+1)/(df+1)), 0 when the n-gram never
            # appears in any reference set (:913-932)
            for g, c in cnt.items():
                d = df.get(g, 0)
                idf = math.log((n_docs + 1) / (d + 1)) if d > 0 else 0.0
                vec[g] = c * idf
        else:
            total = max(sum(cnt.values()), 1)
            for g, c in cnt.items():
                idf = math.log(max(n_docs, 1)) - math.log(max(df[g], 1))
                vec[g] = (c / total) * idf
        norm = math.sqrt(sum(v * v for v in vec.values()))
        return vec, norm

    def compute(self) -> MetricResult:
        if not self.preds:
            return MetricResult(0.0)
        n_docs = len(self.refs)
        scores = []
        per_n_df = []
        for n in range(1, self.max_n + 1):
            df = Counter()
            for refs in self.refs:
                seen = set()
                for rt in refs:
                    seen |= set(_ngrams(rt, n).keys())
                for g in seen:
                    df[g] += 1
            per_n_df.append(df)
        for pt, refs in zip(self.preds, self.refs):
            score_n = []
            for n in range(1, self.max_n + 1):
                df = per_n_df[n - 1]
                pv, pn = self._tfidf(pt, n, df, n_docs)
                sims = []
                for rt in refs:
                    rv, rn = self._tfidf(rt, n, df, n_docs)
                    if pn == 0 or rn == 0:
                        sims.append(0.0)
                        continue
                    dot = sum(pv[g] * rv.get(g, 0.0) for g in pv)
                    if self.style == "reference":
                        sims.append(dot / (pn * rn))
                    else:
                        # gaussian penalty over length difference
                        delta = len(pt) - len(rt)
                        pen = math.exp(-(delta**2) / (2 * self.sigma**2))
                        sims.append(pen * dot / (pn * rn))
                score_n.append(float(np.mean(sims)) if sims else 0.0)
            scores.append(10.0 * float(np.mean(score_n)))
        return MetricResult(float(np.mean(scores)), per_sample=scores)
