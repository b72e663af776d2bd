"""Ablation evaluation: metric tables, expert importance, router ranking.

A copy of vivqa_tpu/ablation/evaluator.py on the port's own modules.

Counterpart of src/ablation/ablation_evaluator.py:73-380 in the
reference: per-model-type metric lists, expert importance = baseline
minus leave-one-out delta, router comparison, ranking by primary metric,
deltas vs baseline.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional

from vivqa_tpu_torch.ablation.trainer import ExperimentResult

CLASSIFICATION_METRICS = ("vqa_accuracy", "top5_accuracy", "exact_match",
                          "f1_macro", "val_loss")
GENERATIVE_METRICS = ("bleu", "meteor", "rouge_l", "cider", "exact_match",
                      "token_f1")


def get_metrics_for_model_type(model_type: str):
    return (GENERATIVE_METRICS if model_type == "generative"
            else CLASSIFICATION_METRICS)


def _binom_cdf(k: int, n: int, p: float) -> float:
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(k + 1))


def clopper_pearson(k: int, n: int, alpha: float = 0.05):
    """Exact (Clopper-Pearson) two-sided CI on a binomial proportion,
    by bisection on the binomial CDF (no scipy)."""
    if n == 0:
        return 0.0, 1.0

    def _bisect(f, lo, hi, rising):
        for _ in range(60):
            mid = (lo + hi) / 2
            if (f(mid) > 0) == rising:
                hi = mid
            else:
                lo = mid
        return (lo + hi) / 2

    lower = 0.0 if k == 0 else _bisect(
        lambda p: _binom_cdf(k - 1, n, p) - (1 - alpha / 2), 0.0, 1.0,
        False)
    upper = 1.0 if k == n else _bisect(
        lambda p: _binom_cdf(k, n, p) - alpha / 2, 0.0, 1.0, False)
    return lower, upper


def discordant_delta_ci(b: int, c: int, n: int, alpha: float = 0.05):
    """95% CI on the PAIRED accuracy difference (b - c) / n.

    Conditions on the observed discordant count m = b + c (standard for
    McNemar-style inference): exact CI on b/m, mapped to the delta scale
    by delta = (2*b/m - 1) * m/n. With m = 0 the delta is exactly 0 but
    the discordance RATE is still uncertain — bound it by the exact
    one-sided limit 1 - alpha**(1/n) ("rule of three")."""
    m = b + c
    if n == 0:
        return 0.0, 0.0
    if m == 0:
        bound = 1 - alpha ** (1.0 / n)
        return -bound, bound
    lo, hi = clopper_pearson(b, m, alpha)
    return (2 * lo - 1) * m / n, (2 * hi - 1) * m / n


def mcnemar_exact_p(b: int, c: int) -> float:
    """Two-sided exact McNemar p-value from the discordant-pair counts
    (b = first-only-correct, c = second-only-correct): binomial tail of
    min(b, c) under Bin(b+c, 0.5), doubled and capped at 1."""
    n = b + c
    if n == 0:
        return 1.0
    k = min(b, c)
    tail = sum(math.comb(n, i) for i in range(k + 1)) * 0.5 ** n
    return min(1.0, 2.0 * tail)


@dataclasses.dataclass
class ExpertImportance:
    expert_index: int
    baseline_metric: float
    ablated_metric: float

    @property
    def importance(self) -> float:
        """Positive = removing this expert HURT (it matters)."""
        return self.baseline_metric - self.ablated_metric


class AblationEvaluator:
    def __init__(self, results: List[ExperimentResult],
                 primary_metric: str = "vqa_accuracy",
                 model_type: str = "classification",
                 n_eval: Optional[int] = None):
        self.results = [r for r in results if r.status == "completed"]
        self.primary = primary_metric
        self.model_type = model_type
        self.n_eval = n_eval
        self.by_id = {r.experiment_id: r for r in self.results}

    def baseline(self) -> Optional[ExperimentResult]:
        """The full-expert run under the study's DEFAULT router — not
        just any ``full__`` result. When a router-swap experiment (e.g.
        ``full__soft_...``) is present, load order must not decide which
        run anchors importances and paired tests: prefer the full run
        whose router suffix is the one most experiments share (the
        matrix gives every expert ablation the default router)."""
        fulls = [r for r in self.results
                 if r.experiment_id.startswith("full__")]
        if not fulls:
            return None
        if len(fulls) == 1:
            return fulls[0]
        suffix_counts: Dict[str, int] = {}
        for r in self.results:
            suffix = r.experiment_id.split("__", 1)[-1]
            suffix_counts[suffix] = suffix_counts.get(suffix, 0) + 1
        return max(fulls, key=lambda r: (
            suffix_counts.get(r.experiment_id.split("__", 1)[-1], 0),
            r.experiment_id))

    def metric_table(self) -> List[Dict]:
        metrics = get_metrics_for_model_type(self.model_type)
        rows = []
        for r in self.results:
            row = {"experiment_id": r.experiment_id,
                   "wall_seconds": round(r.wall_seconds, 1)}
            for m in metrics:
                row[m] = r.metrics.get(m)
            rows.append(row)
        return rows

    def ranking(self) -> List[ExperimentResult]:
        """Primary metric descending, with a deterministic tiebreak
        (val_loss ascending, then experiment_id) so exact metric ties
        cannot be broken by result load order."""
        return sorted(
            self.results,
            key=lambda r: (-r.metrics.get(self.primary, 0.0),
                           r.metrics.get("val_loss", float("inf")),
                           r.experiment_id))

    def deltas_from_baseline(self) -> Dict[str, float]:
        base = self.baseline()
        if base is None:
            return {}
        b = base.metrics.get(self.primary, 0.0)
        return {r.experiment_id: r.metrics.get(self.primary, 0.0) - b
                for r in self.results}

    def expert_importance(self) -> List[ExpertImportance]:
        """From leave-one-out runs vs baseline (reference :263-318)."""
        base = self.baseline()
        if base is None:
            return []
        b = base.metrics.get(self.primary, 0.0)
        out = []
        for r in self.results:
            m = re.match(r"leave_one_out_(\d+)__", r.experiment_id)
            if m:
                out.append(ExpertImportance(
                    int(m.group(1)), b, r.metrics.get(self.primary, 0.0)))
        return sorted(out, key=lambda x: -x.importance)

    def paired_comparisons(self) -> List[Dict]:
        """Exact McNemar tests of every experiment against the full
        baseline, for experiments that recorded a per-sample
        ``correct_mask``. Paired tests only count DISCORDANT samples, so
        they separate real effects from noise at val-set sizes where the
        independent binomial bound (``noise_floor``) cannot."""
        base = self.baseline()
        if base is None or not getattr(base, "correct_mask", None):
            return []
        bm = base.correct_mask
        out = []
        for r in self.results:
            cm = getattr(r, "correct_mask", None)
            if r is base or not cm or len(cm) != len(bm):
                continue
            b = sum(1 for x, y in zip(bm, cm) if x and not y)
            c = sum(1 for x, y in zip(bm, cm) if not x and y)
            p = mcnemar_exact_p(b, c)
            lo, hi = discordant_delta_ci(b, c, len(bm))
            out.append({"experiment_id": r.experiment_id,
                        "baseline_only_correct": b,
                        "ablated_only_correct": c,
                        "delta": (sum(bm) - sum(cm)) / len(bm),
                        "delta_ci95": [round(lo, 4), round(hi, 4)],
                        "p_value": p,
                        "significant": p < 0.05})
        return sorted(out, key=lambda d: d["p_value"])

    def noise_floor(self) -> Optional[Dict]:
        """Binomial noise bound on the primary metric.

        Only meaningful for accuracy-like metrics in [0, 1]. ``sigma`` is
        the std of the baseline estimate; ``sigma_diff`` the conservative
        (independent-samples) std of a DIFFERENCE between two runs scored
        on the same val set — paired differences are smaller, so a delta
        exceeding ``ci95_diff`` (1.96·sigma_diff) is strong evidence. The
        val-set size comes from the explicit ``n_eval`` ctor arg, falling
        back to an ``n_eval`` entry any experiment recorded in metrics.
        """
        base = self.baseline()
        if base is None:
            return None
        p = base.metrics.get(self.primary)
        n = self.n_eval or next(
            (r.metrics.get("n_eval") for r in self.results
             if r.metrics.get("n_eval")), None)
        if p is None or not n or not (0.0 <= p <= 1.0):
            return None
        # Laplace-clamp p away from 0/1 so a saturated metric doesn't
        # degenerate the bound to zero (which would call ANY delta
        # significant)
        p = min(max(p, 1.0 / (n + 2)), 1.0 - 1.0 / (n + 2))
        sigma = math.sqrt(p * (1.0 - p) / n)
        sigma_diff = math.sqrt(2.0) * sigma
        return {"n_eval": int(n), "sigma": sigma, "sigma_diff": sigma_diff,
                "ci95_diff": 1.96 * sigma_diff}

    def router_comparison(self) -> List[Dict]:
        """Router ablations on the full-expert baseline (reference :319)."""
        rows = []
        for r in self.results:
            if r.experiment_id.startswith("full__"):
                router_part = r.experiment_id.split("__", 1)[1]
                rows.append({"router": router_part,
                             self.primary: r.metrics.get(self.primary)})
        return sorted(rows, key=lambda x: -(x[self.primary] or 0.0))
