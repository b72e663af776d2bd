"""The numbers that decide ``correct``, each against its limit.

Training (the first steps of the timed step, against the reference's
steps from the same weights, batches and dropout):

- ``loss_gap``: the largest over the steps of |loss - reference loss| /
  |reference loss|;
- ``grad_gap``: the worst parameter's |norm of the program's first
  gradient, as its optimizer holds it after one step - the reference's
  clipped first gradient's norm| over the larger of the reference's norm
  of that parameter and of the median parameter;
- ``change_gap``: the same for each parameter's change over the steps,
  leaving out parameters whose reference gradient is under a thousandth
  of the median parameter's (a key bias under the softmax: its gradient
  is nought but rounding, which Adam's normalisation makes a full-sized
  step).

Inference (sampled answers of the window, against the reference's
logits of the same inputs):

- ``top1_gap``: the largest gap by which the reference's log-probability
  of the program's first answer lies below the reference's best;
- ``top5_logp_gap``: the largest |log p - reference log p| over the
  program's five answers;
- ``missing``: sampled rows that got no answer.
"""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3


def _gap(prog: dict, ref: dict, names) -> float:
    scale = statistics.median(ref.values())
    return max(abs(prog[n] - ref[n]) / max(ref[n], scale, 1e-30)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "first_grad": {name: norm},
    "change": {name: norm}}."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    grads = ref["first_grad"]
    floor = EXCLUDE_BELOW * statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= floor]
    return {"loss_gap": loss_gap,
            "grad_gap": _gap(prog["first_grad"], grads, grads),
            "change_gap": _gap(prog["change"], ref["change"], moved)}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> dict:
    """The ``n`` parameters with the widest gaps of each norm (of the
    change, among those ``change_gap`` compares), for the log."""
    grads = ref["first_grad"]
    floor = EXCLUDE_BELOW * statistics.median(grads.values())
    out = {}
    for key in ("first_grad", "change"):
        scale = statistics.median(ref[key].values())
        gaps = sorted(((abs(prog[key][k] - v) / max(v, scale, 1e-30), k)
                       for k, v in ref[key].items()
                       if key == "first_grad" or grads[k] >= floor),
                      reverse=True)[:n]
        out[key] = [(k, round(g, 5)) for g, k in gaps]
    return out


def infer_numbers(rows: list) -> dict:
    """``rows``: (program ids (5,), program probs (5,), reference
    log-probabilities (A,)) of each sampled row, or None for a row that
    got no answer."""
    top1 = logp = 0.0
    missing = 0
    for row in rows:
        if row is None:
            missing += 1
            continue
        ids, probs, ref = row
        top1 = max(top1, float(ref.max() - ref[int(ids[0])]))
        for i, p in zip(ids, probs):
            got = math.log(float(p)) if p > 0 else -math.inf
            logp = max(logp, abs(got - float(ref[int(i)])))
    return {"top1_gap": top1, "top5_logp_gap": logp, "missing": missing}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number at or under its
    limit, and finite."""
    check = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[n] for n, v in numbers.items())
    return ok, check
