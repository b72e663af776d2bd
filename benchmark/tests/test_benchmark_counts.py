"""The benchmark's counts against numbers already on record for the port.

- The attention bounds of the classification flagship's train step at
  batch 128, at the shapes and masks the port's smoke test timed its
  training kernels on (36 calls: 12 ViT self-attention calls of 50
  tokens with no mask, 12 text calls of 64 tokens under a query-and-key
  padding mask, 4 MCAN encoder calls likewise, 4 MCAN decoder calls of
  49 tokens, 4 MCAN cross calls of 49 queries over 64 keys under a key
  mask; each mask's real length uniform over 1-64 per row), were 0.4269
  ms for the forward with statistics and 0.854-0.8555 ms for the one-pass
  backward on the H100's 3.35 TB/s and 989 TFLOP/s.
- The step's products at 128 were 9.28 TFLOP by the port's analytic
  count (6 x the multiply-adds of the projections, attention, MLPs,
  patch embedding, MCAN, MoE and classifier).
"""

import json
from pathlib import Path

import pytest
import torch

from benchmark import counts, traffic
from benchmark.reference import vqa

ROOT = Path(__file__).resolve().parents[2]
CARD = "NVIDIA H100 80GB HBM3"

# (B, H, Lq, Lk, D, mask kind, calls a step)
FLAGSHIP_STEP_128 = [(128, 12, 50, 50, 64, None, 12),
                     (128, 12, 64, 64, 64, "query_key", 12),
                     (128, 8, 64, 64, 64, "query_key", 4),
                     (128, 8, 49, 49, 64, None, 4),
                     (128, 8, 49, 64, 64, "key", 4)]


def _mask(B, Lq, Lk, kind, gen):
    if kind is None:
        return None
    klen = torch.randint(1, Lk + 1, (B,), generator=gen)
    kv = torch.arange(Lk)[None] < klen[:, None]
    qv = torch.ones(B, Lq, dtype=torch.bool) if kind == "key" \
        else torch.arange(Lq)[None] < klen[:, None]
    return qv[:, None, :, None] & kv[:, None, None, :]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flagship_step_attention_bounds(seed):
    gen = torch.Generator().manual_seed(seed)
    work = {"forward_train": [], "backward": []}
    for B, H, Lq, Lk, D, kind, calls in FLAGSHIP_STEP_128:
        w = counts.train_attention_work((B, H, Lq, D), (B, H, Lk, D),
                                        _mask(B, Lq, Lk, kind, gen), False)
        for name, v in w.items():
            work[name] += [v] * calls
    fwd = counts.bound_seconds(work["forward_train"], CARD) * 1e3
    bwd = counts.bound_seconds(work["backward"], CARD) * 1e3
    # the masks' random lengths move the key rows read by ~0.1%
    assert fwd == pytest.approx(0.4269, rel=3e-3)
    assert 0.8530 <= bwd <= 0.8575


def _flagship():
    return json.loads((ROOT / "benchmark/configs/vivqa-cls-flagship.json")
                      .read_text())["config"]


def test_flagship_step_flops():
    cfg = _flagship()
    t = json.loads((ROOT / "benchmark/traffic/cls-train-b512.json")
                   .read_text())
    t.update(batch=128, ring=1)
    batch = traffic.make_ring(t, cfg, 3, "cpu")[0]
    c = counts.model_counts(vqa, cfg, batch, {"attention_mask"}, True,
                            {"label_smoothing": 0.0})
    # the analytic count leaves out the attention pooling's and the
    # router's products and counts the MoE's combine as none; the plain
    # count takes every product at the padded shapes: 0.37% more
    assert c["flops"] / 1e12 == pytest.approx(9.2813, rel=6e-3)
    assert c["flops"] > 9.2813e12
    assert len(c["attention"]) == 36


def test_bound_for_unknown_card_is_none():
    assert counts.bound_seconds([(1, 1)], "cpu") is None
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
