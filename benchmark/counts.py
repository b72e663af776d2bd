"""The yardstick's counts: the products of a step, the least bytes and
operations of each attention call, and the card's peaks.

- ``model_counts`` runs the plain reference once on the meta device at
  the cell's batch, with the real padding masks on the host, under
  ``FlopCounterMode``: the products (matrix products and convolutions)
  of the forward, and of the backward for a train step, at the cell's
  shapes; no elementwise work, no optimizer, no recomputation. Each
  attention call's shapes and mask are recorded on the way.
- ``attention_work`` and ``train_attention_work`` are the benchmark's
  frozen copy of the bound arithmetic the port's smoke test used for
  its kernels (each input read once, each output written once, only the
  key rows some query takes, 4 D operations per allowed (query, key)
  pair forward and 10 D backward).
"""

from __future__ import annotations

import torch

from benchmark.reference.layers import Precision

# dense bf16 operations and memory bandwidth by card (NVIDIA's data
# sheets, the rates at the card's full power): a part of the name
# torch.cuda.get_device_name gives -> (flop/s, bytes/s)
PEAKS = (("h100 pcie", 756e12, 2.0e12), ("h100 nvl", 835e12, 3.9e12),
         ("h100 80gb hbm3", 989e12, 3.35e12), ("h100 sxm", 989e12, 3.35e12))


def peaks(card_name: str):
    """(bf16 flop/s, bytes/s) of the card, or None for a card not in the
    table."""
    name = card_name.lower()
    return next(((f, b) for part, f, b in PEAKS if part in name), None)


def attention_work(q_shape, k_shape, mask, causal, elem: int = 2):
    """(bytes, flops, key rows) of a forward call: q and o once; of k and
    v only the key rows that some query of the same (batch, head) takes;
    the mask once as stored; 4 D flops per (query, key) pair that enters
    the softmax. A query row with no allowed key averages all Lk keys."""
    B, H, Lq, D = q_shape
    Lk = k_shape[2]
    allowed = torch.ones(B, 1, Lq, Lk, dtype=torch.bool)
    if causal:
        allowed = allowed & torch.ones(Lq, Lk, dtype=torch.bool).tril(
            Lk - Lq)
    if mask is not None:
        allowed = allowed & mask
    allowed = allowed | ~allowed.any(-1, keepdim=True)
    pairs = int(allowed.sum()) * H
    key_rows = int(allowed.any(2).sum()) * H
    nbytes = (2 * B * H * Lq * D + 2 * key_rows * D) * elem
    if mask is not None:
        nbytes += mask.numel()
    return nbytes, 4 * D * pairs, key_rows


def train_attention_work(q_shape, k_shape, mask, causal,
                         elem: int = 2) -> dict:
    """(bytes, flops) of the training forward (o and the f32 row stats m
    and l) and of the one-pass backward (reads q, o, dO, m, l, the key
    rows of k and v some query takes; writes dq, dk, dv whole)."""
    B, H, Lq, D = q_shape
    Lk = k_shape[2]
    nbytes, flops, key_rows = attention_work(q_shape, k_shape, mask, causal,
                                             elem)
    pairs = flops // (4 * D)
    nq, nk, nk_read = B * H * Lq * D, B * H * Lk * D, key_rows * D
    stats = B * H * Lq * 4
    mask_b = 0 if mask is None else mask.numel()
    bwd = (4 * nq + 2 * nk_read + 2 * nk) * elem + 2 * stats + mask_b
    return {"forward_train": (nbytes + 2 * stats, 4 * D * pairs),
            "backward": (bwd, 10 * D * pairs)}


def bound_seconds(work: list, card_name: str):
    """Sum over calls of max(bytes / bandwidth, flops / peak), or None for
    a card not in the table."""
    p = peaks(card_name)
    if p is None:
        return None
    return sum(max(b / p[1], f / p[0]) for b, f in work)


def model_counts(reference, config: dict, batch: dict, mask_fields: set,
                 train: bool, loss: dict) -> dict:
    """Products of one call of the cell and its attention calls.
    ``batch`` is a batch of the cell (on any device); ``mask_fields``
    the names of its padding masks, which stay on the host. Returns
    {"flops", "attention": [(q shape, k shape, mask, causal), ...]}."""
    with torch.device("meta"):
        model = reference.Model(config, Precision())
    meta = {k: v.cpu() if k in mask_fields else torch.empty_like(
        v, device="meta") for k, v in batch.items()}
    # imported here: it loads triton, which set-up does not need
    from torch.utils.flop_counter import FlopCounterMode
    calls: list = []
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            ce, _ = model.loss_sum(meta, None, calls,
                                   label_smoothing=loss["label_smoothing"])
            ce.backward()
        else:
            with torch.no_grad():
                model.logits(meta, None, calls)
    return {"flops": float(counter.get_total_flops()), "attention": calls}


def attention_bounds(calls: list, train: bool, elem: int = 2) -> dict:
    """{kernel group: [(bytes, flops) per call]}: ``forward_train`` and
    ``backward`` for a train step, ``forward_serve`` for inference."""
    out: dict = {}
    for q, k, mask, causal in calls:
        if train:
            for name, w in train_attention_work(q, k, mask, causal,
                                                elem).items():
                out.setdefault(name, []).append(w)
        else:
            b, f, _ = attention_work(q, k, mask, causal, elem)
            out.setdefault("forward_serve", []).append((b, f))
    return out
