"""The one generator of inputs: a ring of distinct batches, made on the
device from the seed in a few large calls, as a traffic file describes.

A traffic file (``benchmark/traffic/<name>.json``) holds ``batch`` (rows
a call), ``ring`` (distinct batches kept on the device, used in turn),
and ``fields``, each one of these kinds:

- ``normal``: ``field`` of ``shape`` (after the batch axis), normal(0, 1)
  float32 values, as normalised pixels;
- ``class``: ``field`` of integers uniform over ``classes``;
- ``question``: token ids ``ids`` and their ``mask``, ``pad_to``
  positions: BOS, ``length`` - 2 ids uniform over [``first_id``,
  ``vocab``), EOS, then padding, with ``length`` the whole question's
  tokens;
- ``answer``: teacher forcing for ``length`` answer tokens over
  ``pad_to`` positions: ``input`` is BOS and the answer, ``labels`` the
  answer and EOS, ``mask`` the input's real positions; labels past the
  answer are ``ignore``.

Lengths are ``[lo, hi]``: each batch holds the same spread of lengths,
row i of B taking lo + floor(i (hi - lo + 1) / B), in an order drawn
from the seed, so every seed gives the same work in another order. A
number given as ``"@a.b"`` is the configuration's key ``a.b``.
"""

from __future__ import annotations

import torch

from benchmark.reference.layers import fold_in

TRAFFIC_STREAM = 2


def resolve(value, config: dict):
    """``"@a.b"`` -> config["a"]["b"]; lists element-wise; else as is."""
    if isinstance(value, list):
        return [resolve(v, config) for v in value]
    if isinstance(value, str) and value.startswith("@"):
        node = config
        for key in value[1:].split("."):
            node = node[key]
        return node
    return value


def spread(n: int, lo: int, hi: int, gen, device) -> torch.Tensor:
    """(n,) lengths spread evenly over [lo, hi], in a seeded order."""
    base = lo + torch.arange(n, device=device) * (hi - lo + 1) // n
    return base[torch.randperm(n, generator=gen, device=device)]


def _lengths(n: int, batch: int, lo: int, hi: int, gen, device):
    """(n, 1): each batch's rows the same spread, each in its own
    order."""
    return torch.cat([spread(batch, lo, hi, gen, device)
                      for _ in range(n // batch)])[:, None]


def _question(f, n, batch, gen, device) -> dict:
    L, (lo, hi) = f["pad_to"], f["length"]
    if not 3 <= lo <= hi <= L:
        raise ValueError(f"question lengths {lo}-{hi} do not fit {L}")
    length = _lengths(n, batch, lo, hi, gen, device)
    pos = torch.arange(L, device=device)[None]
    ids = torch.randint(f["first_id"], f["vocab"], (n, L), generator=gen,
                        device=device)
    ids = torch.where(pos == 0, f["bos"], ids)
    ids = torch.where(pos == length - 1, f["eos"], ids)
    ids = torch.where(pos >= length, f["pad"], ids)
    return {f["ids"]: ids, f["mask"]: (pos < length).long()}


def _answer(f, n, batch, gen, device) -> dict:
    L, (lo, hi) = f["pad_to"], f["length"]
    if not 1 <= lo <= hi <= L - 1:
        raise ValueError(f"answer lengths {lo}-{hi} do not fit {L}")
    length = _lengths(n, batch, lo, hi, gen, device)
    pos = torch.arange(L, device=device)[None]
    tokens = torch.randint(f["first_id"], f["vocab"], (n, L), generator=gen,
                           device=device)
    # input position t holds answer token t - 1; label t answer token t
    inp = torch.where(pos == 0, f["bos"], tokens.roll(1, dims=1))
    inp = torch.where(pos > length, f["pad"], inp)
    labels = torch.where(pos == length, f["eos"], tokens)
    labels = torch.where(pos > length, f["ignore"], labels)
    return {f["input"]: inp, f["mask"]: (pos <= length).long(),
            f["labels"]: labels}


def make_ring(traffic: dict, config: dict, seed: int, device) -> list:
    """``traffic["ring"]`` batches of ``traffic["batch"]`` rows, each a
    dict of tensors on ``device``."""
    B, R = traffic["batch"], traffic["ring"]
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_in(seed, TRAFFIC_STREAM))
    whole: dict = {}
    for f in traffic["fields"]:
        f = {k: resolve(v, config) for k, v in f.items()}
        kind = f["kind"]
        if kind == "normal":
            whole[f["field"]] = torch.randn((R * B, *f["shape"]),
                                            generator=gen, device=device)
        elif kind == "class":
            whole[f["field"]] = torch.randint(
                0, f["classes"], (R * B,), generator=gen, device=device)
        elif kind == "question":
            whole.update(_question(f, R * B, B, gen, device))
        elif kind == "answer":
            whole.update(_answer(f, R * B, B, gen, device))
        else:
            raise ValueError(f"unknown field kind '{kind}'")
    return [{k: v[r * B:(r + 1) * B] for k, v in whole.items()}
            for r in range(R)]
