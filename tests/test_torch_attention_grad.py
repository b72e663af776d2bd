"""The attention gradient of the port against the JAX package, on the CPU.

``attention_forward_lse_reference`` and ``attention_backward_reference``
(the plain versions of the three training kernels) are held against the
Pallas ``_flash_forward_lse`` + ``_flash_backward`` in interpret mode and
against ``jax.vjp`` of ``_xla_attention``, with masks, ragged lengths and
fully masked rows; ``FlashAttention`` (the autograd Function) against
plain autograd through ``attention_reference`` and ``gradcheck``; and the
attention dropout against its statistics. The CUDA kernels themselves run
only on the card (tests/test_torch_gpu.py).
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import assert_close, padding_mask
from vivqa_tpu.ops.flash_attention import _xla_attention
from vivqa_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# f32 on both sides; the tolerance covers different summation orders
# over up to 256 keys of values of size ~1
GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _arrays(B, H, Lq, Lk, D, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(s).astype(np.float32) for s in (
        (B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D), (B, H, Lq, D)))


def _mask(kind, B, Lq, Lk, seed=1):
    """(B, 1, Lq, Lk) bool numpy mask, or None; "query_key" pads queries
    too, so some rows are fully masked."""
    if kind is None:
        return None
    rs = np.random.RandomState(seed)
    k_valid = padding_mask(rs.randint(1, Lk + 1, B), Lk)
    q_valid = np.ones((B, Lq), np.int32)
    if kind == "query_key":
        q_valid = padding_mask(rs.randint(1, Lq + 1, B), Lq)
        q_valid[0, -1] = 0
    return (q_valid[:, None, :, None] * k_valid[:, None, None, :]) != 0


def _port_grads(q, k, v, g, mask, causal, rate=0.0, key=0, dtype=None):
    """Output and (dq, dk, dv) through FlashAttention on the CPU."""
    ts = [torch.from_numpy(a).to(dtype or torch.float32).requires_grad_(True)
          for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = fa.flash_attention(*ts, tm, causal, dropout_rate=rate,
                             dropout_key=key)
    out.backward(torch.from_numpy(g).to(out.dtype))
    return out, [t.grad for t in ts]


VJP_CASES = [
    dict(Lq=49, Lk=49, causal=False, mask=None),       # MCAN decoder
    dict(Lq=50, Lk=50, causal=False, mask=None),       # ViT
    dict(Lq=64, Lk=64, causal=False, mask="query_key"),  # text, MCAN enc
    dict(Lq=49, Lk=64, causal=False, mask="key"),      # MCAN cross
    dict(Lq=8, Lk=8, causal=True, mask=None),
    dict(Lq=5, Lk=9, causal=True, mask=None),          # Lq < Lk
    dict(Lq=40, Lk=9, causal=True, mask=None),         # Lq > Lk
    dict(Lq=8, Lk=8, causal=True, mask="query_key"),
]


@pytest.mark.parametrize("case", VJP_CASES, ids=str)
def test_gradient_matches_jax_vjp_of_xla_attention(case):
    """The Function's backward (plain versions on the CPU) against
    jax.vjp through jnp.where(mask, logits, -1e30): a fully masked row
    still feeds dV its 1/Lk share, and dS is 0 at every masked entry."""
    Lq, Lk, causal = case["Lq"], case["Lk"], case["causal"]
    q, k, v, g = _arrays(2, 2, Lq, Lk, 16)
    mask = _mask(case["mask"], 2, Lq, Lk)
    out, vjp = jax.vjp(
        lambda q, k, v: _xla_attention(
            q, k, v, None if mask is None else jnp.asarray(mask), causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got_out, got = _port_grads(q, k, v, g, mask, causal)
    assert_close(got_out, out, **GRAD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a.numpy()).all(), name
        assert_close(a, b, msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", [dict(B=1, H=2, Lq=128, Lk=128, causal=False),
                                  dict(B=1, H=1, Lq=128, Lk=256, causal=True)],
                         ids=str)
def test_plain_versions_match_pallas_interpret(case):
    """o, m, l of the plain forward against ``_flash_forward_lse``, and
    dq, dk, dv of the plain backward against ``_flash_backward``, both in
    Pallas interpret mode, the backward fed the same o, m, l."""
    jfa = importlib.import_module("vivqa_tpu.ops.flash_attention")
    B, H, Lq, Lk, causal = (case[n] for n in ("B", "H", "Lq", "Lk",
                                              "causal"))
    q, k, v, g = _arrays(B, H, Lq, Lk, 64, seed=2)
    bq, bk = jfa._pick_blocks(Lq, Lk)
    jfa._INTERPRET = True
    try:
        o, m, l = jfa._flash_forward_lse(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal, bq, bk)
        want = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), o, m, l, jnp.asarray(g),
                                   causal, bq, bk)
    finally:
        jfa._INTERPRET = False
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    po, pm, pl = fa.attention_forward_lse_reference(tq, tk, tv,
                                                    causal=causal)
    assert_close(po, o, **GRAD_TOL)
    assert_close(pm, m, **GRAD_TOL)
    assert_close(pl, l, atol=1e-4, rtol=2e-5)     # sums of up to 256 exps
    got = fa.attention_backward_reference(
        tq, tk, tv, torch.from_numpy(np.asarray(o)),
        torch.from_numpy(np.asarray(m)), torch.from_numpy(np.asarray(l)), tg,
        causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, msg=name, **GRAD_TOL)


def test_pallas_backward_skips_rows_without_keys():
    """Reference fault (ROADMAP.md, Queue C): with causal and Lq - Lk >=
    block_q the Pallas dK/dV kernel's ``lower`` bound skips whole query
    blocks whose rows have no key, so their 1/Lk share of dV is lost.
    Fed the correct o, m, l, it departs from jax.vjp of _xla_attention;
    the port's plain backward does not."""
    jfa = importlib.import_module("vivqa_tpu.ops.flash_attention")
    Lq, Lk = 384, 128                 # blocks 128 x 128, q_offset -256
    q, k, v, g = _arrays(1, 1, Lq, Lk, 64, seed=3)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, m, l = fa.attention_forward_lse_reference(tq, tk, tv, causal=True)
    _, vjp = jax.vjp(lambda q, k, v: _xla_attention(q, k, v, causal=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_dv = np.asarray(vjp(jnp.asarray(g))[2])
    jfa._INTERPRET = True
    try:
        pallas_dv = np.asarray(jfa._flash_backward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(o.numpy()), jnp.asarray(m.numpy()),
            jnp.asarray(l.numpy()), jnp.asarray(g), True, 128, 128)[2])
    finally:
        jfa._INTERPRET = False
    port_dv = fa.attention_backward_reference(tq, tk, tv, o, m, l, tg,
                                              causal=True)[2]
    assert_close(port_dv, want_dv, **GRAD_TOL)
    # the lost share: rows 0-255 have no key, each gives dO/Lk to every key
    lost = g[0, 0, :256].sum(axis=0) / Lk
    np.testing.assert_allclose((want_dv - pallas_dv)[0, 0],
                               np.broadcast_to(lost, (Lk, 64)), atol=1e-4)


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("mask_kind", [None, "query_key"])
def test_function_matches_autograd_through_plain_forward(rate, mask_kind):
    """FlashAttention on the CPU (plain forward with stats, plain Pallas-
    style backward) against torch autograd through attention_reference,
    with the same dropout mask in both."""
    q, k, v, g = _arrays(2, 3, 12, 10, 16, seed=4)
    mask = _mask(mask_kind, 2, 12, 10)
    key = fa.dropout_key(11, 3)
    out, got = _port_grads(q, k, v, g, mask, False, rate, key)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    ref = fa.attention_reference(*ts, None if mask is None
                                 else torch.from_numpy(mask), False, rate,
                                 key)
    ref.backward(torch.from_numpy(g))
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    for a, t in zip(got, ts):
        torch.testing.assert_close(a, t.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_float64_with_dropout(causal):
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 2, L, 8, generator=gen, dtype=torch.float64,
                           requires_grad=True) for L in (7, 5, 5))
    mask = (torch.rand(1, 1, 7, 5, generator=gen) > 0.3)
    mask[..., 0, :] = False                         # a fully masked row
    key = fa.dropout_key(2026, 1)

    def f(q, k, v):
        return fa.FlashAttention.apply(q, k, v, mask, causal, 0.3, key)[0]
    assert torch.autograd.gradcheck(f, (q, k, v))


def test_no_grad_forward_takes_the_plain_forward():
    """Without a gradient and without dropout the PR's serving path is
    unchanged: attention_reference on the CPU, bit for bit."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 2, 6, 9, 64, 6))
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(True), k, v)
    torch.testing.assert_close(out, fa.attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert out.grad_fn is None


def test_dropout_keep_mask_statistics():
    """The keep fraction is within 5 binomial standard deviations of
    1 - rate; the bits differ between keys; the Python and torch hashes
    agree."""
    Lq, Lk = 256, 256
    for rate in (0.1, 0.5):
        keep = fa.dropout_keep_mask(Lq, Lk, rate, fa.dropout_key(3, 0))
        n = Lq * Lk
        sd = np.sqrt(rate * (1 - rate) / n)
        assert abs(float(keep.float().mean()) - (1 - rate)) < 5 * sd
        # rows and columns are not copies of one another
        keep = keep.float()
        assert keep.mean(0).std() > 0 and keep.mean(1).std() > 0
    a = fa.dropout_keep_mask(64, 64, 0.1, fa.dropout_key(3, 0))
    b = fa.dropout_keep_mask(64, 64, 0.1, fa.dropout_key(3, 1))
    c = fa.dropout_keep_mask(64, 64, 0.1, fa.dropout_key(4, 0))
    assert not torch.equal(a, b) and not torch.equal(a, c)
    x = torch.arange(0, 2 ** 32, 2 ** 20 + 7, dtype=torch.int64)
    assert [int(h) for h in fa._mix32_t(x)] == [fa._mix32(int(i)) for i in x]
    assert fa.dropout_threshold(0.1) == 429496729


def test_dropout_mask_is_shared_by_batch_and_heads():
    """q = k = 0 gives p = 1/Lk; v = the identity then shows the kept keys
    in o: the same (Lq, Lk) mask for every batch row and head (flax's
    broadcast_dropout), scaled by 1 / (1 - rate)."""
    B, H, Lq, Lk, rate = 3, 2, 10, 16, 0.25
    q = torch.zeros(B, H, Lq, Lk)
    v = torch.eye(Lk).expand(B, H, Lk, Lk)
    key = fa.dropout_key(8, 2)
    o = fa.flash_attention(q, torch.zeros(B, H, Lk, Lk), v,
                           dropout_rate=rate, dropout_key=key)
    want = fa.dropout_keep_mask(Lq, Lk, rate, key)
    assert torch.equal(o > 0, want.expand(B, H, Lq, Lk))
    torch.testing.assert_close(o, (want / (Lk * (1 - rate))).expand(
        B, H, Lq, Lk))


def test_dropout_forward_and_backward_share_the_mask():
    """The same key gives the same mask in the forward and the backward:
    with dO = 1 and v = the identity, dV[j] sums p z over the rows, so a
    key dropped in every row gets no gradient; and the Function's dV
    equals autograd's through the plain forward with that mask."""
    Lq, Lk, rate = 4, 16, 0.5
    key = fa.dropout_key(1, 9)
    q = torch.zeros(1, 1, Lq, Lk, requires_grad=True)
    v = torch.eye(Lk)[None, None].requires_grad_(True)
    out = fa.flash_attention(q, torch.zeros(1, 1, Lk, Lk), v,
                             dropout_rate=rate, dropout_key=key)
    out.backward(torch.ones_like(out))
    keep = fa.dropout_keep_mask(Lq, Lk, rate, key).float()
    want_dv = keep.sum(0)[:, None] / (Lk * (1 - rate))    # rows of dV
    torch.testing.assert_close(v.grad[0, 0], want_dv.expand(Lk, Lk))


# -- the tensor-core kernels' rounding ---------------------------------------
# In bf16 and f16 the card's forwards (serving and training) round p z
# (p = exp(s - m), before the division by l; z = 1 when serving) to the
# input dtype as the operand of P.V, the dQ kernel rounds dS to it before
# dS.K, and the dK/dV kernel rounds p z and dS to it before (p z)^T dO and
# dS^T Q; the plain versions round the normalised probabilities and keep
# p z and dS in f32. These emulate the kernels' rounding on the CPU (with
# the row's final max, which is the kernels' own at L <= 64), so the
# card's tolerances (chip_smoke.py ATTN_TOL and GRAD_TOL, relative to each
# tensor's largest value) are grounded here.
ATTN_TOL_BF16, GRAD_TOL_BF16 = 2e-2, 1e-2

ROUNDING_CASES = [  # (H, Lq, Lk, mask kind): the flagship's five shapes
    (12, 50, 50, None),
    (12, 64, 64, "query_key"),
    (8, 64, 64, "query_key"),
    (8, 49, 49, None),
    (8, 49, 64, "key"),
    (8, 113, 113, "key"),
]


def _kernel_rounded_forward(q, k, v, mask, rate, key):
    logits = fa._masked_logits(q, k, mask, False)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    if rate:
        e = e * fa.dropout_multiplier(q.shape[2], k.shape[2], rate, key,
                                      e.dtype)
    pv = torch.einsum("bhqk,bhkd->bhqd", e.to(v.dtype).float(), v.float())
    return (pv / l).to(v.dtype)


def _kernel_rounded_dq(q, k, v, o, m, l, do, mask, rate, key):
    p, allowed = fa._bwd_probs(q, k, m, l, mask, False)
    delta = (do.float() * o.float()).sum(-1)
    ds = fa._bwd_ds(p, allowed, v, do, delta,
                    fa._bwd_z(q, k, rate, key, torch.float32))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(), k.float())
    return (dq / math.sqrt(q.shape[-1])).to(q.dtype)


def _kernel_rounded_dkv(q, k, v, m, l, do, delta, mask, rate, key):
    p, allowed = fa._bwd_probs(q, k, m, l, mask, False)
    z = fa._bwd_z(q, k, rate, key, torch.float32)
    pz = p if z is None else p * z
    dv = torch.einsum("bhqk,bhqd->bhkd", pz.to(v.dtype).float(), do.float())
    ds = fa._bwd_ds(p, allowed, v, do, delta, z)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    return (dk / math.sqrt(q.shape[-1])).to(k.dtype), dv.to(v.dtype)


def _rounding_inputs(case, rate):
    H, Lq, Lk, kind = case
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _arrays(2, H, Lq, Lk, 64, seed=7))
    mask = _mask(kind, 2, Lq, Lk)
    mask = None if mask is None else torch.from_numpy(mask)
    return q, k, v, g, mask, fa.dropout_key(7, 1)


def _rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", ROUNDING_CASES, ids=str)
def test_kernel_rounding_within_card_tolerances(case, rate):
    """bf16 inputs from a numpy seed, batch 2: the training forward's o
    with P rounded to bf16, the serving forward's o (no dropout) with P
    rounded to bf16, and dq with dS rounded to bf16, against the
    f32-internal plain versions, within the card's bf16 tolerances."""
    q, k, v, g, mask, key = _rounding_inputs(case, rate)
    o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, False, rate,
                                                 key)
    o_err = _rel_err(_kernel_rounded_forward(q, k, v, mask, rate, key), o)
    serve_err = _rel_err(_kernel_rounded_forward(q, k, v, mask, 0.0, key),
                         fa.attention_reference(q, k, v, mask))
    dq, _ = fa.attention_bwd_dq_reference(q, k, v, o, m, l, g, mask, False,
                                          rate, key)
    dq_err = _rel_err(
        _kernel_rounded_dq(q, k, v, o, m, l, g, mask, rate, key), dq)
    assert o_err <= ATTN_TOL_BF16, o_err
    assert serve_err <= ATTN_TOL_BF16, serve_err
    assert dq_err <= GRAD_TOL_BF16, dq_err


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", ROUNDING_CASES, ids=str)
def test_dkv_kernel_rounding_within_card_tolerances(case, rate):
    """The same inputs: dk and dv with p z and dS rounded to bf16 before
    the two products (f32 sums, each output rounded once), against the
    f32-internal plain version fed the same m, l and delta, within the
    card's bf16 gradient tolerance; a fully masked row (query_key cases)
    still feeds dv its 1/Lk share in both."""
    q, k, v, g, mask, key = _rounding_inputs(case, rate)
    o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, False, rate,
                                                 key)
    _, delta = fa.attention_bwd_dq_reference(q, k, v, o, m, l, g, mask,
                                             False, rate, key)
    dk, dv = fa.attention_bwd_dkv_reference(q, k, v, m, l, g, delta, mask,
                                            False, rate, key)
    got_dk, got_dv = _kernel_rounded_dkv(q, k, v, m, l, g, delta, mask, rate,
                                         key)
    assert got_dk.dtype == dk.dtype and got_dv.dtype == dv.dtype
    dk_err, dv_err = _rel_err(got_dk, dk), _rel_err(got_dv, dv)
    assert dk_err <= GRAD_TOL_BF16, dk_err
    assert dv_err <= GRAD_TOL_BF16, dv_err


# -- the one-pass backward's schedule ----------------------------------------
# The card's bf16/f16 backward (csrc/flash_attn_bwd.cu) computes s, p, dP
# and dS once per (query, key) pair, rounds p z and dS to the input dtype
# once as the operands of dV, dK and dQ (the same rounded dS for both), sums
# dQ over each 64-key tile in f32 and adds the tiles' partials in key-tile
# order (in registers when Lq, Lk <= 128; through an f32 scratch and a sum
# kernel in the long form), and rounds each output once. This is that
# schedule on the CPU; with operand_dtype None it is the plain version of
# the same schedule, all in f32.
def _one_pass_schedule(q, k, v, o, m, l, do, mask=None, causal=False,
                       rate=0.0, key=0, operand_dtype=None):
    acc = torch.float32
    p, allowed = fa._bwd_probs(q, k, m, l, mask, causal)
    delta = (do.to(acc) * o.to(acc)).sum(-1)
    z = fa._bwd_z(q, k, rate, key, acc)
    ds = fa._bwd_ds(p, allowed, v, do, delta, z)
    pz = p if z is None else p * z
    if operand_dtype is not None:
        pz, ds = pz.to(operand_dtype).to(acc), ds.to(operand_dtype).to(acc)
    scale = 1.0 / math.sqrt(q.shape[-1])
    dv = torch.einsum("bhqk,bhqd->bhkd", pz, do.to(acc))
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(acc)) * scale
    dq = torch.zeros(q.shape, dtype=acc)
    for k0 in range(0, k.shape[2], fa.BWD_KEY_TILE):
        tile = slice(k0, k0 + fa.BWD_KEY_TILE)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds[..., tile],
                               k[:, :, tile].to(acc))
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# (H, Lq, Lk, mask kind, causal): the flagship's five shapes and the
# generative fusion's 113 (ROUNDING_CASES), a long-key call (4 key tiles,
# the long form) and a causal one
ONE_PASS_CASES = [(*c, False) for c in ROUNDING_CASES] + [
    (2, 32, 200, None, False),
    (2, 64, 64, None, True),
]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", ONE_PASS_CASES, ids=str)
def test_one_pass_rounding_within_card_tolerance(case, rate):
    """bf16 inputs from a numpy seed, batch 2: the one-pass schedule with
    p z and dS rounded to bf16 (dS once, for dK and dQ), dQ's per-key-tile
    f32 partials summed in key-tile order and each output rounded once,
    against the f32-internal plain version fed the same o, m and l,
    within the card's bf16 gradient tolerance."""
    H, Lq, Lk, kind, causal = case
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _arrays(2, H, Lq, Lk, 64, seed=8))
    mask = _mask(kind, 2, Lq, Lk)
    mask = None if mask is None else torch.from_numpy(mask)
    key = fa.dropout_key(8, 1)
    o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, causal, rate,
                                                 key)
    want = fa.attention_backward_reference(q, k, v, o, m, l, g, mask, causal,
                                           rate, key)
    got = _one_pass_schedule(q, k, v, o, m, l, g, mask, causal, rate, key,
                             torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == torch.bfloat16, name
        err = _rel_err(a, b)
        assert err <= GRAD_TOL_BF16, (name, err)


# (B, H, Lq, Lk, mask kind, causal) at head dim 32: the one-pass form,
# with keyless rows and causal both ways, and the long form (Lk or Lq over
# ONE_PASS_MAX; the causal one skips leading query tiles of late key
# tiles)
SCHEDULE_CASES = [
    (2, 2, 49, 64, "key", False),
    (2, 2, 64, 64, "query_key", False),
    (2, 2, 40, 9, None, True),
    (1, 2, 32, 200, None, False),
    (1, 2, 150, 150, None, True),
    (2, 2, 130, 70, "query_key", False),
]


@pytest.fixture(scope="module")
def schedule_vjps():
    """jax.vjp of _xla_attention for each SCHEDULE_CASES row, f32, one
    jitted function a case (the cases' shapes differ)."""
    out = {}
    for case in SCHEDULE_CASES:
        B, H, Lq, Lk, kind, causal = case
        q, k, v, g = _arrays(B, H, Lq, Lk, 32, seed=9)
        mask = _mask(kind, B, Lq, Lk)

        @jax.jit
        def grads(q, k, v, g, mask=None if mask is None
                  else jnp.asarray(mask), causal=causal):
            _, vjp = jax.vjp(lambda q, k, v: _xla_attention(
                q, k, v, mask, causal), q, k, v)
            return vjp(g)
        want = grads(*(jnp.asarray(a) for a in (q, k, v, g)))
        out[case] = ((q, k, v, g, mask), [np.asarray(w) for w in want])
    return out


@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=str)
def test_one_pass_schedule_matches_jax_vjp(case, schedule_vjps):
    """The one-pass schedule in f32 (dQ summed over 64-key tiles in key-
    tile order) against jax.vjp of _xla_attention: a fully masked row
    feeds dV its 1/Lk share, dS is 0 at every masked entry."""
    B, H, Lq, Lk, kind, causal = case
    (q, k, v, g, mask), want = schedule_vjps[case]
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    tm = None if mask is None else torch.from_numpy(mask)
    o, m, l = fa.attention_forward_lse_reference(tq, tk, tv, tm, causal)
    got = _one_pass_schedule(tq, tk, tv, o, m, l, tg, tm, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.isfinite(a.numpy()).all(), name
        assert_close(a, b, msg=name, **GRAD_TOL)


@pytest.fixture(scope="module")
def pallas_backward():
    """JAX's _flash_backward in Pallas interpret mode, f32, at one
    one-pass and one long-form shape, fed its own forward's o, m, l."""
    jfa = importlib.import_module("vivqa_tpu.ops.flash_attention")
    out = {}
    jfa._INTERPRET = True
    try:
        for B, H, Lq, Lk, causal in ((1, 2, 128, 128, False),
                                     (1, 1, 128, 256, True)):
            q, k, v, g = _arrays(B, H, Lq, Lk, 64, seed=10)
            bq, bk = jfa._pick_blocks(Lq, Lk)
            jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
            o, m, l = jfa._flash_forward_lse(jq, jk, jv, causal, bq, bk)
            want = jfa._flash_backward(jq, jk, jv, o, m, l, jnp.asarray(g),
                                       causal, bq, bk)
            out[(Lq, Lk, causal)] = (
                (q, k, v, g), [np.array(a) for a in (o, m, l)],
                [np.array(w) for w in want])
    finally:
        jfa._INTERPRET = False
    return out


@pytest.mark.parametrize("shape", [(128, 128, False), (128, 256, True)],
                         ids=str)
def test_one_pass_schedule_matches_pallas_backward(shape, pallas_backward):
    """The one-pass schedule in f32 against JAX's _flash_backward (the two
    Pallas kernels, interpret mode), both fed the Pallas forward's o, m
    and l: at 128 x 128 the one-pass form's two key tiles, at 128 x 256
    the long form's four."""
    (q, k, v, g), (o, m, l), want = pallas_backward[shape]
    causal = shape[2]
    got = _one_pass_schedule(*(torch.from_numpy(a) for a in (q, k, v, o, m,
                                                             l, g)),
                             causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert_close(a, b, msg=name, **GRAD_TOL)


@pytest.mark.parametrize("shape, want", [
    ((128, 12, 50, 50, 64), ("one_pass", 1, 1536, 1, None)),
    ((128, 8, 49, 64, 64), ("one_pass", 1, 1024, 1, None)),
    ((32, 8, 113, 113, 64), ("one_pass", 1, 256, 2, None)),
    ((32, 8, 32, 118, 64), ("one_pass", 1, 256, 2, None)),
    ((128, 8, 1, 5, 64), ("one_pass", 1, 1024, 1, None)),
    ((2, 2, 128, 128, 32), ("one_pass", 1, 4, 2, None)),
    ((8, 4, 32, 784, 64), ("long", 2, 416, 1, (13, 8, 4, 32, 64))),
    ((2, 8, 1024, 1024, 64), ("long", 2, 256, 1, (16, 2, 8, 1024, 64))),
    ((2, 2, 129, 64, 128), ("long", 2, 4, 1, (1, 2, 2, 129, 128))),
], ids=str)
def test_backward_plan_by_shape(shape, want):
    """Which form a call takes, its launches, its units, the 64-key tiles
    a unit's warpgroups take and the long form's f32 dQ scratch: Lq and
    Lk at most 128 take one launch, a unit per (b, h); anything longer
    two, a unit per (b, h, 64-key tile), the second summing its f32 dQ
    partials."""
    plan = fa.backward_plan(*shape)
    assert (plan["form"], plan["launches"], plan["units"], plan["key_tiles"],
            plan["scratch"]) == want


# the flagship step's attention calls at batch 128 (bench.py:53-64):
# (H, Lq, Lk, stored mask shape, calls a step)
FLAGSHIP_CALLS = [
    (12, 50, 50, None, 12),
    (12, 64, 64, (128, 1, 64, 64), 12),
    (8, 64, 64, (128, 1, 64, 64), 4),
    (8, 49, 49, None, 4),
    (8, 49, 64, (128, 1, 1, 64), 4),
]


@pytest.mark.parametrize("call", FLAGSHIP_CALLS, ids=str)
def test_backward_bound_matches_hand_count(call):
    """chip_smoke.train_attention_work's bytes and flops of the one-pass
    backward against a hand count (masks that keep every key, so every
    pair and key row is taken): q, o, dO and dq, k and v read, dk and dv
    written, m and l, the mask as stored; 10 D flops a pair."""
    import chip_smoke
    H, Lq, Lk, mask_shape, _ = call
    B, D, e = 128, 64, 2
    q = torch.empty(B, H, Lq, D, dtype=torch.bfloat16)
    k = torch.empty(B, H, Lk, D, dtype=torch.bfloat16)
    mask = None if mask_shape is None else torch.ones(mask_shape,
                                                      dtype=torch.bool)
    got = chip_smoke.train_attention_work(q, k, mask, False)["flash_attn_bwd"]
    rows_q, rows_k = B * H * Lq, B * H * Lk
    want_bytes = (4 * rows_q * D * e + 4 * rows_k * D * e + 2 * rows_q * 4
                  + (0 if mask is None else mask.numel()))
    assert got == (want_bytes, 10 * D * B * H * Lq * Lk)


def test_backward_bound_of_the_flagship_step():
    """The five shapes' bounds over the step's 36 calls at 3.35 TB/s:
    0.864 ms, the bytes binding (0.104 ms of 10 D flops a pair at the
    tensor cores' peak); the long form's bound counts the same bytes, its
    f32 dQ partials (written and read once) a separate overhead."""
    import chip_smoke
    total_bytes, total_flops = 0, 0
    for H, Lq, Lk, mask_shape, calls in FLAGSHIP_CALLS:
        q = torch.empty(128, H, Lq, 64, dtype=torch.bfloat16)
        k = torch.empty(128, H, Lk, 64, dtype=torch.bfloat16)
        mask = None if mask_shape is None else torch.ones(mask_shape,
                                                          dtype=torch.bool)
        nbytes, flops = chip_smoke.train_attention_work(
            q, k, mask, False)["flash_attn_bwd"]
        total_bytes += calls * nbytes
        total_flops += calls * flops
    bytes_ms = total_bytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    flops_ms = total_flops / chip_smoke.PEAK_FLOPS[torch.bfloat16] * 1e3
    assert abs(bytes_ms - 0.864) < 5e-4 and flops_ms < bytes_ms / 5
    q = torch.empty(8, 4, 32, 64, dtype=torch.bfloat16)
    k = torch.empty(8, 4, 784, 64, dtype=torch.bfloat16)
    nbytes, _ = chip_smoke.train_attention_work(q, k, None, False)[
        "flash_attn_bwd"]
    one_pass_rule = (4 * q.numel() + 4 * k.numel()) * 2 + 2 * 8 * 4 * 32 * 4
    assert nbytes == one_pass_rule
    assert chip_smoke.bwd_scratch_bytes(q, k) == 2 * 13 * 8 * 4 * 32 * 64 * 4
    assert chip_smoke.bwd_scratch_bytes(q[:, :, :, :], q) == 0


# -- the forward's schedule ----------------------------------------------------
# The card's bf16/f16 forward (csrc/flash_attn_fwd.cu), in its tile and
# long forms, walks each (b, h, 64-query tile)'s keys in tiles of
# forward_plan's key_tile with an online softmax: the running max m (from
# -1e30) is raised tile by tile, the earlier sums are rescaled by
# exp(m_old - m_new), p = exp(s - m) times the dropout multiplier is rounded
# to the input dtype per tile as the operand of P V, every sum is f32, and
# l sums p before dropout. Where the plan splits the keys, each split's
# (o, m, l) is an f32 partial, merged in split order. This is that schedule
# on the CPU; with operand_dtype None the plain version of the same
# schedule, all in f32.
def _forward_schedule(q, k, v, mask=None, causal=False, rate=0.0, key=0,
                      key_tile=64, splits=1, operand_dtype=None):
    acc = torch.float32
    s = fa._masked_logits(q, k, mask, causal).to(acc)
    z = fa._bwd_z(q, k, rate, key, acc)
    n_kt = -(-k.shape[2] // key_tile)
    per_split = -(-n_kt // splits)
    parts = []
    for sp in range(splits):
        m = torch.full(s.shape[:3], fa.NEG_INF, dtype=acc)
        l = torch.zeros(s.shape[:3], dtype=acc)
        o = torch.zeros(q.shape, dtype=acc)
        for kt in range(sp * per_split, min(n_kt, (sp + 1) * per_split)):
            cols = slice(kt * key_tile, (kt + 1) * key_tile)
            m_new = torch.maximum(m, s[..., cols].amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s[..., cols] - m_new[..., None])
            l = alpha * l + p.sum(-1)
            if z is not None:
                p = p * z[:, cols]
            if operand_dtype is not None:
                p = p.to(operand_dtype).to(acc)
            o = alpha[..., None] * o + torch.einsum(
                "bhqk,bhkd->bhqd", p, v[:, :, cols].to(acc))
            m = m_new
        parts.append((o, m, l))
    m = torch.stack([pm for _, pm, _ in parts]).amax(0)
    o, l = torch.zeros(q.shape, dtype=acc), torch.zeros(m.shape, dtype=acc)
    for po, pm, pl in parts:     # in split order
        w = torch.exp(pm - m)
        o, l = o + w[..., None] * po, l + w * pl
    l = l.clamp_min(1e-30)
    return (o / l[..., None]).to(q.dtype), m, l


def _planned(B, H, Lq, Lk, D):
    plan = fa.forward_plan(B, H, Lq, Lk, D)
    return plan["key_tile"], plan["splits"]


def _stat_err(got, want) -> float:
    """chip_smoke.py's m and l error: |got - want| / (1 + |want|)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


# (H, Lq, Lk, mask kind, causal) at batch 2, head dim 64: the flagship's
# five shapes and the generative fusion's 113 (the tile form), 80 queries
# over one 32-key tile, then the long form: 32 queries over 300 keys in 5
# splits, a causal 150 x 150 in 2 splits of 128-key tiles, and keyless
# rows over 5 splits
FORWARD_ROUNDING_CASES = [(*c, False) for c in ROUNDING_CASES] + [
    (2, 80, 32, "query_key", False),
    (2, 32, 300, None, False),
    (2, 150, 150, None, True),
    (2, 40, 300, "query_key", False),
]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", FORWARD_ROUNDING_CASES, ids=str)
def test_forward_rounding_within_card_tolerance(case, rate):
    """bf16 inputs from a numpy seed: the forward's schedule with p z
    rounded to bf16 per key tile, the running max across tiles and the
    split partials merged in f32, against the f32-internal plain version:
    o within the card's bf16 tolerance, m and l within STAT_TOL."""
    import chip_smoke
    H, Lq, Lk, kind, causal = case
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _arrays(2, H, Lq, Lk, 64, seed=12))
    mask = _mask(kind, 2, Lq, Lk)
    mask = None if mask is None else torch.from_numpy(mask)
    key = fa.dropout_key(12, 1)
    key_tile, splits = _planned(2, H, Lq, Lk, 64)
    o, m, l = _forward_schedule(q, k, v, mask, causal, rate, key, key_tile,
                                splits, torch.bfloat16)
    want_o, want_m, want_l = fa.attention_forward_lse_reference(
        q, k, v, mask, causal, rate, key)
    assert o.dtype == torch.bfloat16
    assert _rel_err(o, want_o) <= ATTN_TOL_BF16
    assert _stat_err(m, want_m) <= chip_smoke.STAT_TOL
    assert _stat_err(l, want_l) <= chip_smoke.STAT_TOL


@pytest.fixture(scope="module")
def pallas_forward():
    """JAX's _flash_forward_lse in Pallas interpret mode, f32, at one
    two-tile and one causal four-tile shape."""
    jfa = importlib.import_module("vivqa_tpu.ops.flash_attention")
    out = {}
    jfa._INTERPRET = True
    try:
        for B, H, Lq, Lk, causal in ((1, 2, 128, 128, False),
                                     (1, 1, 128, 256, True)):
            q, k, v, _ = _arrays(B, H, Lq, Lk, 64, seed=13)
            bq, bk = jfa._pick_blocks(Lq, Lk)
            want = jfa._flash_forward_lse(*(jnp.asarray(a) for a in (q, k, v)),
                                          causal, bq, bk)
            out[(Lq, Lk, causal)] = ((q, k, v), [np.array(w) for w in want])
    finally:
        jfa._INTERPRET = False
    return out


@pytest.mark.parametrize("shape, key_tile, splits", [
    ((128, 128, False), 64, 1), ((128, 128, False), 64, 2),
    ((128, 256, True), 64, 1), ((128, 256, True), 64, 4)], ids=str)
def test_forward_schedule_matches_pallas_forward(shape, key_tile, splits,
                                                 pallas_forward):
    """The forward's schedule in f32, in one pass over the keys and split,
    against JAX's _flash_forward_lse (Pallas, interpret mode): o, m, l."""
    (q, k, v), (o, m, l) = pallas_forward[shape]
    got = _forward_schedule(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=shape[2], key_tile=key_tile, splits=splits)
    assert_close(got[0], o, msg="o", **GRAD_TOL)
    assert_close(got[1], m, msg="m", **GRAD_TOL)
    assert_close(got[2], l, msg="l", atol=1e-4, rtol=2e-5)


# (B, H, Lq, Lk, mask kind, causal) at head dim 32, each at its plan: the
# tile form with keyless rows and causal both ways, the long form split
FORWARD_SCHEDULE_CASES = [
    (2, 2, 49, 64, "key", False),
    (2, 2, 64, 64, "query_key", False),
    (2, 2, 40, 9, None, True),
    (1, 2, 32, 200, None, False),
    (1, 2, 150, 150, None, True),
    (2, 2, 130, 300, "query_key", False),
]


@pytest.fixture(scope="module")
def xla_forwards():
    """_xla_attention for each FORWARD_SCHEDULE_CASES row, f32, one jitted
    function a case."""
    out = {}
    for case in FORWARD_SCHEDULE_CASES:
        B, H, Lq, Lk, kind, causal = case
        q, k, v, _ = _arrays(B, H, Lq, Lk, 32, seed=14)
        mask = _mask(kind, B, Lq, Lk)
        fwd = jax.jit(lambda q, k, v, mask=None if mask is None
                      else jnp.asarray(mask), causal=causal:
                      _xla_attention(q, k, v, mask, causal))
        want = fwd(*(jnp.asarray(a) for a in (q, k, v)))
        out[case] = ((q, k, v, mask), np.asarray(want))
    return out


@pytest.mark.parametrize("case", FORWARD_SCHEDULE_CASES, ids=str)
def test_forward_schedule_matches_xla_attention(case, xla_forwards):
    """The forward's schedule in f32 at the call's plan (key tiles and
    splits) against _xla_attention: a row whose keys are all removed is
    the mean of v."""
    B, H, Lq, Lk, kind, causal = case
    (q, k, v, mask), want = xla_forwards[case]
    key_tile, splits = _planned(B, H, Lq, Lk, 32)
    got, _, _ = _forward_schedule(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), causal,
        key_tile=key_tile, splits=splits)
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want, **GRAD_TOL)


@pytest.mark.parametrize("operand_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_keyless_rows_across_splits(operand_dtype):
    """A row whose keys are all removed, over 5 key splits: every split's
    m is -1e30, so the merge weighs each by 1: m is exactly -1e30, l
    exactly Lk, and o the mean of v."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 2, 40, 300, 64,
                                                       seed=15))
    if operand_dtype is not None:
        q, k, v = (t.to(operand_dtype) for t in (q, k, v))
    mask = torch.ones(1, 1, 40, 300, dtype=torch.bool)
    mask[:, :, :5] = False
    key_tile, splits = _planned(1, 2, 40, 300, 64)
    assert splits == 5
    o, m, l = _forward_schedule(q, k, v, mask, key_tile=key_tile,
                                splits=splits, operand_dtype=operand_dtype)
    assert (m[:, :, :5] == fa.NEG_INF).all() and (m[:, :, 5:] > -1e3).all()
    assert (l[:, :, :5] == 300).all()
    mean = v.float().mean(2, keepdim=True).expand(1, 2, 5, 64)
    assert_close(o[:, :, :5].float(), mean,
                 **(GRAD_TOL if operand_dtype is None
                    else dict(atol=1e-2, rtol=1e-2)))


@pytest.mark.parametrize("shape, want", [
    # the flagship step's five shapes at batch 128 and the serving batch
    ((128, 12, 50, 50, 64), ("tile", 1, 1536, 64, 64, 1, None)),
    ((128, 8, 49, 49, 64), ("tile", 1, 1024, 64, 64, 1, None)),
    ((128, 12, 64, 64, 64), ("tile", 1, 1536, 64, 64, 1, None)),
    ((128, 8, 49, 64, 64), ("tile", 1, 1024, 64, 64, 1, None)),
    ((8, 12, 50, 50, 64), ("tile", 1, 96, 64, 64, 1, None)),
    # the generative fusion's 113, its decoder's cross call over 118
    ((16, 8, 113, 113, 64), ("tile", 1, 128, 128, 128, 1, None)),
    ((32, 8, 32, 118, 64), ("tile", 1, 256, 64, 64, 1, None)),
    # at most 32 keys: one 32-key tile (the ablation study's experts, the
    # generative decoder's self calls in training), also past 64 queries
    ((32, 8, 8, 8, 64), ("tile", 1, 256, 64, 32, 1, None)),
    ((32, 8, 80, 32, 64), ("tile", 1, 512, 64, 32, 1, None)),
    ((32, 8, 32, 33, 64), ("tile", 1, 256, 64, 64, 1, None)),
    # single queries: the decoder's self calls over the cache, its cross
    # calls over 113, KnowledgeAttention over 5
    ((64, 8, 1, 32, 64), ("decode", 1, 512, None, None, 1, None)),
    ((64, 8, 1, 113, 64), ("decode", 1, 512, None, None, 1, None)),
    ((128, 8, 1, 5, 64), ("decode", 1, 1024, None, None, 1, None)),
    # long keys: ViT-B/16's 197 (at batch 2 split), the zoo's 32 x 784
    # (split), long_1024, DINOv2's 1,370, and head dim 128 split
    ((4, 12, 197, 197, 64), ("long", 1, 96, 128, 128, 1, None)),
    ((2, 12, 197, 197, 64), ("long", 2, 96, 128, 128, 2,
                             (2, 2, 12, 197, 66))),
    ((8, 4, 32, 784, 64), ("long", 2, 224, 64, 64, 7, (7, 8, 4, 32, 66))),
    ((2, 8, 1024, 1024, 64), ("long", 1, 128, 128, 128, 1, None)),
    ((1, 12, 1370, 1370, 64), ("long", 1, 132, 128, 128, 1, None)),
    ((2, 2, 64, 300, 128), ("long", 2, 20, 64, 64, 5, (5, 2, 2, 64, 130))),
    ((2, 2, 200, 300, 128), ("long", 2, 40, 128, 64, 5,
                             (5, 2, 2, 200, 130))),
], ids=str)
def test_forward_plan_by_shape(shape, want):
    """The form a call takes, its launches, its units, its query and key
    tiles, its key splits and the f32 scratch of the split partials: at
    most 4 queries the decode form, a unit per (b, h); else a unit per
    (b, h, 64-query tile) over 64-key tiles (one 32-key tile over at most
    32 keys), one launch while the keys fit 128; more than 64 keys over
    more than 64 queries take 128-query units, and where long keys leave
    fewer units than half the H100's 132 SMs, key splits merged by a
    second launch; the splits' key tiles add up to the call's."""
    plan = fa.forward_plan(*shape)
    assert (plan["form"], plan["launches"], plan["units"], plan["query_tile"],
            plan["key_tile"], plan["splits"], plan["scratch"]) == want
    if plan["form"] != "decode":
        n_kt = -(-shape[3] // plan["key_tile"])
        assert -(-n_kt // plan["tiles_per_split"]) == plan["splits"]


def test_forward_plan_splits_by_the_cards_sm_count():
    """The key splits follow the SM count the wrapper reads from the card:
    ViT-B/16's 197 tokens at batch 2 (24 units of 128 queries) split in
    two on the H100's 132 SMs, not at all on a card of 40 SMs, and never
    into more splits than their two 128-key tiles."""
    assert [fa.forward_plan(2, 12, 197, 197, 64, sms)["splits"]
            for sms in (132, 40, 264)] == [2, 1, 2]
    assert fa.forward_plan(1, 4, 32, 784, 64, 40)["splits"] == 13
    assert fa.forward_plan(1, 4, 32, 784, 64, 8)["splits"] == 1


def test_forward_scratch_bytes_match_hand_count():
    """chip_smoke.fwd_scratch_bytes: the split partials, f32 o, m and l
    of every (split, b, h, query), written once and read once; 0 without
    splits."""
    import chip_smoke
    q = torch.empty(8, 4, 32, 64, dtype=torch.bfloat16)
    k = torch.empty(8, 4, 784, 64, dtype=torch.bfloat16)
    assert chip_smoke.fwd_scratch_bytes(q, k) == 2 * 7 * 8 * 4 * 32 * 66 * 4
    q = torch.empty(2, 8, 1024, 64, dtype=torch.bfloat16)
    assert chip_smoke.fwd_scratch_bytes(q, q) == 0
