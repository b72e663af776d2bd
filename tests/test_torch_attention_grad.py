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
