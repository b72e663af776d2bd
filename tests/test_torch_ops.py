"""Parity of the port's attention and embedding ops with the JAX package.

``attention_reference`` is held against ``_xla_attention``, flax's
``nn.dot_product_attention`` with masks, and the Pallas forward kernel in
interpret mode. The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""

from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import F32_TOL, assert_close, padding_mask
from vivqa_tpu.ops.flash_attention import _xla_attention
from vivqa_tpu_torch.ops import flash_attention as port_fa
from vivqa_tpu_torch.ops.flash_attention import (attention_reference,
                                                 flash_attention,
                                                 flash_attention_cuda)

torch.set_num_threads(1)


def _qkv(B, H, Lq, Lk, D, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.standard_normal(s).astype(np.float32)
                 for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D)))


def _mask(kind, B, Lq, Lk, seed=1):
    """(B, 1, Lq, Lk) bool numpy mask, or None."""
    if kind is None:
        return None
    rs = np.random.RandomState(seed)
    k_valid = padding_mask(rs.randint(1, Lk + 1, B), Lk)
    if kind == "key":
        q_valid = np.ones((B, Lq), np.int32)
    else:   # query AND key padding: padded query rows are fully masked
        q_valid = padding_mask(rs.randint(1, Lq + 1, B), Lq)
        q_valid[0, -1] = 0          # at least one fully masked row
    return (q_valid[:, None, :, None] * k_valid[:, None, None, :]) != 0


ATTN_CASES = [
    dict(Lq=9, Lk=9, causal=False, mask=None),
    dict(Lq=7, Lk=11, causal=False, mask="key"),
    dict(Lq=8, Lk=8, causal=False, mask="query_key"),
    dict(Lq=6, Lk=13, causal=False, mask="query_key"),
    dict(Lq=8, Lk=8, causal=True, mask=None),
    dict(Lq=5, Lk=9, causal=True, mask=None),     # Lq < Lk
    dict(Lq=9, Lk=5, causal=True, mask=None),     # Lq > Lk: fully masked rows
    dict(Lq=8, Lk=8, causal=True, mask="query_key"),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_reference_matches_xla(case):
    q, k, v = _qkv(2, 3, case["Lq"], case["Lk"], 16)
    mask = _mask(case["mask"], 2, case["Lq"], case["Lk"])
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if mask is None else jnp.asarray(mask),
                          case["causal"])
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              None if mask is None else torch.from_numpy(mask),
                              case["causal"])
    assert np.isfinite(got.numpy()).all()
    assert_close(got, want, **F32_TOL)


@pytest.mark.parametrize("kind", [None, "key", "query_key"])
def test_attention_reference_matches_flax_masking(kind):
    """flax's fully masked rows are the uniform average over all keys."""
    B, H, Lq, Lk, D = 2, 2, 8, 8, 16
    q, k, v = _qkv(B, H, Lq, Lk, D, seed=3)
    mask = _mask(kind, B, Lq, Lk, seed=4)
    # flax layout (B, L, H, D)
    want = nn.dot_product_attention(
        *(jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask),
        dtype=jnp.float32)
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              None if mask is None else torch.from_numpy(mask))
    assert_close(got.transpose(1, 2), want, **F32_TOL)
    if kind == "query_key":
        # the fully masked row is the plain mean of v over the keys
        assert_close(got[0, :, -1], v[0].mean(axis=1), **F32_TOL)


@pytest.mark.parametrize("case", [dict(Lq=256, Lk=256, causal=False),
                                  dict(Lq=128, Lk=256, causal=True),
                                  dict(Lq=256, Lk=128, causal=True)], ids=str)
def test_attention_reference_matches_pallas_interpret(case):
    fa = importlib.import_module("vivqa_tpu.ops.flash_attention")
    q, k, v = _qkv(1, 1, case["Lq"], case["Lk"], 64, seed=5)
    bq, bk = fa._pick_blocks(case["Lq"], case["Lk"])
    fa._INTERPRET = True
    try:
        want = fa._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), case["causal"], bq, bk)
    finally:
        fa._INTERPRET = False
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=case["causal"])
    assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_attention_reference_bf16_matches_xla():
    """bf16 in: f32 logits and softmax, probabilities cast to bf16 before
    P.V in both. Tolerance: two bf16 roundings of values of size ~1
    (2**-8 relative each)."""
    q, k, v = _qkv(2, 2, 8, 8, 16, seed=6)
    mask = _mask("query_key", 2, 8, 8)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want = _xla_attention(jq, jk, jv, jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    got = attention_reference(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, atol=1e-2, rtol=1e-2)


def test_flash_attention_on_cpu_takes_plain_version():
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 5, 7, 64, seed=7))
    before = dict(port_fa.launch_counts)
    out = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out, attention_reference(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert port_fa.launch_counts == before


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors raise."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(1, 2, 5, 7, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


def test_forward_form_by_query_count():
    """Calls of at most 4 queries (the decoder's single-query calls,
    KnowledgeAttention's) take the decode form, any longer call a unit per
    64-query tile on wgmma: the tile form while the keys fit 128, the long
    form beyond."""
    from vivqa_tpu_torch.ops import flash_attention as fa
    assert [fa.forward_plan(8, 8, Lq, 113, 64)["form"]
            for Lq in (1, 4, 5, 113)] == ["decode", "decode", "tile", "tile"]
    assert [fa.forward_plan(8, 8, 64, Lk, 64)["form"]
            for Lk in (1, 128, 129, 1024)] == ["tile", "tile", "long", "long"]


def test_attention_kernel_counts_by_device_name():
    """Profiled kernel names map to the launch counts' names (the serving
    forward's forms apart from the training forward's, the long form's
    merge apart from both, the one-pass backward apart from its long
    form's dQ sum and from the f32 dQ and dK/dV kernels; the f32 forward
    kernel is none of them), and library attention is listed, whatever
    else the profile holds."""
    from vivqa_tpu_torch.ops import flash_attention as fa
    kernels = {
        "void (anonymous namespace)::flash_attn_fwd_serve_kernel<__nv_bfloat16,"
        " 64, 64, false>(vivqa::fwd::Args)": 2,
        "void (anonymous namespace)::flash_attn_fwd_serve_dec_kernel<"
        "__nv_bfloat16, 64, 1, true>(vivqa::fwd::Params)": 1,
        "void (anonymous namespace)::flash_attn_fwd_train_kernel<__nv_bfloat16,"
        " 64, 64, true>(vivqa::fwd::Args)": 1,
        "void (anonymous namespace)::flash_attn_fwd_train_dec_kernel<"
        "__nv_bfloat16, 64, 1, true>(vivqa::fwd::Params)": 1,
        "void (anonymous namespace)::flash_attn_fwd_merge_kernel<__nv_bfloat16,"
        " 64, false>(vivqa::fwd::Params, float const*, int)": 2,
        "void (anonymous namespace)::flash_attn_fwd_kernel<float, 64, true>("
        "vivqa::fwd::Params)": 6,
        "void vivqa::bwd::flash_attn_bwd_kernel<__nv_bfloat16, 64, 1, true, "
        "false>(vivqa::bwd::Args)": 2,
        "void vivqa::bwd::flash_attn_bwd_kernel<__nv_bfloat16, 64, 1, false, "
        "true>(vivqa::bwd::Args)": 1,
        "void vivqa::bwd::flash_attn_bwd_sum_kernel<__nv_bfloat16, 64>("
        "vivqa::BwdParams, float const*, int)": 1,
        "void (anonymous namespace)::flash_attn_bwd_dq_kernel<float, 64>("
        "vivqa::BwdParams)": 5,
        "void (anonymous namespace)::flash_attn_bwd_dkv_kernel<float, 64>("
        "vivqa::BwdParams)": 4,
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>()": 4,
        "fmha_cutlassB_f16_aligned_64x64_k64_sm80": 1,
        "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn": 9}
    counts = fa.attention_kernel_counts(kernels)
    assert {k: v for k, v in counts.items() if k != "library"} == {
        "flash_attn_fwd": 3, "flash_attn_fwd_lse": 2,
        "flash_attn_fwd_merge": 2,
        "flash_attn_bwd": 3, "flash_attn_bwd_sum": 1,
        "flash_attn_bwd_dq": 5, "flash_attn_bwd_dkv": 4}
    assert counts["library"] == [
        "fmha_cutlassB_f16_aligned_64x64_k64_sm80",
        "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>()"]
    assert set(fa.DEVICE_KERNEL_NAMES) == set(fa.launch_counts)


def _attention_variants():
    spec = importlib.util.spec_from_file_location(
        "attention_variants",
        Path(__file__).resolve().parents[1] / "tools" / "attention_variants.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", [v[0] for v in _attention_variants().VARIANTS])
def test_attention_variants_apply_to_the_kernel_sources(name):
    """tools/attention_variants.py rewrites the kernels by text: every
    substitution still matches its source exactly once, so the variants
    PERF.md cites stay buildable as the kernels change."""
    tool = _attention_variants()
    _, source, subs, _ = next(v for v in tool.VARIANTS if v[0] == name)
    text = tool.variant_source(name)
    original = (tool.cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    assert (text == original) == (not subs)


def test_embedding_matches_matmul_grad_embed():
    from vivqa_tpu.ops.embedding import MatmulGradEmbed
    from vivqa_tpu_torch.ops.embedding import Embed
    rs = np.random.RandomState(8)
    ids = rs.randint(0, 50, (2, 6)).astype(np.int32)
    table = rs.standard_normal((50, 16)).astype(np.float32)
    jm = MatmulGradEmbed(50, 16, dtype=jnp.bfloat16)
    variables = {"params": {"embedding": jnp.asarray(table)}}
    port = Embed(50, 16, torch.bfloat16)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(table))
    got = port(torch.from_numpy(ids).long())
    want = jm.apply(variables, jnp.asarray(ids))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, atol=0, rtol=0)      # a gather and a cast: exact
    query = rs.standard_normal((2, 6, 16)).astype(np.float32)
    assert_close(port.attend(torch.from_numpy(query)),
                 jm.apply(variables, jnp.asarray(query), method=jm.attend),
                 **F32_TOL)
