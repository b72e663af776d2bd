"""Tests of the port that need a CUDA card: the hand-written attention
kernel against its plain version, and the model on the card against the
same weights on the CPU. They skip on a host without a card.

This file imports neither JAX nor the JAX package, so on a machine with
the card and without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_support import assert_close_bf16, padding_mask
from vivqa_tpu_torch.models import config as PC
from vivqa_tpu_torch.models.vqa_model import create_vqa_model
from vivqa_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu

# kernel vs plain version on the same inputs: f32 differs by summation
# order only; in bf16 the plain version rounds the normalised
# probabilities to bf16 before P.V, the kernels' tensor-core templates
# (serving and training) round the unnormalised ones (a few bf16 ulps of
# outputs ~1); f16 keeps 3 more bits and takes the same bound
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16, torch.float16]

CASES = [  # (B, H, Lq, Lk, D, mask kind, causal)
    (8, 12, 50, 50, 64, None, False),
    (8, 12, 64, 64, 64, "query_key", False),
    (8, 8, 49, 64, 64, "key", False),
    (8, 8, 49, 49, 64, None, False),
    (3, 2, 64, 64, 64, None, True),
    (3, 2, 9, 40, 64, None, True),          # Lq < Lk
    (3, 2, 40, 9, 64, None, True),          # Lq > Lk: fully masked rows
    (3, 2, 33, 33, 64, "query_key", True),
    (2, 4, 113, 113, 128, "key", False),
    (1, 2, 1, 70, 64, None, False),         # one query row
    (4, 4, 65, 65, 32, "query_key", False),  # D 32: the convergence models
    (4, 4, 24, 24, 32, None, True),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(B, H, Lq, Lk, D, kind, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
               for L in (Lq, Lk, Lk))
    mask = None
    if kind is not None:
        lens = torch.randint(1, min(Lq, Lk) + 1, (B,), generator=gen)
        kv = torch.from_numpy(padding_mask(lens.numpy(), Lk)) != 0
        qv = (torch.from_numpy(padding_mask(lens.numpy(), Lq)) != 0
              if kind == "query_key" else torch.ones(B, Lq, dtype=torch.bool))
        mask = (qv[:, None, :, None] & kv[:, None, None, :]).cuda()
    return q, k, v, mask


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernel_matches_plain_version(case, dtype):
    _need_card()
    *shape, kind, causal = case
    q, k, v, mask = _inputs(*shape, kind, dtype)
    before = fa.launch_counts["flash_attn_fwd"]
    got = fa.flash_attention_cuda(q, k, v, mask, causal)
    assert fa.launch_counts["flash_attn_fwd"] == before + 1
    want = fa.attention_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


# The serving forward's tensor-core template at each tile size, with
# query counts that leave a last tile of 1, 1 and 17 rows at 16 rows a
# block: a query-key mask (fully masked rows), causal with Lq = Lk, and
# causal with Lq > Lk (a tile that mixes rows with and without keys).
SERVE_TILE_CASES = [  # (B, H, Lq, Lk, D, mask kind, causal)
    (3, 2, 17, 40, 64, "query_key", False),
    (3, 2, 33, 33, 64, None, True),
    (3, 2, 49, 24, 64, None, True),
    (3, 2, 17, 40, 32, "query_key", False),
]


@pytest.mark.parametrize("tile_rows", fa.TILE_ROWS)
@pytest.mark.parametrize("case", SERVE_TILE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_serving_kernel_tile_rows(case, dtype, tile_rows):
    _need_card()
    *shape, kind, causal = case
    q, k, v, mask = _inputs(*shape, kind, dtype)
    got = fa.flash_attention_cuda(q, k, v, mask, causal, tile_rows)
    want = fa.attention_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_kernel_reads_strided_views(offset):
    """(B, L, H, D) projections viewed as (B, H, L, D), and a mask
    broadcast over the queries, are read in place; rows that do not start
    on 16 bytes (offset 1) take the element-wise loads."""
    _need_card()
    B, L, H, D = 4, 37, 6, 64
    x = torch.randn(B, L, 3 * H * D + offset, device="cuda",
                    dtype=torch.bfloat16)[..., offset:]
    q, k, v = (t.view(B, L, H, D).transpose(1, 2)
               for t in x.split(H * D, dim=-1))
    key_mask = (torch.arange(L, device="cuda")[None]
                < torch.tensor([37, 20, 5, 1], device="cuda")[:, None])
    mask = key_mask[:, None, None, :]                    # (B, 1, 1, L)
    got = fa.flash_attention_cuda(q, k, v, mask)
    want = fa.attention_reference(q.contiguous(), k.contiguous(),
                                  v.contiguous(), mask)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_kernel_rejects_what_it_does_not_take():
    _need_card()
    q = torch.randn(1, 1, 4, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.randn(1, 1, 4, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_cuda(q, q, q)
    q = torch.randn(1, 1, 64, 4, device="cuda").transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q, q, q)


def test_model_on_card_matches_cpu():
    """Same weights on the card (attention through the kernel) and on the
    CPU (the plain version), flagship structure at small widths."""
    _need_card()
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(backbone="clip", image_size=64,
                                      patch_size=16, hidden_dim=128,
                                      num_layers=2, num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=128,
                                  num_layers=2, num_heads=2, max_length=16),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=128,
                               num_heads=2, num_layers=2),
        moe=PC.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                              expert_hidden_dim=256),
        num_answers=32)
    cpu = create_vqa_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
    card = create_vqa_model(cfg, device="cuda",
                            generator=torch.Generator().manual_seed(1))
    rs = np.random.RandomState(0)
    px = torch.from_numpy(rs.standard_normal((8, 64, 64, 3)).astype(
        np.float32))
    mask = torch.from_numpy(padding_mask(rs.randint(1, 17, 8), 16))
    ids = torch.from_numpy(rs.randint(4, 100, (8, 16))) * mask
    fa.reset_launch_counts()
    with torch.inference_mode():
        got = card(px.cuda(), ids.cuda(), mask.cuda())
        want = cpu(px, ids, mask)
    # ViT 2 + text 2 + MCAN encoder 2 + decoder 2 x (self + cross)
    assert fa.launch_counts["flash_attn_fwd"] == 2 + 2 + 2 + 2 * 2
    assert_close_bf16(got["logits"].cpu(), want["logits"], msg="logits")
    assert abs(float(got["aux_loss"]) - float(want["aux_loss"])) < 2e-3


# -- the training kernels: forward with stats, dQ, dK/dV ---------------------
# Kernel vs plain version on the same inputs (the backward kernels get the
# kernel forward's o, m and l). Gradients are held relative to each
# tensor's largest value: f32 differs by summation order only (1e-4); in
# bf16 and f16 both round their outputs once (2**-8 relative in bf16),
# and the dQ kernel rounds dS to the input dtype before dS.K, so 1e-2.
# m and l are f32 in both (1e-5 relative).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}

TRAIN_CASES = CASES + [
    (3, 2, 96, 24, 64, None, True),         # a tile with no key, one mixed
    (1, 2, 300, 1024, 64, "key", False),
    (2, 2, 100, 200, 64, None, True),       # causal skip over 64-key tiles
    (1, 2, 130, 130, 128, "query_key", False),  # D 128, two K/V buffers
]


def _assert_rel(got, want, tol, what):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: max |err| {err} > {tol} * {scale}"


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", TRAIN_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_training_kernels_match_plain_versions(case, dtype, rate):
    _need_card()
    *shape, kind, causal = case
    q, k, v, mask = _inputs(*shape, kind, dtype)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                     ).to("cuda", dtype)
    key = fa.dropout_key(1234, 5)
    before = dict(fa.launch_counts)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, causal, rate, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, causal,
                                        rate, key)
    for name in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                 "flash_attn_bwd_dkv"):
        assert fa.launch_counts[name] == before[name] + 1
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        q, k, v, mask, causal, rate, key)
    want = fa.attention_backward_reference(q, k, v, o, m, l, do, mask,
                                           causal, rate, key)
    torch.cuda.synchronize()
    _assert_rel(o, o_ref, TOL[dtype], "o")      # dropout scales o up
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        _assert_rel(got, ref, GRAD_TOL[dtype], name)


# dK/dV alone, fed the plain delta: keys that span two 64-key blocks of
# the tensor-core template (Lk = 65, 113), and the causal 96 x 24 case,
# whose first query tile mixes rows with and without keys; f32 takes the
# SIMT template, bf16 and f16 the tensor-core one.
DKV_CASES = [  # (B, H, Lq, Lk, D, mask kind, causal)
    (2, 2, 40, 65, 64, "key", False),
    (2, 2, 113, 113, 64, "query_key", False),
    (3, 2, 96, 24, 64, None, True),
]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", DKV_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dkv_kernel_matches_plain_version(case, dtype, rate):
    _need_card()
    *shape, kind, causal = case
    q, k, v, mask = _inputs(*shape, kind, dtype, seed=3)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)
                     ).to("cuda", dtype)
    key = fa.dropout_key(77, 2)
    o, m, l = fa.attention_forward_lse_reference(q, k, v, mask, causal, rate,
                                                 key)
    m, l = m.float().contiguous(), l.float().contiguous()
    delta = (do.float() * o.float()).sum(-1).contiguous()
    before = fa.launch_counts["flash_attn_bwd_dkv"]
    dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, m, l, do, delta, mask,
                                             causal, rate, key)
    assert fa.launch_counts["flash_attn_bwd_dkv"] == before + 1
    want = fa.attention_bwd_dkv_reference(q, k, v, m, l, do, delta, mask,
                                          causal, rate, key)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dk", "dv"), (dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        _assert_rel(got, ref, GRAD_TOL[dtype], name)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dropout_mask_bit_equal_to_plain_version(dtype):
    """q = k = 0 makes p = 1/Lk; v = the identity over the first Lk
    columns then gives o[q, j] = p z(q, j): nonzero exactly where the
    kernel kept key j. Every batch row and head gets the same mask. f32
    takes the SIMT template, bf16 and f16 the tensor-core one."""
    _need_card()
    B, H, Lq, Lk, D, rate = 2, 3, 50, 64, 64, 0.3
    q = torch.zeros(B, H, Lq, D, device="cuda", dtype=dtype)
    v = torch.eye(Lk, D, device="cuda", dtype=dtype).expand(
        B, H, Lk, D).contiguous()
    key = fa.dropout_key(99, 7)
    o, _, _ = fa.flash_attention_fwd_lse_cuda(q, torch.zeros_like(v), v,
                                              dropout_rate=rate,
                                              dropout_key=key)
    want = fa.dropout_keep_mask(Lq, Lk, rate, key, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(o[..., :Lk] > 0, want.expand(B, H, Lq, Lk))
    torch.testing.assert_close(
        o[..., :Lk], (want.float() / (Lk * (1 - rate))).expand(
            B, H, Lq, Lk).to(dtype))


def _bytes_before_unmapped(nbytes: int) -> torch.Tensor:
    """A uint8 tensor of ``nbytes`` on the card whose last byte is the
    last mapped byte of a reserved address range: a read past its end
    faults (illegal address), wherever the caching allocator would have
    put it. Made with the driver's virtual memory calls (one granule
    mapped at the start of two reserved); never unmapped, so it belongs
    in a process of its own."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    u64, size_t = ctypes.c_ulonglong, ctypes.c_size_t

    class Location(ctypes.Structure):        # CUmemLocation
        _fields_ = [("type", ctypes.c_int), ("id", ctypes.c_int)]

    class Prop(ctypes.Structure):            # CUmemAllocationProp
        _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                    ("location", Location), ("win32_meta", ctypes.c_void_p),
                    ("alloc_flags", ctypes.c_ubyte * 8)]

    class Access(ctypes.Structure):          # CUmemAccessDesc
        _fields_ = [("location", Location), ("flags", ctypes.c_int)]

    def check(err, call):
        if err != 0:
            raise RuntimeError(f"{call} failed: CUresult {err}")
    torch.zeros(1, device="cuda")             # the primary context, current
    here = Location(1, torch.cuda.current_device())  # LOCATION_TYPE_DEVICE
    prop = Prop(type=1, location=here)        # ALLOCATION_TYPE_PINNED
    gran = size_t()
    check(cuda.cuMemGetAllocationGranularity(ctypes.byref(gran),
                                             ctypes.byref(prop), 0),
          "cuMemGetAllocationGranularity")
    handle, base = u64(), u64()
    check(cuda.cuMemCreate(ctypes.byref(handle), size_t(gran.value),
                           ctypes.byref(prop), u64(0)), "cuMemCreate")
    check(cuda.cuMemAddressReserve(ctypes.byref(base), size_t(2 * gran.value),
                                   size_t(0), u64(0), u64(0)),
          "cuMemAddressReserve")
    check(cuda.cuMemMap(base, size_t(gran.value), size_t(0), handle, u64(0)),
          "cuMemMap")
    check(cuda.cuMemSetAccess(base, size_t(gran.value),
                              ctypes.byref(Access(here, 3)), size_t(1)),
          "cuMemSetAccess")                   # ACCESS_FLAGS_PROT_READWRITE

    class Raw:
        __cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "version": 2,
            "data": (base.value + gran.value - nbytes, False)}
    return torch.as_tensor(Raw(), device="cuda")


def masks_at_mapping_end():
    """The training kernels and the serving forward at the demo models'
    text attention, (32, 4, 12, 12) with head dim 32 and 64, each with its
    (32, 1, 12, 12) padding mask stored so that the last key of the last
    row is the last mapped byte. A 12-key row lies in the first 64-key
    block, whose keys past Lk no kernel may read. Runs in a process of its
    own (``test_kernels_read_no_mask_byte_past_the_last_key``), since a
    fault spoils the process's CUDA context."""
    B, H, L = 32, 4, 12
    for D in (32, 64):
        for dtype in DTYPES:
            q, k, v, mask = _inputs(B, H, L, L, D, "query_key", dtype)
            stored = _bytes_before_unmapped(mask.numel()).view(torch.bool)
            mask = stored.view(mask.shape).copy_(mask)
            do = torch.randn(q.shape, generator=torch.Generator(
                ).manual_seed(9)).to("cuda", dtype)
            o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask)
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask)
            served = fa.flash_attention_cuda(q, k, v, mask)
            torch.cuda.synchronize()
            want = fa.attention_backward_reference(q, k, v, o, m, l, do,
                                                   mask)
            what = f"D {D} {dtype}"
            _assert_rel(served, fa.attention_reference(q, k, v, mask),
                        TOL[dtype], f"{what} serving o")
            _assert_rel(o, fa.attention_reference(q, k, v, mask),
                        TOL[dtype], f"{what} o")
            for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
                _assert_rel(got, ref, GRAD_TOL[dtype], f"{what} {name}")
    print("masks at the mapping's end: ok", flush=True)


def test_kernels_read_no_mask_byte_past_the_last_key():
    """The dQ kernel once read the mask byte of keys past Lk before testing
    the bound (``KeyRule`` in ``csrc/flash_attn_mma.cuh``): at the demo
    text mask the last row's read left the tensor, and faulted where its
    allocation ended there. ``masks_at_mapping_end`` puts each mask's end
    at an unmapped page, so any such read faults; it runs in a child
    process, which must finish cleanly."""
    _need_card()
    import os
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests), str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c",
         "import test_torch_gpu as t; t.masks_at_mapping_end()"],
        cwd=tests, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "ok" in run.stdout, (
        f"rc {run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")


def _shifted(t, offset):
    """t as the (B, H, L, D) view of (B, L, H, D) storage that starts
    ``offset`` elements into its buffer: rows off 16 bytes when offset is
    odd."""
    B, H, L, D = t.shape
    buf = torch.empty(B, L, H * D + offset, dtype=t.dtype, device=t.device)
    view = buf[..., offset:].view(B, L, H, D)
    view.copy_(t.transpose(1, 2))
    return view.transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_training_kernels_read_strided_views(offset, dtype):
    """The training forward, dQ and dK/dV on (B, L, H, D) views, with
    dropout, a key mask and two key tiles; at offset 1 no row of q, k, v,
    dO or o starts on 16 bytes, so every tile takes the element loads."""
    _need_card()
    B, L, H, D = 3, 70, 4, 64
    gen = torch.Generator().manual_seed(6)
    q, k, v, do = (_shifted(torch.randn(B, H, L, D, generator=gen).to(
        "cuda", dtype), offset) for _ in range(4))
    mask = (torch.arange(L)[None] < torch.tensor([70, 33, 1])[:, None])
    mask = mask[:, None, None, :].cuda()                 # (B, 1, 1, L)
    key = fa.dropout_key(3, 4)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, False, 0.1, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, _shifted(o, offset), m, l,
                                        do, mask, False, 0.1, key)
    c = [t.contiguous() for t in (q, k, v, do)]
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        *c[:3], mask, False, 0.1, key)
    want = fa.attention_backward_reference(*c[:3], o, m, l, c[3], mask,
                                           False, 0.1, key)
    torch.cuda.synchronize()
    _assert_rel(o, o_ref, TOL[dtype], "o")
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert torch.isfinite(got).all(), name
        _assert_rel(got, ref, GRAD_TOL[dtype], name)


def test_training_kernels_reject_what_they_do_not_take():
    _need_card()
    q = torch.randn(1, 1, 4, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd_lse_cuda(q, q, q)
    q64 = torch.randn(1, 1, 4, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd_lse_cuda(q64, q64, q64)
    qc = torch.randn(1, 1, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_lse_cuda(qc, qc, qc)
    q = torch.randn(1, 1, 4, 64, device="cuda")
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, o, m, l, torch.zeros(1, 1, 4, 64))
    with pytest.raises(ValueError, match="m must be"):
        fa.flash_attention_bwd_cuda(q, q, q, o, m.double(), l, o)
    with pytest.raises(ValueError, match="dropout_key"):
        fa.flash_attention_fwd_lse_cuda(q, q, q, dropout_rate=0.1)


def test_autograd_function_on_card_matches_cpu():
    """flash_attention with a gradient: the card's kernels against the
    CPU's plain versions, from strided (B, L, H, D) views; dO arrives with
    its own strides and the gradients come back as (B, L, H, D) storage."""
    _need_card()
    B, L, H, D = 3, 37, 4, 64
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(B, L, 3 * H * D, generator=gen)
    mask = (torch.arange(L)[None] < torch.tensor([37, 20, 5])[:, None])
    mask = mask[:, None, None, :]
    key = fa.dropout_key(5, 1)
    grads = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).detach().requires_grad_(True)
        q, k, v = (t.view(B, L, H, D).transpose(1, 2)
                   for t in xd.split(H * D, dim=-1))
        y = fa.flash_attention(q, k, v, mask.to(dev), dropout_rate=0.1,
                               dropout_key=key)
        (y.transpose(1, 2).reshape(B, L, H * D).square().sum()).backward()
        grads[dev] = xd.grad
    _assert_rel(grads["cuda"].cpu(), grads["cpu"], 1e-4, "d(qkv)")


def test_train_step_on_card_matches_cpu():
    """Two optimizer steps of a small flagship-shaped model (dropout 0) on
    the card and on the CPU from the same weights: loss and grad_norm per
    step within 2% (bf16 trunk, different rounding points), every
    parameter within 3 learning rates of the CPU's (an Adam update moves
    each element by at most ~lr per step, and where a gradient is bf16
    noise its sign may differ)."""
    _need_card()
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  SchedulerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import (TrainState,
                                             classification_loss_fn,
                                             make_train_step)
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=2,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=128,
                                  num_layers=2, num_heads=2, max_length=16,
                                  dropout=0.0),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=128,
                               num_heads=2, num_layers=2, dropout=0.0),
        moe=PC.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                              expert_hidden_dim=256),
        head=PC.AnswerHeadConfig(dropout=0.0), num_answers=32)
    rs = np.random.RandomState(0)
    mask = torch.from_numpy(padding_mask(rs.randint(1, 17, 8), 16))
    batch = {"pixel_values": torch.from_numpy(
                 rs.standard_normal((8, 64, 64, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(rs.randint(4, 100, (8, 16))) * mask,
             "attention_mask": mask,
             "labels": torch.from_numpy(rs.randint(0, 32, 8))}
    lr = 1e-3
    runs = {}
    for dev in ("cpu", "cuda"):
        model = create_vqa_model(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(1))
        model.moe.dropout = 0.0
        opt = create_optimizer(OptimizerConfig(learning_rate=lr), model,
                               SchedulerConfig(warmup_steps=1,
                                               total_steps=10))
        state = TrainState.create(model, opt, seed=0)
        step = make_train_step(classification_loss_fn())
        b = {n: t.to(dev) for n, t in batch.items()}
        fa.reset_launch_counts()
        metrics = [step(state, b)[1] for _ in range(2)]
        runs[dev] = ([float(m["loss"]) for m in metrics],
                     [float(m["grad_norm"]) for m in metrics],
                     {n: p.detach().cpu()
                      for n, p in model.named_parameters()})
        if dev == "cuda":
            assert fa.launch_counts["flash_attn_fwd"] == 0
            for name in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                         "flash_attn_bwd_dkv"):
                assert fa.launch_counts[name] == 2 * 10, fa.launch_counts
    (cl, cn, cp), (gl, gn, gp) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=2e-2)
    np.testing.assert_allclose(gn, cn, rtol=2e-2)
    for name, p in cp.items():
        assert float((gp[name] - p).abs().max()) <= 3 * lr, name


# -- the generative path: decode and fusion shapes, generate -----------------
# bench_serving's single-query calls (Lq = 1) over the 32-position cache
# under its position mask (checked at three steps) and over the 113-token
# memory under a key mask, and the fusion's 113 x 113 query-key call; the
# rows of the beam calls are the 16 and 64 requests times 4 beams. Masks
# with random padding, and the ones bench_serving's unpadded questions
# give ("full_*": every key allowed, broadcast as the path builds them).
DECODE_CASES = [  # (B, H, Lq, Lk, D, mask kind)
    (16, 8, 1, 32, 64, "cache_pos"),
    (64, 8, 1, 32, 64, "cache_pos"),
    (64, 8, 1, 113, 64, "key"),
    (256, 8, 1, 113, 64, "key"),
    (64, 8, 1, 113, 64, "full_key"),
    (16, 8, 113, 113, 64, "query_key"),
    (16, 8, 113, 113, 64, "full_query_key"),
]


def _decode_inputs(B, H, Lq, Lk, D, kind, dtype, cur_index):
    gen = torch.Generator().manual_seed(cur_index)
    q, k, v = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
               for L in (Lq, Lk, Lk))
    if kind == "cache_pos":
        mask = (torch.arange(Lk) <= cur_index).view(1, 1, 1, Lk)
    elif kind == "full_key":
        mask = torch.ones(B, 1, 1, Lk, dtype=torch.bool)
    elif kind == "full_query_key":
        mask = torch.ones(B, 1, Lq, Lk, dtype=torch.bool)
    else:
        lens = torch.randint(1, Lk + 1, (B,), generator=gen).numpy()
        kv = torch.from_numpy(padding_mask(lens, Lk)) != 0
        qv = (torch.from_numpy(padding_mask(lens, Lq)) != 0
              if kind == "query_key" else torch.ones(B, Lq, dtype=torch.bool))
        mask = qv[:, None, :, None] & kv[:, None, None, :]
    return q, k, v, mask.cuda()


@pytest.mark.parametrize("tile_rows", fa.TILE_ROWS)
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_and_fusion_shapes_match_plain_version(case, dtype,
                                                      tile_rows):
    _need_card()
    *shape, kind = case
    for cur_index in ((0, 15, 31) if kind == "cache_pos" else (7,)):
        q, k, v, mask = _decode_inputs(*shape, kind, dtype, cur_index)
        got = fa.flash_attention_cuda(q, k, v, mask, False, tile_rows)
        want = fa.attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def _card_gen_config(dtype: str) -> PC.GenerativeVQAConfig:
    """The generative model's structure at head dim 64, small widths."""
    return PC.GenerativeVQAConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=2,
                                      num_heads=2, dtype=dtype),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=128,
                                  num_layers=2, num_heads=2, max_length=16,
                                  dtype=dtype),
        fusion_dim=128, fusion_layers=2, fusion_heads=2, vocab_size=100,
        decoder_layers=2, decoder_heads=2, decoder_dim=128,
        decoder_ff_dim=256, max_answer_length=8, dropout=0.0, dtype=dtype)


def _card_and_cpu_generate(dtype: str, strategy: str):
    from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
    from vivqa_tpu_torch.models.generative import create_generative_vqa_model
    cfg = _card_gen_config(dtype)
    rs = np.random.RandomState(1)
    px = torch.from_numpy(rs.rand(4, 64, 64, 3).astype(np.float32))
    qmask = torch.from_numpy(padding_mask([16, 9, 3, 1], 16))
    q = torch.from_numpy(rs.randint(4, 100, (4, 16))) * qmask
    dc = DecodeConfig(max_length=8, strategy=strategy, eos_token_id=2,
                      early_exit=False)
    out = {}
    for dev in ("cpu", "cuda"):
        model = create_generative_vqa_model(
            cfg, device=dev, generator=torch.Generator().manual_seed(2))
        fa.reset_launch_counts()
        seqs, scores = build_generate_fn(model, dc)(px.to(dev), q.to(dev),
                                                    qmask.to(dev))
        out[dev] = (model, seqs.cpu(), scores.cpu(),
                    dict(fa.launch_counts))
    # ViT 2 + text 2 + fusion 2, then 8 steps x 2 layers x (self + cross)
    assert out["cuda"][3]["flash_attn_fwd"] == 2 + 2 + 2 + 8 * 2 * 2
    assert out["cpu"][3]["flash_attn_fwd"] == 0
    return out, (px, q, qmask)


@pytest.mark.parametrize("strategy", ["greedy", "beam"])
def test_generate_on_card_matches_cpu_f32(strategy):
    """In f32 the card (SIMT attention template, TF32 off) and the CPU
    give the same tokens; scores agree to f32 summation order."""
    _need_card()
    out, _ = _card_and_cpu_generate("float32", strategy)
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], atol=1e-4,
                               rtol=1e-4)


def test_generate_on_card_matches_cpu_bf16():
    """In bf16 the two may pick different tokens where logits are within
    rounding, so the card's greedy sequences are teacher-forced on both
    and the logits compared."""
    _need_card()
    out, (px, q, qmask) = _card_and_cpu_generate("bfloat16", "greedy")
    seqs = out["cuda"][1]
    dec_in = torch.cat([torch.zeros_like(seqs[:, :1]), seqs[:, :-1]], 1)
    with torch.inference_mode():
        got = out["cuda"][0](px.cuda(), q.cuda(), dec_in.cuda(),
                             qmask.cuda())["logits"].cpu()
        want = out["cpu"][0](px, q, dec_in, qmask)["logits"]
    assert_close_bf16(got, want, msg="teacher-forced logits")
    assert torch.isfinite(out["cuda"][2]).all()


# -- the generative train step -----------------------------------------------
# The three training kernels at the generative step's new shapes, under the
# masks the model builds: the decoder's self-attention under causal AND
# answer padding (answers of 1-6 tokens: most of its 32 rows have no key),
# its cross-attention over the 113-token memory under the memory's key
# mask (B, 1, 1, 113), read with a stride-0 query axis, and the fusion's
# 113 x 113 call under the query-AND-key mask (49 patch tokens, then
# questions of 3-60 of 64 tokens; a ragged 49-key tail in dK/dV).
GEN_TRAIN_CASES = [  # (B, H, Lq, Lk, D, mask kind)
    (8, 8, 32, 32, 64, "dec_self"),
    (8, 8, 32, 113, 64, "cross"),
    (8, 8, 113, 113, 64, "fusion"),
]


def _gen_mask(kind, B, Lq, seed=0):
    from vivqa_tpu_torch.models.layers import (make_attention_mask,
                                               make_causal_mask)
    rs = np.random.RandomState(seed)
    q_mask = torch.from_numpy(padding_mask(rs.randint(3, 61, B), 64))
    d_mask = torch.from_numpy(padding_mask(rs.randint(2, 8, B), Lq))
    memory = torch.cat([torch.ones(B, 49, dtype=torch.int32), q_mask], 1)
    if kind == "dec_self":
        mask = make_causal_mask(d_mask) & make_attention_mask(d_mask, d_mask)
    elif kind == "cross":
        mask = make_attention_mask(None, memory)
    else:
        mask = make_attention_mask(memory, memory)
    return mask.cuda()


@pytest.mark.parametrize("rate", [0.0, 0.05], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", GEN_TRAIN_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_generative_training_kernels_match_plain_versions(case, dtype, rate):
    _need_card()
    B, H, Lq, Lk, D, kind = case
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
                   for L in (Lq, Lk, Lk, Lq))
    mask = _gen_mask(kind, B, Lq)
    keyless = int((~mask.expand(B, 1, Lq, Lk).any(-1)).sum())
    if kind == "cross":
        assert mask.shape == (B, 1, 1, Lk) and keyless == 0
    else:
        assert keyless > 0
    key = fa.dropout_key(4321, 6)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, False, rate, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, False,
                                        rate, key)
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        q, k, v, mask, False, rate, key)
    want = fa.attention_backward_reference(q, k, v, o, m, l, do, mask,
                                           False, rate, key)
    torch.cuda.synchronize()
    _assert_rel(o, o_ref, TOL[dtype], "o")
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        _assert_rel(got, ref, GRAD_TOL[dtype], name)


def test_generative_train_step_on_card_matches_cpu():
    """Two steps of the generative loss on a small generative model
    (dropout 0) on the card and on the CPU from the same weights, at batch
    4 with padded questions and answers of 1-5 tokens: loss and grad_norm
    per step within 2%, every parameter within 3 x the sum of the two
    steps' learning rates (as test_train_step_on_card_matches_cpu, for the
    same reasons); every
    attention call on the card through the training kernels."""
    _need_card()
    from vivqa_tpu_torch.data.dataset import IGNORE_INDEX
    from vivqa_tpu_torch.models.generative import create_generative_vqa_model
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  SchedulerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import (TrainState, generative_loss_fn,
                                             make_train_step)
    cfg = _card_gen_config("bfloat16")
    cfg = cfg.replace(text=cfg.text.replace(dropout=0.0))
    rs = np.random.RandomState(3)
    qmask = torch.from_numpy(padding_mask([16, 9, 3, 1], 16))
    lengths = [6, 4, 2, 1]                  # decoder positions, BOS first
    dmask = torch.from_numpy(padding_mask(lengths, 8))
    dec = torch.from_numpy(rs.randint(4, 100, (4, 8))) * dmask
    dec[:, 0] = 0
    labels = torch.full((4, 8), IGNORE_INDEX, dtype=torch.int64)
    for b, n in enumerate(lengths):
        labels[b, :n - 1] = dec[b, 1:n]
        labels[b, n - 1] = 2                # EOS
    batch = {"pixel_values": torch.from_numpy(
                 rs.rand(4, 64, 64, 3).astype(np.float32)),
             "question_ids": torch.from_numpy(rs.randint(4, 100, (4, 16)))
             * qmask, "question_mask": qmask, "decoder_input_ids": dec,
             "decoder_mask": dmask, "labels": labels}
    lr = 1e-3
    runs = {}
    for dev in ("cpu", "cuda"):
        model = create_generative_vqa_model(
            cfg, device=dev, generator=torch.Generator().manual_seed(1))
        opt = create_optimizer(OptimizerConfig(learning_rate=lr), model,
                               SchedulerConfig(name="onecycle",
                                               total_steps=10))
        state = TrainState.create(model, opt, seed=0)
        step = make_train_step(generative_loss_fn(label_smoothing=0.1))
        b = {n: t.to(dev) for n, t in batch.items()}
        fa.reset_launch_counts()
        metrics = [step(state, b)[1] for _ in range(2)]
        runs[dev] = ([float(m["loss"]) for m in metrics],
                     [float(m["grad_norm"]) for m in metrics],
                     {n: p.detach().cpu()
                      for n, p in model.named_parameters()})
        assert int(metrics[0]["n_tokens"]) == sum(lengths)
        if dev == "cuda":
            # ViT 2 + text 2 + fusion 2 + 2 decoder layers x (self + cross)
            assert fa.launch_counts["flash_attn_fwd"] == 0
            for name in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                         "flash_attn_bwd_dkv"):
                assert fa.launch_counts[name] == 2 * 10, fa.launch_counts
    lr_sum = sum(state.schedule(i) for i in range(2))
    (cl, cn, cp), (gl, gn, gp) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=2e-2)
    np.testing.assert_allclose(gn, cn, rtol=2e-2)
    for name, p in cp.items():
        assert float((gp[name] - p).abs().max()) <= 3 * lr_sum, name


# -- the classification pipeline: prefetch and the pipeline's train step ----
def test_device_prefetch_on_card_equals_blocking_copy():
    """device_prefetch's pinned, non-blocking copies on a side stream give
    exactly the tensors a blocking copy gives, with three batches in
    flight while the compute stream is kept busy: each batch is read on
    the compute stream as soon as it arrives and then dropped, so a copy
    that overwrote memory still in use, or a read that did not wait for
    its copy, would change a checksum."""
    _need_card()
    from vivqa_tpu_torch.data.loader import device_prefetch
    rs = np.random.RandomState(0)
    batches = [{"pixel_values": rs.standard_normal((8, 224, 224, 3)).astype(
                    np.float32),
                "input_ids": rs.randint(0, 64000, (8, 64)).astype(np.int32),
                "u8": rs.randint(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                "question": [f"q{i}"], "_num_valid": i}
               for i in range(12)]
    want = [{k: torch.from_numpy(v).cuda() for k, v in b.items()
             if isinstance(v, np.ndarray)} for b in batches]
    w = torch.randn(2048, 2048, device="cuda")
    sums, kept = [], []
    for i, b in enumerate(device_prefetch(iter(batches), "cuda",
                                          buffer_size=3)):
        for _ in range(4):                  # keep the compute stream busy
            w = torch.tanh(w @ w * 1e-3)
        assert b["question"] == [f"q{i}"] and b["_num_valid"] == i
        assert b["input_ids"].dtype == torch.int64
        assert b["pixel_values"].dtype == torch.float32
        assert b["u8"].dtype == torch.uint8
        sums.append(torch.stack([b["pixel_values"].double().sum(),
                                 b["input_ids"].double().sum(),
                                 b["u8"].double().sum()]))
        if i % 4 == 0:
            kept.append((i, b))
    torch.cuda.synchronize()
    for i, s in enumerate(sums):
        ref = want[i]
        expect = torch.stack([ref["pixel_values"].double().sum(),
                              ref["input_ids"].double().sum(),
                              ref["u8"].double().sum()])
        assert torch.equal(s, expect), i
    for i, b in kept:
        for k, ref in want[i].items():
            assert torch.equal(b[k], ref.long() if k == "input_ids"
                               else ref), (i, k)


def test_pipeline_train_step_on_card_launches_training_kernels(tmp_path):
    """One epoch of one step of TrainingPipeline on the card, under the
    profiler: the step launches each training kernel once per attention
    call (5 here), the two validations (the epoch's and the final one on
    the best checkpoint) the serving forward 5 times each, as the launch
    counts say; no library attention kernel runs."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
    from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                         DataPipelineConfig)
    from vivqa_tpu_torch.pipelines.training_pipeline import (
        TrainingPipeline, TrainingPipelineConfig)
    csv, imgs = generate_synthetic_vivqa(tmp_path / "data", n=10,
                                         image_size=64)
    data = DataPipeline(DataPipelineConfig(
        csv_path=str(csv), image_dir=str(imgs), image_size=64,
        max_question_length=16, batch_size=8)).run()
    assert len(data.train_loader) == 1
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=1,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=data.tokenizer.vocab_size,
                                  hidden_dim=128, num_layers=1, num_heads=2,
                                  max_length=16),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=128,
                               num_heads=2, num_layers=1),
        num_answers=len(data.answer2id))
    model = create_vqa_model(cfg, device="cuda")
    fa.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = TrainingPipeline(TrainingPipelineConfig(
            num_epochs=1, checkpoint_dir=str(tmp_path / "ck"))).run(
            model, data.train_loader, data.val_loader, data.id2answer)
        torch.cuda.synchronize()
    assert out.best_step == 1 and np.isfinite(out.history[0]["train_loss"])
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            kernels[e.name] = kernels.get(e.name, 0) + 1
    want = {"flash_attn_fwd": 10, "flash_attn_fwd_lse": 5,
            "flash_attn_bwd_dq": 5, "flash_attn_bwd_dkv": 5}
    assert fa.attention_kernel_counts(kernels) == {**want, "library": []}
    assert dict(fa.launch_counts) == want, fa.launch_counts


# -- the generative CLI pipeline ------------------------------------------------
def _gen_cli_config(tmp_path, epochs=1):
    """A tiny generative pipeline on the card (head dim 64) over a
    learnable seq_answers corpus of 40 images: 4 train steps of 8."""
    from vivqa_tpu_torch.data.synthetic import generate_synthetic_vivqa
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines.data_pipeline import DataPipelineConfig
    from vivqa_tpu_torch.pipelines.generative_training_pipeline import \
        GenerativeTrainingConfig
    csv, imgs = generate_synthetic_vivqa(tmp_path / "data", n=40,
                                         image_size=64, learnable=True,
                                         seq_answers=True)
    model = PC.GenerativeVQAConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=1,
                                      num_heads=2),
        text=PC.TextEncoderConfig(hidden_dim=128, num_layers=1, num_heads=2,
                                  max_length=12),
        fusion_dim=128, fusion_layers=1, fusion_heads=2, decoder_layers=1,
        decoder_heads=2, decoder_dim=128, decoder_ff_dim=256)
    return gvp.GenerativeVQAPipelineConfig(
        data=DataPipelineConfig(csv_path=str(csv), image_dir=str(imgs),
                                image_size=64, max_question_length=12,
                                max_answer_length=8, batch_size=8,
                                generative=True),
        model=model,
        training=GenerativeTrainingConfig(
            num_epochs=epochs, checkpoint_dir=str(tmp_path / "ck")),
        output_dir=str(tmp_path / "out"))


def test_generative_cli_train_evaluate_inference_on_card(tmp_path):
    """``main`` with a YAML config and no --device: train, then evaluate
    (beam 4) and inference from the checkpoint, all on the card, with
    finite metrics and one generation per test sample."""
    _need_card()
    import json
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    cfg = _gen_cli_config(tmp_path)
    path = tmp_path / "cfg.yaml"
    cfg.to_yaml(path)
    assert cfg.device == "cuda"
    base = ["--config", str(path)]
    train = gvp.main(base + ["--mode", "train"])
    assert len(train["history"]) == 1
    assert all(np.isfinite(v) for v in train["history"][0].values())
    ck = cfg.training.checkpoint_dir
    ev = gvp.main(base + ["--mode", "evaluate", "--resume", ck,
                          "--decode", "beam", "--num-beams", "4"])
    assert all(np.isfinite(v) for v in ev["metrics"].values())
    inf = gvp.main(base + ["--mode", "inference", "--resume", ck])
    results = json.loads(open(inf["results_path"]).read())
    assert len(results) == 4
    assert all(np.isfinite(r["score"]) for r in results)


def test_generative_resume_and_checkpoint_reader_keep_params_on_card(
        tmp_path):
    """After resume (the pipeline's) and load_model_from_checkpoint
    (vivqa_evaluation's), every parameter is a CUDA tensor holding the
    checkpoint's value."""
    _need_card()
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines.vivqa_evaluation import \
        load_model_from_checkpoint
    from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                                  CheckpointManager)
    cfg = _gen_cli_config(tmp_path)
    gvp.GenerativeVQAPipeline(cfg).run()
    ck = cfg.training.checkpoint_dir
    saved, _ = CheckpointManager(CheckpointConfig(directory=ck)
                                 ).restore_best()
    _, model = gvp.GenerativeVQAPipeline(cfg.replace(resume=ck))._setup()
    reader, meta = load_model_from_checkpoint(ck)
    assert meta["epoch"] == 0
    for m in (model, reader):
        for name, p in m.named_parameters():
            assert p.device.type == "cuda", name
            assert torch.equal(p.detach().cpu(), saved["params"][name]), name


def test_generative_pipeline_launch_counts_on_card(tmp_path):
    """Through the pipeline on the card: one train step launches each
    training kernel once per attention call (1 ViT + 1 text + 1 fusion +
    2 decoder = 5) and no forward kernel; one generate launches the
    forward kernel 3 times for the encoders and the fusion and 2 a decode
    step, and no training kernel; the profiler sees the same kernels and
    no library attention."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from vivqa_tpu_torch.models.decoding import build_generate_fn
    from vivqa_tpu_torch.pipelines import generative_vqa_pipeline as gvp
    from vivqa_tpu_torch.pipelines.generative_training_pipeline import \
        batch_to_device
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import (TrainState, generative_loss_fn,
                                             make_train_step)
    pipe = gvp.GenerativeVQAPipeline(_gen_cli_config(tmp_path))
    data, model = pipe._setup()
    batch = batch_to_device(next(iter(data.train_loader)),
                            torch.device("cuda"))
    state = TrainState.create(model, create_optimizer(
        OptimizerConfig(), model))
    step = make_train_step(generative_loss_fn())
    generate = build_generate_fn(model, pipe._decode_cfg(model))
    step(state, batch)
    generate(batch["pixel_values"], batch["question_ids"],
             batch["question_mask"])
    torch.cuda.synchronize()

    def counted(fn):
        fa.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not e.is_user_annotation:
                kernels[e.name] = kernels.get(e.name, 0) + 1
        return out, dict(fa.launch_counts), fa.attention_kernel_counts(
            kernels)
    _, launches, seen = counted(lambda: step(state, batch))
    want = {"flash_attn_fwd": 0, "flash_attn_fwd_lse": 5,
            "flash_attn_bwd_dq": 5, "flash_attn_bwd_dkv": 5}
    assert launches == want and seen == {**want, "library": []}
    (seqs, _), launches, seen = counted(lambda: generate(
        batch["pixel_values"], batch["question_ids"],
        batch["question_mask"]))
    ended = (seqs == model.config.eos_token_id)
    steps = int(ended.int().argmax(1).max()) + 1 if bool(
        ended.any(1).all()) else seqs.shape[1]
    want = {"flash_attn_fwd": 3 + 2 * steps, "flash_attn_fwd_lse": 0,
            "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}
    assert launches == want and seen == {**want, "library": []}


# -- the MoE ablation study's shapes ------------------------------------------
# (B, H, Lq, Lk, D, mask kind): the multimodal expert's single key (each
# row's one valid key beside 63 empty columns of the 64-key tile, at the
# CLI default's head dim 32), the tokens' attention to 8 mask tokens and
# to 9 scene slots (a 64-key dK/dV block holding 8 or 9 keys), slot
# queries against the 80 fused tokens, the 88-token joint encoder, the
# vision/text experts at head dim 32, and the cross-attention fusion's
# text-to-image call under the query-side mask t2v (padded question rows
# fully masked, the mask not stride-0 over keys) and image-to-text v2t
ABL_CASES = [
    (4, 8, 80, 1, 32, None),
    (4, 8, 80, 8, 64, None),
    (4, 8, 80, 9, 64, None),
    (4, 8, 8, 80, 64, None),
    (4, 8, 21, 80, 64, None),
    (4, 8, 88, 88, 64, None),
    (4, 8, 80, 80, 32, None),
    (6, 4, 64, 16, 64, "t2v"),
    (6, 4, 16, 64, 64, "v2t"),
]


def _abl_mask(kind, B, seed=0):
    """The cross-attention fusion's masks for questions of 3-64 tokens
    (one of 64, so that not every row of every batch is padded)."""
    from vivqa_tpu_torch.models.layers import make_attention_mask
    lens = np.random.RandomState(seed).randint(3, 65, B)
    lens[0] = 64
    t_mask = torch.from_numpy(padding_mask(lens, 64))
    v_mask = torch.ones(B, 16, dtype=torch.int32)
    if kind == "t2v":
        return make_attention_mask(t_mask, v_mask).cuda()
    return make_attention_mask(v_mask, t_mask).cuda()


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", ABL_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ablation_shapes_match_plain_versions(case, dtype, rate):
    """The serving forward and the three training kernels at the study's
    new shapes against their plain versions, forward and backward."""
    _need_card()
    B, H, Lq, Lk, D, kind = case
    gen = torch.Generator().manual_seed(13)
    q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
                   for L in (Lq, Lk, Lk, Lq))
    mask = None if kind is None else _abl_mask(kind, B)
    if kind == "t2v":
        keyless = int((~mask.any(-1)).sum())
        assert mask.shape == (B, 1, Lq, Lk) and keyless > 0
        assert mask.expand(B, 1, Lq, Lk).stride(3) != 0
    got = fa.flash_attention_cuda(q, k, v, mask)
    key = fa.dropout_key(2468, 3)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, False, rate, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, False,
                                        rate, key)
    want = fa.attention_reference(q, k, v, mask)
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        q, k, v, mask, False, rate, key)
    grads_ref = fa.attention_backward_reference(q, k, v, o, m, l, do, mask,
                                                False, rate, key)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _assert_rel(o, o_ref, TOL[dtype], "o")
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == dtype and g.shape == ref.shape
        assert torch.isfinite(g).all(), name
        _assert_rel(g, ref, GRAD_TOL[dtype], name)


def test_dropout_masks_on_card_follow_their_law():
    """The randomness of training forwards on a CUDA generator, drawn as
    ``TrainState.step_generator`` and ``DropoutRNG`` draw it: each
    step's ``DropoutRNG`` reads its seed from the generator's initial
    seed and Philox offset, then moves the offset on by 4; elementwise
    masks come from the generator.

    - each mask keeps 1 - p of its units within 5 binomial standard
      errors;
    - two layers' masks in one forward, and one layer's masks at two
      consecutive steps, agree on p^2 + (1 - p)^2 of the units, the rate
      of independent masks, within 5 standard errors;
    - the attention calls' ``dropout_key(seed, n)`` are distinct across
      the calls of a forward and across steps."""
    _need_card()
    from vivqa_tpu_torch.models.layers import _SEED_MIX, DropoutRNG, dropout
    from vivqa_tpu_torch.train.state import fold_in
    p, N, steps, calls = 0.1, 1 << 20, 4, 64
    x = torch.ones(N, device="cuda")
    gen = torch.Generator(device="cuda")
    masks, keys, seeds = [], [], []
    for step in range(steps):
        gen.manual_seed(fold_in(42, step))
        offset = gen.get_offset()
        rng = DropoutRNG(gen)
        assert gen.get_offset() == offset + 4
        assert rng.seed == (gen.initial_seed() * _SEED_MIX + offset) % 2 ** 64
        seeds.append(rng.seed)
        masks.append([dropout(x, p, rng) != 0 for _ in range(2)])
        keys += [rng.attention_key() for _ in range(calls)]
    assert len(set(seeds)) == steps
    assert len(set(keys)) == steps * calls

    def within(frac, want):
        return abs(frac - want) <= 5 * (want * (1 - want) / N) ** 0.5

    for step_masks in masks:
        for mask in step_masks:
            assert within(float(mask.float().mean()), 1 - p)
    same = p * p + (1 - p) ** 2
    for step in range(steps):
        a, b = masks[step]
        assert within(float((a == b).float().mean()), same), step
        if step:
            prev = masks[step - 1][0]
            assert within(float((a == prev).float().mean()), same), step


# -- the knowledge (RAG) path --------------------------------------------------
# KnowledgeAttention: one query over K = 5 retrieved contexts under the
# knowledge mask (B, 1, 1, 5), rows keeping 5, 4, ... 0 contexts (a
# fully masked row: the mean of the values); the generative decoder's
# cross-attention over 113 fused tokens + 5 contexts = 118 keys under the
# concatenated memory mask, teacher-forced (32 queries) and in decode
# (one query, at the greedy and beam rows of a generate at batch 16).
RAG_K = 5
RAG_CASES = [  # (B, H, Lq, Lk, D, mask kind)
    (6, 8, 1, RAG_K, 64, "knowledge"),
    (128, 8, 1, RAG_K, 64, "knowledge"),
    (4, 8, 32, 118, 64, "memory"),
    (6, 8, 1, 118, 64, "memory"),
    (64, 8, 1, 118, 64, "memory"),
]


def _knowledge_mask(kind, B, Lk, seed=0):
    """The masks the models build: make_attention_mask(ones, knowledge
    mask) for KnowledgeAttention, make_attention_mask(None, [fusion mask;
    knowledge mask]) for the decoder, the fusion mask of 49 patch tokens
    and 64 question tokens of which 3-64 are real."""
    from vivqa_tpu_torch.models.layers import make_attention_mask
    know = torch.from_numpy(padding_mask(
        [RAG_K - b % (RAG_K + 1) for b in range(B)], RAG_K))
    if kind == "knowledge":
        return make_attention_mask(torch.ones(B, 1, dtype=torch.int32),
                                   know).cuda()
    lens = np.random.RandomState(seed).randint(3, 65, B)
    memory = torch.cat([torch.ones(B, 49, dtype=torch.int32),
                        torch.from_numpy(padding_mask(lens, 64)), know], 1)
    assert memory.shape[1] == Lk
    return make_attention_mask(None, memory).cuda()


@pytest.mark.parametrize("rate", [0.0, 0.05], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", RAG_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_knowledge_shapes_match_plain_versions(case, dtype, rate):
    """The serving forward and the three training kernels at the knowledge
    path's shapes against their plain versions, forward and backward:
    single-query training calls, keyless rows, and 118 keys (two 64-key
    tiles, the second 54 wide) under a mask that is a concatenation, not
    a stride-0 view."""
    _need_card()
    B, H, Lq, Lk, D, kind = case
    gen = torch.Generator().manual_seed(17)
    q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
                   for L in (Lq, Lk, Lk, Lq))
    mask = _knowledge_mask(kind, B, Lk)
    assert mask.shape == (B, 1, 1, Lk) and mask.stride(3) == 1
    keyless = int((~mask.any(-1)).sum())
    assert keyless == (B // (RAG_K + 1) if kind == "knowledge" else 0)
    got = fa.flash_attention_cuda(q, k, v, mask)
    key = fa.dropout_key(2470, 5)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, False, rate, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, False,
                                        rate, key)
    want = fa.attention_reference(q, k, v, mask)
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        q, k, v, mask, False, rate, key)
    grads_ref = fa.attention_backward_reference(q, k, v, o, m, l, do, mask,
                                                False, rate, key)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _assert_rel(o, o_ref, TOL[dtype], "o")
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == dtype and g.shape == ref.shape
        assert torch.isfinite(g).all(), name
        _assert_rel(g, ref, GRAD_TOL[dtype], name)


def knowledge_masks_at_mapping_end():
    """The four kernels at the knowledge shapes (5 and 118 keys) with each
    mask stored so that its last byte is the last mapped byte (see
    ``masks_at_mapping_end``): a read past the last key faults. Runs in a
    process of its own."""
    for B, H, Lq, Lk, D, kind in RAG_CASES[::2] + RAG_CASES[3:4]:
        for dtype in DTYPES:
            gen = torch.Generator().manual_seed(19)
            q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to(
                "cuda", dtype) for L in (Lq, Lk, Lk, Lq))
            mask = _knowledge_mask(kind, B, Lk)
            stored = _bytes_before_unmapped(mask.numel()).view(torch.bool)
            mask = stored.view(mask.shape).copy_(mask)
            o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask)
            grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask)
            served = fa.flash_attention_cuda(q, k, v, mask)
            torch.cuda.synchronize()
            want = fa.attention_backward_reference(q, k, v, o, m, l, do,
                                                   mask)
            what = f"{B}x{Lq}x{Lk} {dtype}"
            _assert_rel(served, fa.attention_reference(q, k, v, mask),
                        TOL[dtype], f"{what} serving o")
            for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
                _assert_rel(got, ref, GRAD_TOL[dtype], f"{what} {name}")
    print("knowledge masks at the mapping's end: ok", flush=True)


def test_kernels_read_no_knowledge_mask_byte_past_the_last_key():
    """``knowledge_masks_at_mapping_end`` in a child process, which must
    finish cleanly (the 118-key mask's last row ends inside the second
    64-key tile, the 5-key one inside the first)."""
    _need_card()
    import os
    import subprocess
    import sys
    from pathlib import Path
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tests), str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-c",
         "import test_torch_gpu as t; t.knowledge_masks_at_mapping_end()"],
        cwd=tests, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "ok" in run.stdout, (
        f"rc {run.returncode}\n{run.stdout[-2000:]}\n{run.stderr[-4000:]}")


def test_knowledge_train_step_on_card_matches_cpu():
    """``test_train_step_on_card_matches_cpu`` with KnowledgeAttention: a
    small flagship-shaped model with K = 5 contexts of width 64 in the
    batch (rows with 5, 4, ... 0 contexts), two steps on the card and on
    the CPU from the same weights: loss and grad_norm within 2%, every
    parameter within 3 learning rates; 10 + 1 launches of each training
    kernel a step, and a validation forward on the card within 5% of
    the CPU's largest logit with 11 forward launches."""
    _need_card()
    from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                                  SchedulerConfig,
                                                  create_optimizer)
    from vivqa_tpu_torch.train.state import (TrainState,
                                             classification_loss_fn,
                                             make_train_step)
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=2,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=128,
                                  num_layers=2, num_heads=2, max_length=16,
                                  dropout=0.0),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=512,
                               num_heads=8, num_layers=2, dropout=0.0),
        moe=PC.MoEModelConfig(use_moe=True, num_experts=4, top_k=2,
                              expert_hidden_dim=256),
        knowledge=PC.KnowledgeModelConfig(use_knowledge=True,
                                          knowledge_dim=64,
                                          num_retrieved=RAG_K),
        head=PC.AnswerHeadConfig(dropout=0.0), num_answers=32)
    rs = np.random.RandomState(0)
    mask = torch.from_numpy(padding_mask(rs.randint(1, 17, 8), 16))
    batch = {"pixel_values": torch.from_numpy(
                 rs.standard_normal((8, 64, 64, 3)).astype(np.float32)),
             "input_ids": torch.from_numpy(rs.randint(4, 100, (8, 16))) * mask,
             "attention_mask": mask,
             "labels": torch.from_numpy(rs.randint(0, 32, 8)),
             "knowledge_embeddings": torch.from_numpy(
                 rs.standard_normal((8, RAG_K, 64)).astype(np.float32)),
             "knowledge_mask": torch.from_numpy(padding_mask(
                 [RAG_K - b % (RAG_K + 1) for b in range(8)], RAG_K)).long()}
    lr = 1e-3
    runs = {}
    for dev in ("cpu", "cuda"):
        model = create_vqa_model(cfg, device=dev,
                                 generator=torch.Generator().manual_seed(1))
        model.moe.dropout = 0.0
        b = {n: t.to(dev) for n, t in batch.items()}
        fa.reset_launch_counts()
        with torch.no_grad():
            logits = model(b["pixel_values"], b["input_ids"],
                           b["attention_mask"],
                           knowledge_embeddings=b["knowledge_embeddings"],
                           knowledge_mask=b["knowledge_mask"])["logits"]
        if dev == "cuda":
            assert fa.launch_counts["flash_attn_fwd"] == 11
        opt = create_optimizer(OptimizerConfig(learning_rate=lr), model,
                               SchedulerConfig(warmup_steps=1,
                                               total_steps=10))
        state = TrainState.create(model, opt, seed=0)
        step = make_train_step(classification_loss_fn())
        fa.reset_launch_counts()
        metrics = [step(state, b)[1] for _ in range(2)]
        runs[dev] = (logits.float().cpu(),
                     [float(m["loss"]) for m in metrics],
                     [float(m["grad_norm"]) for m in metrics],
                     {n: p.detach().cpu()
                      for n, p in model.named_parameters()})
        if dev == "cuda":
            assert fa.launch_counts["flash_attn_fwd"] == 0
            for name in ("flash_attn_fwd_lse", "flash_attn_bwd_dq",
                         "flash_attn_bwd_dkv"):
                assert fa.launch_counts[name] == 2 * 11, fa.launch_counts
    (clog, cl, cn, cp), (glog, gl, gn, gp) = runs["cpu"], runs["cuda"]
    assert float((glog - clog).abs().max()) <= 0.05 * float(
        clog.abs().max())
    np.testing.assert_allclose(gl, cl, rtol=2e-2)
    np.testing.assert_allclose(gn, cn, rtol=2e-2)
    for name, p in cp.items():
        assert float((gp[name] - p).abs().max()) <= 3 * lr, name


# -- the trainer's extras on the card ------------------------------------------
def _small_trainer_model(dropout: float):
    cfg = PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(image_size=64, patch_size=16,
                                      hidden_dim=128, num_layers=2,
                                      num_heads=2),
        text=PC.TextEncoderConfig(vocab_size=200, hidden_dim=128,
                                  num_layers=2, num_heads=2, max_length=24,
                                  dropout=dropout),
        fusion=PC.FusionConfig(fusion_type="mcan", hidden_dim=128,
                               num_heads=2, num_layers=1, dropout=dropout),
        head=PC.AnswerHeadConfig(dropout=dropout), num_answers=20)
    return create_vqa_model(cfg, device="cuda",
                            generator=torch.Generator().manual_seed(0))


def _small_trainer_batch(B=8):
    rs = np.random.RandomState(3)
    mask = padding_mask(rs.randint(3, 25, B), 24)
    return {"pixel_values": torch.from_numpy(
                rs.rand(B, 64, 64, 3).astype(np.float32)).cuda(),
            "input_ids": torch.from_numpy(
                rs.randint(4, 199, (B, 24)) * mask).long().cuda(),
            "attention_mask": torch.from_numpy(mask).long().cuda(),
            "labels": torch.from_numpy(rs.randint(0, 20, B)).long().cuda()}


def test_checkpointed_step_replays_dropout_on_a_cuda_generator():
    """On a CUDA generator (its Philox seed and offset, which the
    attention dropout's key is read from), the checkpointed forward's
    recompute draws the masks of the first pass: the loss and every
    gradient equal the plain step's within the card's own spread (three
    plain steps), and the checkpointed step launches the forward with
    stats twice per attention call (none of the serving forward), dQ and
    dK/dV once. Without the generator's restore, the gradients differ."""
    _need_card()
    from vivqa_tpu_torch.train.trainer import TrainerConfig, VQATrainer
    model = _small_trainer_model(0.1)
    batch = _small_trainer_batch()
    calls = 2 + 2 + 3          # ViT, text, MCAN (1 enc, 1 dec, 1 cross)

    def step(checkpointing):
        fn = VQATrainer(TrainerConfig(gradient_checkpointing=checkpointing),
                        model)._loss_fn()
        model.train()
        for p in model.parameters():
            p.grad = None
        gen = torch.Generator(device="cuda").manual_seed(5)
        loss, _ = fn(model, batch, gen)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()}
    plain = [step(False) for _ in range(3)]
    fa.reset_launch_counts()
    loss, grads = step(True)
    assert dict(fa.launch_counts) == {
        "flash_attn_fwd": 0, "flash_attn_fwd_lse": 2 * calls,
        "flash_attn_bwd_dq": calls, "flash_attn_bwd_dkv": calls}
    for n, g in grads.items():
        spread = max(float((a[1][n] - b[1][n]).abs().max())
                     for a in plain for b in plain)
        assert float((g - plain[0][1][n]).abs().max()) <= 2 * spread, n
    assert float((loss - plain[0][0]).abs()) <= 2 * max(
        float((a[0] - b[0]).abs()) for a in plain for b in plain)

    gen = torch.Generator(device="cuda").manual_seed(5)
    for p in model.parameters():
        p.grad = None
    naive = torch.utils.checkpoint.checkpoint(
        lambda *a: model(*a, generator=gen), batch["pixel_values"],
        batch["input_ids"], batch["attention_mask"], use_reentrant=False)
    torch.nn.functional.cross_entropy(naive["logits"],
                                      batch["labels"]).backward()
    assert any(not torch.equal(p.grad, plain[0][1][n])
               for n, p in model.named_parameters() if p.grad is not None)


def test_device_monitor_reads_the_card():
    """The resource monitor's device sample: the card's used memory
    (mem_get_info) grows with an allocation of 1 GiB and the allocator's
    own count (memory_stats) holds it."""
    _need_card()
    from vivqa_tpu_torch.resources import DeviceMemoryMonitor
    m = DeviceMemoryMonitor(interval=1.0, warning=200.0, critical=300.0)
    before = m.poll_once()
    block = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    after = m.poll_once()
    del block
    assert 0 < before.percent < after.percent < 100
    d0, d1 = before.detail["0"], after.detail["0"]
    assert d1["used_gb"] - d0["used_gb"] >= 1.0
    assert d1["allocated_gb"] - d0["allocated_gb"] >= 1.07
    assert d1["limit_gb"] > 70


# -- the model zoo ------------------------------------------------------------
ZOO_CASES = [  # (B, H, Lq, Lk, D, mask kind)
    (8, 8, 32, 32, 64, None),             # Q-Former self-attention
    (8, 8, 32, 50, 64, None),             # Q-Former to the ViT's tokens
    (32, 8, 32, 49, 64, None),            # Q-Former to Swin's or ResNet's
    (32, 8, 32, 64, 64, "key"),           # Q-Former to the question
    (8, 8, 115, 115, 64, "stream"),       # single-stream [CLS; 50; 64]
    (8, 4, 32, 784, 64, None),            # VisionTokenEmbedding, 28 x 28
]


def _zoo_mask(kind, B, Lq, Lk, seed=0):
    """The Q-Former's make_attention_mask(ones, question mask) and
    single-stream's query-AND-key mask over [1 CLS + 50 image tokens, all
    real; 64 question tokens, 3-64 real]."""
    from vivqa_tpu_torch.models.layers import make_attention_mask
    if kind is None:
        return None
    lens = np.random.RandomState(seed).randint(3, 65, B)
    question = torch.from_numpy(padding_mask(lens, 64))
    if kind == "key":
        return make_attention_mask(torch.ones(B, Lq, dtype=torch.int32),
                                   question).cuda()
    stream = torch.cat([torch.ones(B, Lk - 64, dtype=torch.int32),
                        question], 1)
    return make_attention_mask(stream, stream).cuda()


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("case", ZOO_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_zoo_shapes_match_plain_versions(case, dtype, rate):
    """The serving forward and the three training kernels at the zoo's
    new shapes against their plain versions, forward and backward: the
    Q-Former's 32 queries over 32, 49, 50 and 64 keys, single-stream's
    115 tokens (two 64-query tiles, the second 51 wide) under its padded
    query rows, and 784 keys over 4 heads (13 key tiles)."""
    _need_card()
    B, H, Lq, Lk, D, kind = case
    gen = torch.Generator().manual_seed(23)
    q, k, v, do = (torch.randn(B, H, L, D, generator=gen).to("cuda", dtype)
                   for L in (Lq, Lk, Lk, Lq))
    mask = _zoo_mask(kind, B, Lq, Lk)
    got = fa.flash_attention_cuda(q, k, v, mask)
    key = fa.dropout_key(2512, 3)
    o, m, l = fa.flash_attention_fwd_lse_cuda(q, k, v, mask, False, rate, key)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, m, l, do, mask, False,
                                        rate, key)
    want = fa.attention_reference(q, k, v, mask)
    o_ref, m_ref, l_ref = fa.attention_forward_lse_reference(
        q, k, v, mask, False, rate, key)
    grads_ref = fa.attention_backward_reference(q, k, v, o, m, l, do, mask,
                                                False, rate, key)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _assert_rel(o, o_ref, TOL[dtype], "o")
    torch.testing.assert_close(m, m_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, l_ref, atol=1e-5, rtol=1e-5)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert g.dtype == dtype and g.shape == ref.shape
        assert torch.isfinite(g).all(), name
        _assert_rel(g, ref, GRAD_TOL[dtype], name)


def _zoo_config(visual, fusion, moe_type, use_moe=True):
    """A zoo model at width 64 (head dim 32 for the kernels), 32 px."""
    vis = dict(image_size=32, patch_size=16, hidden_dim=64, num_layers=1,
               num_heads=2, swin_embed_dim=32, swin_depths=(2, 2),
               swin_heads=(2, 4), swin_window=4, resnet_width=32,
               resnet_stages=(1, 1))
    return PC.VQAModelConfig(
        visual=PC.VisualEncoderConfig(backbone=visual, **vis),
        text=PC.TextEncoderConfig(vocab_size=100, hidden_dim=64,
                                  num_layers=1, num_heads=2, max_length=16),
        fusion=PC.FusionConfig(fusion_type=fusion, hidden_dim=64,
                               num_heads=2, num_layers=1,
                               num_query_tokens=8),
        moe=PC.MoEModelConfig(use_moe=use_moe, moe_type=moe_type,
                              num_experts=4, top_k=2, expert_hidden_dim=64),
        num_answers=10)


@pytest.mark.parametrize("zoo", [("swin", "qformer", "sparse"),
                                 ("resnet", "single_stream", "hierarchical"),
                                 ("clip", "mutan", "standard")], ids=str)
def test_zoo_model_on_card_matches_cpu(zoo):
    """Each zoo path's model: its f32 logits on the card against the same
    weights on the CPU (to 1e-4 of the largest; TF32 is off), its
    launches a forward (the text layer's and the fusion's, none from
    Swin or ResNet), and the sparse layer's dropped fraction equal."""
    _need_card()
    from vivqa_tpu_torch.device import resolve_device
    resolve_device("cuda")
    cfg = _zoo_config(*zoo)
    cfg = cfg.replace(visual=cfg.visual.replace(dtype="float32"),
                      text=cfg.text.replace(dtype="float32"),
                      dtype="float32")
    cpu = create_vqa_model(cfg, device="cpu")
    card = create_vqa_model(cfg, device="cuda")
    for m in (cpu, card):       # the forced-bf16 fusions and head in f32
        for mod in m.modules():
            if getattr(mod, "dtype", None) == torch.bfloat16:
                mod.dtype = torch.float32
    rs = np.random.RandomState(3)
    mask = torch.from_numpy(padding_mask([16, 9, 3], 16)).long()
    args = (torch.from_numpy(rs.rand(3, 32, 32, 3).astype(np.float32)),
            torch.from_numpy(rs.randint(4, 100, (3, 16))) * mask, mask)
    before = fa.launch_counts["flash_attn_fwd"]
    with torch.no_grad():
        got = card(*(a.cuda() for a in args))
        want = cpu(*args)
    calls = {"qformer": 3 + 1, "single_stream": 1 + 1, "mutan": 1 + 1}[
        zoo[1]]
    assert fa.launch_counts["flash_attn_fwd"] - before == calls
    scale = float(want["logits"].abs().max())
    torch.testing.assert_close(got["logits"].cpu(), want["logits"],
                               atol=1e-4 * scale, rtol=0)
    if zoo[2] == "sparse":
        assert float(got["moe_metrics"]["dropped_token_fraction"]) == \
            float(want["moe_metrics"]["dropped_token_fraction"])


def test_swin_window_attention_on_card_matches_cpu():
    """``swin.window_attention`` (outside the kernels) in bf16 on the card
    against the CPU, shifted windows, forward and backward."""
    _need_card()
    from vivqa_tpu_torch.models.encoders.swin import (_shift_attn_mask,
                                                      window_attention)
    gen = torch.Generator().manual_seed(29)
    nW, h, L, hd = 4, 2, 16, 32
    q, k, v, do = (torch.randn(2 * nW, h, L, hd, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    bias = torch.randn(h, L, L, generator=gen)
    mask = torch.from_numpy(_shift_attn_mask(8, 8, 4, 2))
    outs = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        o = window_attention(*leaves, bias.to(dev), mask.to(dev))
        outs[dev] = [o] + list(torch.autograd.grad(o, leaves, do.to(dev)))
    for name, a, b in zip(("o", "dq", "dk", "dv"), outs["cuda"],
                          outs["cpu"]):
        _assert_rel(a.cpu(), b, 2e-2, name)
