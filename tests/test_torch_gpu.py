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
    q = torch.randn(1, 1, 4, 32, device="cuda")
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
    q = torch.randn(1, 1, 4, 32, device="cuda")
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
