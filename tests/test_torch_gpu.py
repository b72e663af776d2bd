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
# order only; in bf16 the plain version also rounds the probabilities to
# bf16 before P.V, the kernel does not (a few bf16 ulps of outputs ~1)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
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
