"""Multi-head latent attention (MLA), as DeepSeek-V3 and Kimi-VL's
language model compute it with no query compression (``q_lora_rank``
null), after HF's ``DeepseekV3Attention``:

- q = W_q x, each head split into ``qk_nope_head_dim`` + ``qk_rope_head_dim``;
- [c_kv, k_pe] = W_kva x: a latent of ``kv_lora_rank`` and one rotary key
  head shared by every head; c_kv is RMS-normalised (``ln_kv``);
- [k_nope, v] = W_kvb c_kv, per head;
- the rotary embedding (``layers.apply_rotary``) on q_pe and k_pe;
- causal softmax attention of q = [q_nope, q_pe] over k = [k_nope, k_pe]
  (head dim nope + rope) at scale 1/sqrt(nope + rope), onto v (head dim
  ``v_head_dim``), then W_o.

The core runs on ``torch.nn.functional.scaled_dot_product_attention``
with ``is_causal``, called directly: q and k are wider than v, which no
kernel of ``ops/flash_attention.py`` takes. Every sequence is its real
tokens followed by padding, so no real query reaches a padded key under
the causal mask and the core needs no other mask.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.layers import Dense, RMSNorm, apply_rotary


class MultiHeadLatentAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, kv_lora_rank: int,
                 qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-5):
        super().__init__()
        self.num_heads = num_heads
        self.nope, self.rope, self.vdim = (qk_nope_head_dim,
                                           qk_rope_head_dim, v_head_dim)
        self.rank = kv_lora_rank
        self.scale = (qk_nope_head_dim + qk_rope_head_dim) ** -0.5
        H = num_heads
        self.q_proj = Dense(dim, H * (qk_nope_head_dim + qk_rope_head_dim),
                            bias=False, dtype=dtype)
        self.kv_a_proj = Dense(dim, kv_lora_rank + qk_rope_head_dim,
                               bias=False, dtype=dtype)
        self.ln_kv = RMSNorm(kv_lora_rank, dtype, eps)
        self.kv_b_proj = Dense(kv_lora_rank,
                               H * (qk_nope_head_dim + v_head_dim),
                               bias=False, dtype=dtype)
        self.o_proj = Dense(H * v_head_dim, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
        """x (B, L, D), ``angles`` (L, rope) from ``layers.rotary_table``
        -> (B, L, D)."""
        B, L, _ = x.shape
        H = self.num_heads
        q = self.q_proj(x).view(B, L, H, self.nope + self.rope) \
            .transpose(1, 2)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj(x).split([self.rank, self.rope], dim=-1)
        kv = self.kv_b_proj(self.ln_kv(c_kv)).view(
            B, L, H, self.nope + self.vdim).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.vdim], dim=-1)
        k_pe = apply_rotary(k_pe[:, None], angles)
        q = torch.cat([q_nope, apply_rotary(q_pe, angles)], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, H, L, self.rope)], dim=-1)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           scale=self.scale)
        return self.o_proj(o.transpose(1, 2).reshape(B, L, H * self.vdim))
