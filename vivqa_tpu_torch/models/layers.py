"""Shared transformer building blocks (counterpart of
vivqa_tpu/models/layers.py).

Names follow the flax modules (``self_attn``/``cross_attn`` with
``query/key/value/out``, MLPs with ``wi``/``wo``, LayerNorms ``ln*``) so
``from_jax.py`` maps a Flax param tree onto these modules by path.

Numerics follow flax, not torch's defaults:
- every module has a compute ``dtype`` and casts its inputs and its f32
  params to it explicitly (no autocast); params stay float32;
- ``LayerNorm`` takes its statistics in f32 with flax's fast variance
  (E[x^2] - E[x]^2, clipped at 0) and eps 1e-6, then casts to its dtype;
- ``nn.gelu`` in flax is the tanh form ("gelu_tanh").

All attention goes through ``vivqa_tpu_torch.ops.flash_attention``: the
plain version for CPU tensors, the CUDA kernel for tensors on the card.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.ops.embedding import Embed
from vivqa_tpu_torch.ops.flash_attention import flash_attention


def to_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gelu_exact(x):
    return F.gelu(x, approximate="none")


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"gelu_tanh": gelu_tanh, "gelu": _gelu_exact,
               "quick_gelu": _quick_gelu, "relu": F.relu, "silu": F.silu}


def to_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation '{name}' "
                         f"(choices: {tuple(ACTIVATIONS)})")
    return ACTIVATIONS[name]


class Dense(nn.Linear):
    """``nn.Dense``/``nn.DenseGeneral`` counterpart: f32 params, the
    product in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, output in dtype
    (``None``: the input's dtype)."""

    def __init__(self, dim: int, dtype: torch.dtype | None = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype or x.dtype)


class MlpBlock(nn.Module):
    """Transformer feed-forward block: wi -> act -> wo (dropout is
    training-only and waits for the training slice)."""

    def __init__(self, dim: int, d_ff: int, out_dim: int = 0,
                 activation: Callable = gelu_tanh,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.activation = activation
        self.wi = Dense(dim, d_ff, dtype=dtype)
        self.wo = Dense(d_ff, out_dim or dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.activation(self.wi(x)))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (and the ``decode=False``
    form of ``CachedCrossAttention``): query/key/value projections to
    (H, D/H), attention, ``out`` projection back to the query width.

    ``query``/``key``/``value`` hold the flattened DenseGeneral kernels
    (H*Dh, D_in); ``out`` holds (D, H*Dh).
    """

    def __init__(self, dim: int, num_heads: int, kv_dim: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by "
                             f"{num_heads} heads")
        kv_dim = kv_dim or dim
        self.num_heads = num_heads
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(kv_dim, dim, dtype=dtype)
        self.value = Dense(kv_dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, Lq, D = x.shape
        Lk, H = context.shape[1], self.num_heads
        # (B, L, H, Dh) viewed as (B, H, L, Dh): the kernel reads it in place
        q = self.query(x).view(B, Lq, H, D // H).transpose(1, 2)
        k = self.key(context).view(B, Lk, H, D // H).transpose(1, 2)
        v = self.value(context).view(B, Lk, H, D // H).transpose(1, 2)
        y = flash_attention(q, k, v, mask)
        return self.out(y.transpose(1, 2).reshape(B, Lq, D))


# decode=False form: the same module (the K/V cache waits for the
# generative slice, ROADMAP.md Queue A item 11)
CachedCrossAttention = MultiHeadDotProductAttention


class EncoderLayer(nn.Module):
    """Self-attention encoder layer: pre-LN (default, optional LayerScale)
    or post-LN (BERT layout)."""

    def __init__(self, dim: int, num_heads: int, d_ff: int,
                 dtype: torch.dtype = torch.bfloat16, norm_style: str = "pre",
                 activation: str = "gelu_tanh",
                 layer_scale_init: float = 0.0):
        super().__init__()
        self.norm_style = norm_style
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads,
                                                      dtype=dtype)
        self.mlp = MlpBlock(dim, d_ff, activation=to_activation(activation),
                            dtype=dtype)
        self.ln1 = LayerNorm(dim, dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.ls1_scale = self.ls2_scale = None
        if layer_scale_init > 0 and norm_style != "post":
            self.ls1_scale = nn.Parameter(torch.full((dim,), layer_scale_init))
            self.ls2_scale = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_style == "post":
            x = self.ln1(x + self.self_attn(x, x, mask))
            return self.ln2(x + self.mlp(x))
        h = self.ln1(x)
        y = self.self_attn(h, h, mask)
        if self.ls1_scale is not None:
            y = y * self.ls1_scale.to(y.dtype)
        x = x + y
        y = self.mlp(self.ln2(x))
        if self.ls2_scale is not None:
            y = y * self.ls2_scale.to(y.dtype)
        return x + y


class CrossAttentionLayer(nn.Module):
    """Pre-LN layer: self-attention, cross-attention to a context, MLP
    (``decode=False`` form)."""

    def __init__(self, dim: int, num_heads: int, d_ff: int,
                 context_dim: int = 0, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.self_attn = MultiHeadDotProductAttention(dim, num_heads,
                                                      dtype=dtype)
        self.ln_cross = LayerNorm(dim, dtype)
        self.cross_attn = CachedCrossAttention(dim, num_heads,
                                               kv_dim=context_dim or dim,
                                               dtype=dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, d_ff, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.ln1(x)
        x = x + self.self_attn(y, y, self_mask)
        x = x + self.cross_attn(self.ln_cross(x), context, cross_mask)
        return x + self.mlp(self.ln2(x))


def pool_sequence(hidden: torch.Tensor, mask: Optional[torch.Tensor],
                  pooling: str) -> torch.Tensor:
    """Pool (B, L, D) -> (B, D). pooling in {cls, mean, max}."""
    if pooling == "cls":
        return hidden[:, 0]
    if mask is None:
        mask = torch.ones(hidden.shape[:2], dtype=hidden.dtype,
                          device=hidden.device)
    m = mask[..., None].to(hidden.dtype)
    if pooling == "mean":
        return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-6)
    if pooling == "max":
        neg = torch.finfo(hidden.dtype).min
        return torch.where(m > 0, hidden, neg).amax(dim=1)
    raise ValueError(f"unknown pooling: {pooling}")


def make_attention_mask(query_mask: Optional[torch.Tensor],
                        key_mask: Optional[torch.Tensor]
                        ) -> Optional[torch.Tensor]:
    """(B, 1, Lq, Lk) boolean mask from (B, Lq) and (B, Lk) padding masks:
    True where both the query and the key are real (flax's
    ``make_attention_mask`` with the default product pairing)."""
    if query_mask is None and key_mask is None:
        return None
    if query_mask is None:
        query_mask = torch.ones((key_mask.shape[0], 1), dtype=key_mask.dtype,
                                device=key_mask.device)
    if key_mask is None:
        key_mask = torch.ones((query_mask.shape[0], 1),
                              dtype=query_mask.dtype,
                              device=query_mask.device)
    return (query_mask[:, None, :, None] * key_mask[:, None, None, :]) != 0


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights in the spirit of the flax initialisers: Dense
    and Conv kernels normal with variance 1/fan_in (lecun), embedding and
    position tables normal(0.02), biases and the CLS token 0, LayerNorm
    scale 1, LayerScale gains left at their init value."""
    with torch.no_grad():
        for mod in module.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if isinstance(mod, Embed) or leaf == "pos_embed":
                    p.normal_(0.0, 0.02, generator=generator)
                elif isinstance(mod, LayerNorm):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf in ("bias", "cls_token") \
                        or leaf.startswith("experts_bias"):
                    p.zero_()
                elif leaf in ("ls1_scale", "ls2_scale"):
                    continue
                else:
                    # Linear (out, in), Conv (O, I, kh, kw), stacked experts
                    # (E, in, out): the input width is dim 1
                    fan_in = math.prod(p.shape[1:]) if p.dim() != 3 \
                        else p.shape[1]
                    p.normal_(0.0, 1.0 / math.sqrt(fan_in),
                              generator=generator)
