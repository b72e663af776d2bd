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

Attention goes through ``vivqa_tpu_torch.ops.flash_attention`` (the
plain version for CPU tensors, the CUDA kernels for tensors on the
card), with two exceptions that compute it as the JAX package does, f32
score products, a softmax and a product with v in the compute dtype,
because each adds a term to the scores that the kernels' boolean masks
cannot carry: Swin's window attention (a learned relative-position bias,
``encoders/swin.py``) and DeBERTa's disentangled attention (the
content-to-position and position-to-content terms,
``encoders/deberta.py``).

Training mode is flax's ``deterministic=False``: every module takes an
optional ``rng`` (a ``DropoutRNG``), and applies its dropouts only when
it is given one. ``VietnameseVQAModel`` makes it from the caller's
generator in ``train()`` mode and passes it down.

flax's ``decode=True`` (the generative decoder's cached steps) is a
method of its own, ``decode``, on the self-attention and the decoder
layer: the cache is not module state but buffers the caller owns
(``models/decoder.py:DecodeCache``) and passes in.

On a mesh whose 'model' axis splits them (``parallel/mesh.py``), the
attention and the MLP run Megatron's tensor-parallel form: q/k/v and
``wi`` are column-parallel (each rank holds H/m heads, or d_ff/m hidden
units, and the attention kernel sees the H/m heads), ``out`` and ``wo``
row-parallel with one all-reduce of the partial outputs, reduced in f32
and cast back. The replicated input enters through ``copy_to_model``. A
column-parallel bias stays whole in storage, as the JAX package places
it; each rank adds its slice, and the train step sums its gradient over
'model'. Dropout of a split activation draws the whole activation's mask
and keeps its slice, so the masks are the one-process ones.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.ops.embedding import Embed
from vivqa_tpu_torch.ops.flash_attention import dropout_key, flash_attention
from vivqa_tpu_torch.parallel.collectives import (Axis, copy_to_model,
                                                  reduce_from_model)

_SEED_MIX = 0x9E3779B97F4A7C15      # odd 64-bit constant (golden ratio)


def to_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gelu_exact(x):
    return F.gelu(x, approximate="none")


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class DropoutRNG:
    """The randomness of one training forward, from an explicit
    ``torch.Generator`` on the activations' device (never the global RNG).

    Elementwise dropout draws its keep masks from the generator. Attention
    dropout draws nothing on the device: call n of the forward gets
    ``dropout_key(seed, n)``, where the 64-bit ``seed`` is read from the
    generator's host-side state when this object is made (a CPU
    generator's next number; a CUDA generator's seed and Philox offset,
    which is then advanced), so no attention call waits on the card.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        if generator.device.type == "cuda":
            offset = generator.get_offset()
            generator.set_offset(offset + 4)
            self.seed = (generator.initial_seed() * _SEED_MIX + offset) \
                % 2 ** 64
        else:
            self.seed = int(torch.randint(0, 2 ** 62, (1,),
                                          generator=generator))
        self.attention_calls = 0

    def attention_key(self) -> int:
        key = dropout_key(self.seed, self.attention_calls)
        self.attention_calls += 1
        return key


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[DropoutRNG],
            split: Optional[tuple[int, Axis]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate) in x's dtype; the identity without ``rng``.
    ``split`` (dim, axis): x is this rank's slice along dim of an
    activation split over the axis; the whole mask is drawn and sliced."""
    if rng is None or rate == 0.0:
        return x
    shape = list(x.shape)
    if split is not None:
        dim, axis = split
        shape[dim] *= axis.size
    keep = torch.rand(shape, generator=rng.generator,
                      device=x.device) < 1.0 - rate
    if split is not None:
        n = x.shape[dim]
        keep = keep.narrow(dim, axis.rank * n, n)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


ACTIVATIONS = {"gelu_tanh": gelu_tanh, "gelu": _gelu_exact,
               "quick_gelu": _quick_gelu, "relu": F.relu, "silu": F.silu}


def to_activation(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation '{name}' "
                         f"(choices: {tuple(ACTIVATIONS)})")
    return ACTIVATIONS[name]


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Sinusoidal position table (length, dim), float32."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: (dim + 1) // 2])
    return table


def runs_split(module: nn.Module, sharded: set) -> bool:
    """For a module's ``use_mesh``: True when the rules split its
    ``TP_LEAVES`` (all that it has), False when none; raises on a mix."""
    present = set()
    for rel in module.TP_LEAVES:
        try:
            if module.get_parameter(rel) is not None:
                present.add(rel)
        except AttributeError:
            pass
    if sharded and sharded != present:
        raise NotImplementedError(
            f"{type(module).__name__}: only {sorted(sharded)} of "
            f"{sorted(present)} are split")
    return bool(sharded)


class Dense(nn.Linear):
    """``nn.Dense``/``nn.DenseGeneral`` counterpart: f32 params, the
    product in ``dtype``. ``split`` makes it this rank's column- or
    row-parallel part of a layer split over a mesh axis."""
    parallel: Optional[str] = None      # None | "column" | "row"
    axis: Optional[Axis] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def split(self, parallel: str, axis: Axis) -> set:
        """Run as the column- (weight rows split) or row-parallel (columns
        split) part; returns the leaves whose gradient is partial (the
        column-parallel bias, kept whole and used by its slice)."""
        self.parallel, self.axis = parallel, axis
        n = self.weight.shape[0]
        self.bias_rows = slice(axis.rank * n, (axis.rank + 1) * n)
        return {"bias"} if parallel == "column" and self.bias is not None \
            else set()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        if self.parallel == "row":
            y = reduce_from_model(F.linear(x, w), self.axis)
            return y if b is None else y + b
        if self.parallel == "column" and b is not None:
            b = b[self.bias_rows]
        return F.linear(x, w, b)


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


class RMSNorm(nn.Module):
    """RMSNorm (DeepSeek-V3's): x / sqrt(mean(x^2) + eps) with the
    statistics in f32, times the scale, output in dtype (``None``: the
    input's dtype)."""

    def __init__(self, dim: int, dtype: torch.dtype | None = torch.bfloat16,
                 eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (xf * self.weight.float()).to(self.dtype or x.dtype)


def rotary_table(positions: int, dim: int, theta: float) -> torch.Tensor:
    """(positions, dim) f32 angles of rotary embeddings, the frequencies
    repeated over both halves: angle[p, i] = p / theta^(2 (i mod dim/2) /
    dim) (HF's ``DeepseekV3RotaryEmbedding``, no scaling)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64)
                          / dim)
    angles = torch.arange(positions, dtype=torch.float64)[:, None] * inv
    return torch.cat([angles, angles], dim=-1).float()


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotary embedding of x (..., L, dim) at ``angles``
    (L, dim): the pairs (x[2i], x[2i+1]) are first laid out as halves
    (x[0::2], x[1::2]), then rotated as in ``rotate_half``; in f32,
    returned in x's dtype."""
    xf = x.float()
    xf = torch.cat([xf[..., 0::2], xf[..., 1::2]], dim=-1)
    half = xf.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * angles.cos() + rotated * angles.sin()).to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW activations: per sample and group,
    f32 statistics with flax's fast variance (E[x^2] - E[x]^2, clipped at
    0) and eps 1e-6, the per-channel scale and bias, output in dtype."""

    def __init__(self, channels: int, num_groups: int = 32,
                 dtype: torch.dtype = torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not divide into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        xf = x.float().reshape(B, G, C // G, -1)
        mean = xf.mean((2, 3), keepdim=True)
        var = torch.clamp((xf * xf).mean((2, 3), keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * \
            self.weight.float().view(1, G, C // G, 1)
        y = (xf - mean) * mul + self.bias.float().view(1, G, C // G, 1)
        return y.reshape(x.shape).to(self.dtype)


class MlpBlock(nn.Module):
    """Transformer feed-forward block: wi -> act -> dropout -> wo."""
    TP_LEAVES = ("wi.weight", "wo.weight")
    axis: Optional[Axis] = None

    def __init__(self, dim: int, d_ff: int, out_dim: int = 0,
                 activation: Callable = gelu_tanh,
                 dtype: torch.dtype = torch.bfloat16, dropout: float = 0.0):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.wi = Dense(dim, d_ff, dtype=dtype)
        self.wo = Dense(d_ff, out_dim or dim, dtype=dtype)

    def use_mesh(self, mesh, sharded: set) -> set:
        if not runs_split(self, sharded):
            return set()
        self.axis = mesh.model
        self.wo.split("row", mesh.model)
        return {f"wi.{n}" for n in self.wi.split("column", mesh.model)}

    def forward(self, x: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        split = None
        if self.axis is not None:
            x, split = copy_to_model(x, self.axis), (-1, self.axis)
        return self.wo(dropout(self.activation(self.wi(x)), self.dropout,
                               rng, split))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention``: query/key/value
    projections to (H, D/H), attention, ``out`` projection back to the
    query width.

    ``query``/``key``/``value`` hold the flattened DenseGeneral kernels
    (H*Dh, D_in); ``out`` holds (D, H*Dh). With an ``rng`` the attention
    probabilities drop at ``dropout_rate`` inside the kernel (flax's
    ``broadcast_dropout``: one mask per call for all rows and heads).

    Split over a mesh's 'model' axis (``use_mesh``), ``num_heads`` is
    this rank's H/m.
    """
    TP_LEAVES = ("query.weight", "key.weight", "value.weight", "out.weight")
    axis: Optional[Axis] = None

    def __init__(self, dim: int, num_heads: int, kv_dim: int = 0,
                 dtype: torch.dtype = torch.bfloat16,
                 dropout_rate: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden dim {dim} not divisible by "
                             f"{num_heads} heads")
        kv_dim = kv_dim or dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.query = Dense(dim, dim, dtype=dtype)
        self.key = Dense(kv_dim, dim, dtype=dtype)
        self.value = Dense(kv_dim, dim, dtype=dtype)
        self.out = Dense(dim, dim, dtype=dtype)

    def use_mesh(self, mesh, sharded: set) -> set:
        if not runs_split(self, sharded):
            return set()
        self.axis = mesh.model
        self.num_heads //= mesh.model.size
        self.out.split("row", mesh.model)
        return {f"{role}.{n}" for role in ("query", "key", "value")
                for n in getattr(self, role).split("column", mesh.model)}

    def _heads(self, dense: Dense, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D_in) -> (B, L, H, Dh)."""
        B, L, _ = x.shape
        return dense(x).view(B, L, self.num_heads, -1)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Projected queries (B, Lq, H, Dh) over keys and values
        (B, Lk, H, Dh), which the kernel reads in place as (B, H, L, Dh)
        views, then the out projection."""
        B, Lq, H, Dh = q.shape
        rate = self.dropout_rate if rng is not None else 0.0
        y = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), mask, dropout_rate=rate,
                            dropout_key=rng.attention_key() if rate else None)
        return self.out(y.transpose(1, 2).reshape(B, Lq, H * Dh))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        if self.axis is not None:
            same = context is x
            x = copy_to_model(x, self.axis)
            context = x if same else copy_to_model(context, self.axis)
        # q before k and v: autograd sums the gradients of a shared input
        # in the order the uses were recorded
        q = self._heads(self.query, x)
        return self._attend(q, self._heads(self.key, context),
                            self._heads(self.value, context), mask, rng)

    def decode(self, x: torch.Tensor, cached_key: torch.Tensor,
               cached_value: torch.Tensor, index: int,
               position_mask: torch.Tensor) -> torch.Tensor:
        """flax's ``decode=True`` step: x (B, 1, D). Writes this token's
        K/V at ``index`` of the (B, max_len, H, Dh) caches, in place, then
        attends over the whole cache with ``position_mask`` (keys at
        positions <= index; (1, 1, 1, max_len) or broadcastable)."""
        q = self._heads(self.query, x)
        cached_key[:, index] = self._heads(self.key, x)[:, 0]
        cached_value[:, index] = self._heads(self.value, x)[:, 0]
        return self._attend(q, cached_key, cached_value, position_mask)


class CachedCrossAttention(MultiHeadDotProductAttention):
    """Cross-attention whose context K/V a decoder projects once per
    generation (``project_context``, at cache init) and attends over at
    every step (``attend_context``); the params are flax MHDPA's."""

    def project_context(self, context: torch.Tensor):
        """(B, Lm, D_ctx) -> K, V, each (B, Lm, H, Dh)."""
        return self._heads(self.key, context), self._heads(self.value,
                                                           context)

    def attend_context(self, x: torch.Tensor, context_key: torch.Tensor,
                       context_value: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, Lq, D) over the projected context."""
        return self._attend(self._heads(self.query, x), context_key,
                            context_value, mask)


class EncoderLayer(nn.Module):
    """Self-attention encoder layer: pre-LN (default, optional LayerScale)
    or post-LN (BERT layout)."""

    def __init__(self, dim: int, num_heads: int, d_ff: int,
                 dtype: torch.dtype = torch.bfloat16, norm_style: str = "pre",
                 activation: str = "gelu_tanh",
                 layer_scale_init: float = 0.0, dropout: float = 0.0):
        super().__init__()
        self.norm_style = norm_style
        self.dropout = dropout
        self.self_attn = MultiHeadDotProductAttention(
            dim, num_heads, dtype=dtype, dropout_rate=dropout)
        self.mlp = MlpBlock(dim, d_ff, activation=to_activation(activation),
                            dtype=dtype, dropout=dropout)
        self.ln1 = LayerNorm(dim, dtype)
        self.ln2 = LayerNorm(dim, dtype)
        self.ls1_scale = self.ls2_scale = None
        if layer_scale_init > 0 and norm_style != "post":
            self.ls1_scale = nn.Parameter(torch.full((dim,), layer_scale_init))
            self.ls2_scale = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        rate = self.dropout
        if self.norm_style == "post":
            y = self.self_attn(x, x, mask, rng)
            x = self.ln1(x + dropout(y, rate, rng))
            y = self.mlp(x, rng)
            return self.ln2(x + dropout(y, rate, rng))
        h = self.ln1(x)
        y = self.self_attn(h, h, mask, rng)
        if self.ls1_scale is not None:
            y = y * self.ls1_scale.to(y.dtype)
        x = x + dropout(y, rate, rng)
        y = self.mlp(self.ln2(x), rng)
        if self.ls2_scale is not None:
            y = y * self.ls2_scale.to(y.dtype)
        return x + dropout(y, rate, rng)


class CrossAttentionLayer(nn.Module):
    """Pre-LN layer: self-attention, cross-attention to a context, MLP;
    ``decode`` is the cached single-token form."""

    def __init__(self, dim: int, num_heads: int, d_ff: int,
                 context_dim: int = 0, dtype: torch.dtype = torch.bfloat16,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ln1 = LayerNorm(dim, dtype)
        self.self_attn = MultiHeadDotProductAttention(
            dim, num_heads, dtype=dtype, dropout_rate=dropout)
        self.ln_cross = LayerNorm(dim, dtype)
        self.cross_attn = CachedCrossAttention(
            dim, num_heads, kv_dim=context_dim or dim, dtype=dtype,
            dropout_rate=dropout)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, d_ff, dtype=dtype, dropout=dropout)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                cross_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        rate = self.dropout
        y = self.ln1(x)
        x = x + dropout(self.self_attn(y, y, self_mask, rng), rate, rng)
        y = self.cross_attn(self.ln_cross(x), context, cross_mask, rng)
        x = x + dropout(y, rate, rng)
        return x + dropout(self.mlp(self.ln2(x), rng), rate, rng)

    def decode(self, x: torch.Tensor, cached_key: torch.Tensor,
               cached_value: torch.Tensor, index: int,
               position_mask: torch.Tensor, context_key: torch.Tensor,
               context_value: torch.Tensor,
               cross_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One cached step (flax ``decode=True``, no dropout): x (B, 1, D);
        the self-attention caches are written at ``index`` in place, the
        context K/V come from ``cross_attn.project_context``."""
        y = self.ln1(x)
        x = x + self.self_attn.decode(y, cached_key, cached_value, index,
                                      position_mask)
        x = x + self.cross_attn.attend_context(self.ln_cross(x), context_key,
                                               context_value, cross_mask)
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


def make_causal_mask(ids: torch.Tensor) -> torch.Tensor:
    """(1, 1, L, L) boolean causal mask for (B, L) ids (flax's
    ``make_causal_mask``, broadcast over the batch): query i keeps keys
    j <= i."""
    L = ids.shape[-1]
    return torch.ones(L, L, dtype=torch.bool, device=ids.device).tril()[
        None, None]


# the learned query slots and tables of the specialized MoE experts
# (models/moe/specialized.py), the Q-Former's and VisionTokenEmbedding's
# queries, single-stream's modality rows, Swin's relative-position bias
# and DeBERTa's relative-position table, drawn from normal(0.02) as in
# flax
_TABLES = ("mask_tokens", "object_queries", "text_queries", "scene_tokens",
           "count_queries", "order_embed", "relation_embeddings",
           "query_tokens", "modality_embed", "rel_pos_bias",
           "rel_embeddings")
# flax's lecun_normal: a normal truncated at two of its standard
# deviations, scaled by 1 / (the truncated law's std) so that the drawn
# std is exactly sqrt(1 / fan_in)
_TRUNC_STD = 0.87962566103423978
_PHI = (0.5 * (1 + math.erf(-2 / math.sqrt(2))),
        0.5 * (1 + math.erf(2 / math.sqrt(2))))


def lecun_normal_(p: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``p`` in place with flax's ``lecun_normal`` by the inverse
    CDF: 2u - 1 uniform on [2 Phi(-2) - 1, 2 Phi(2) - 1], then
    sqrt(2) erfinv of it, so every draw lies within 2 of the unit normal
    and the law is the normal's restricted there (no mass piled on the
    bounds)."""
    p.uniform_(2 * _PHI[0] - 1, 2 * _PHI[1] - 1, generator=generator)
    return p.erfinv_().mul_(math.sqrt(2.0) / math.sqrt(fan_in) / _TRUNC_STD)


def _fan_in(mod: nn.Module, p: torch.Tensor) -> int:
    """flax's fan_in of the leaf: a Dense kernel's input width (a
    DenseGeneral's flattened input axes), a Conv kernel's receptive field
    times its input channels (torch (O, I, k...) and flax (k..., I, O)
    agree), and for a stacked expert tensor (E, in, out) the product of
    every axis but the last, E * in, as ``lecun_normal`` reads a 3-D
    shape."""
    if p.dim() == 3 and not isinstance(mod, nn.Conv1d):
        return p.shape[0] * p.shape[1]
    return math.prod(p.shape[1:])


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights by the flax initialisers' laws, drawn from
    ``generator`` on the device where the weights live: Dense, Conv and
    stacked-expert kernels ``lecun_normal`` (truncated, ``_fan_in``);
    embedding and position tables and the query slots normal(0.02); the
    text encoder's ``type_embed`` (an ``nn.Embed`` with flax's default
    init) normal with std 1/sqrt(D); biases and the CLS token 0; LayerNorm,
    RMSNorm and GroupNorm scales and ResNet's frozen affine scale 1; LayerScale
    gains left at their init value."""
    with torch.no_grad():
        for name, mod in module.named_modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if isinstance(mod, Embed) and name.rpartition(".")[2] \
                        == "type_embed":
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]),
                              generator=generator)
                elif isinstance(mod, Embed) or leaf == "pos_embed" \
                        or leaf in _TABLES:
                    p.normal_(0.0, 0.02, generator=generator)
                elif isinstance(mod, (LayerNorm, GroupNorm, RMSNorm)):
                    p.fill_(1.0 if leaf == "weight" else 0.0)
                elif leaf == "scale":
                    p.fill_(1.0)
                elif "bias" in leaf or leaf == "cls_token":
                    p.zero_()
                elif leaf in ("ls1_scale", "ls2_scale"):
                    continue
                else:
                    # Linear (out, in), Conv (O, I, k...), stacked experts
                    # (E, in, out)
                    lecun_normal_(p, _fan_in(mod, p), generator)
