"""Plain PyTorch building blocks of the reference models.

Everything computes in float32 (the caller turns TF32 off), with no
kernel, cache or fusion: attention is the softmax of the full score
matrix. The parameter names are the measured program's, so one set of
weights made from the seed loads into both by name.

Two objects are passed in, never module state:

- ``Precision``: the type every product's operands are rounded to.
  ``float32`` rounds nothing. ``float8`` rounds each operand of every
  matrix product (linear layers, convolutions, einsums, the attention's
  two products) to float8 e4m3 with one scale per tensor, and passes
  the gradient straight through: the benchmark's lower-precision
  control.
- ``Dropout``: the randomness of one training forward, worked out again
  from the step's seed. Elementwise keep masks are drawn from a
  ``torch.Generator`` in the order and at the full-batch shapes at which
  a flax-style model draws them (``torch.rand(shape) < 1 - rate``), and
  kept, so that a batch computed in blocks of rows takes each block's
  rows of the same masks. Attention dropout keeps (q, k) where a 32-bit
  counter hash of the call's key, q and k clears the rate's threshold,
  one (Lq, Lk) mask per call for every row and head.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

NEG_INF = -1e30
_SEED_MIX = 0x9E3779B97F4A7C15
_M32 = 0xFFFFFFFF
_M64 = 2 ** 64 - 1
_FP8_MAX = 448.0


# -- seeds --------------------------------------------------------------------
def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, step: int) -> int:
    """A 63-bit seed for step ``step`` of the run seeded ``seed``."""
    return _splitmix64(_splitmix64(seed & _M64) ^ (step & _M64)) >> 1


def _mix32(x: int) -> int:
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_dropout_key(seed: int, call: int) -> int:
    return _mix32(_mix32(_mix32(seed & _M32) ^ ((seed >> 32) & _M32))
                  ^ (call & _M32))


def attention_keep(Lq: int, Lk: int, rate: float, key: int,
                   device) -> torch.Tensor:
    """(Lq, Lk) bool: keep (q, k) iff mix(mix(q ^ key) ^ k) >=
    floor(rate * 2**32)."""
    threshold = min(_M32, int(rate * 2 ** 32))
    rows = _mix32_t(torch.arange(Lq, dtype=torch.int64, device=device)
                    ^ (key & _M32))
    cols = torch.arange(Lk, dtype=torch.int64, device=device)
    return _mix32_t(rows[:, None] ^ cols[None, :]) >= threshold


# -- precision ----------------------------------------------------------------
class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class Precision:
    """The rounding of every product's operands: ``float32`` (none) or
    ``float8`` (e4m3, a scale per tensor, straight-through gradient)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision '{name}'")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or t.device.type == "meta":
            return t
        return _RoundFp8.apply(t)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.q(o) for o in ops))

    def linear(self, x, w, b=None):
        y = F.linear(self.q(x), self.q(w))
        return y if b is None else y + b


# -- dropout ------------------------------------------------------------------
class Dropout:
    """One training forward's randomness for a batch of ``batch`` rows, of
    which this block computes ``rows``; ``generator`` is seeded for the
    step. The 64-bit attention seed is read from the generator's state as
    the program reads it: on a card the generator's seed and Philox
    offset (the offset then moves on by 4), on the CPU one draw."""

    def __init__(self, generator: torch.Generator, batch: int):
        self.generator = generator
        self.batch = batch
        self.rows = slice(0, batch)
        if generator.device.type == "cuda":
            offset = generator.get_offset()
            generator.set_offset(offset + 4)
            self.seed = (generator.initial_seed() * _SEED_MIX + offset) \
                % 2 ** 64
        else:
            self.seed = int(torch.randint(0, 2 ** 62, (1,),
                                          generator=generator))
        self.masks: list = []
        self.start(self.rows)

    def start(self, rows: slice) -> None:
        """Begin a block of rows: the masks are taken again from the
        first."""
        self.rows = rows
        self.drawn = 0
        self.calls = 0

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        if self.drawn == len(self.masks):
            shape = (self.batch,) + tuple(x.shape[1:])
            self.masks.append(torch.rand(
                shape, generator=self.generator,
                device=self.generator.device) < 1.0 - rate)
        keep = self.masks[self.drawn][self.rows].to(x.device)
        self.drawn += 1
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def attention_key(self) -> int:
        key = attention_dropout_key(self.seed, self.calls)
        self.calls += 1
        return key


# -- layers -------------------------------------------------------------------
def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu_tanh": gelu_tanh,
               "gelu": lambda x: F.gelu(x, approximate="none"),
               "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
               "relu": F.relu, "silu": F.silu}


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, prec: Precision,
                 bias: bool = True):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias,
                            self.eps)


class Embed(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


def attention_mask(query_mask: Optional[torch.Tensor],
                   key_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, 1, Lq, Lk) bool: the query and the key are both real."""
    if query_mask is None:
        query_mask = torch.ones_like(key_mask[:, :1])
    if key_mask is None:
        key_mask = torch.ones_like(query_mask[:, :1])
    return (query_mask[:, None, :, None] * key_mask[:, None, None, :]) != 0


class Attention(nn.Module):
    """Multi-head attention: q, k, v projections, softmax over the full
    score matrix (masked scores at -1e30, so a row with no allowed key
    averages every key), probability dropout, out projection.
    ``recorder``, where given, gets (q shape, k shape, the mask on the
    host, causal) of each call."""

    def __init__(self, dim: int, heads: int, prec: Precision,
                 kv_dim: int = 0, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.rate = dropout
        self.prec = prec
        self.query = Linear(dim, dim, prec)
        self.key = Linear(kv_dim or dim, dim, prec)
        self.value = Linear(kv_dim or dim, dim, prec)
        self.out = Linear(dim, dim, prec)

    def forward(self, x, context, mask=None, causal=False,
                drop: Optional[Dropout] = None, recorder=None):
        B, Lq, D = x.shape
        Lk = context.shape[1]
        split = lambda t, L: t.view(B, L, self.heads, -1).transpose(1, 2)
        q = split(self.query(x), Lq)
        k = split(self.key(context), Lk)
        v = split(self.value(context), Lk)
        if recorder is not None:
            recorder.append((tuple(q.shape), tuple(k.shape),
                             None if mask is None else mask.cpu(), causal))
        s = self.prec.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D //
                                                                  self.heads)
        allowed = None if mask is None else mask.to(s.device)
        if causal:
            tri = torch.ones(Lq, Lk, dtype=torch.bool,
                             device=s.device).tril(Lk - Lq)
            allowed = tri if allowed is None else allowed & tri
        if allowed is not None:
            s = torch.where(allowed, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        if drop is not None and self.rate:
            keep = attention_keep(Lq, Lk, self.rate, drop.attention_key(),
                                  s.device)
            p = p * keep.to(p.dtype) / (1.0 - self.rate)
        o = self.prec.einsum("bhqk,bhkd->bhqd", p, v)
        return self.out(o.transpose(1, 2).reshape(B, Lq, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, prec: Precision,
                 activation: str = "gelu_tanh", dropout: float = 0.0):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.rate = dropout
        self.wi = Linear(dim, hidden, prec)
        self.wo = Linear(hidden, dim, prec)

    def forward(self, x, drop=None):
        h = self.act(self.wi(x))
        return self.wo(drop(h, self.rate) if drop is not None else h)


def _drop(drop, x, rate):
    return x if drop is None else drop(x, rate)


class EncoderLayer(nn.Module):
    """Self-attention and MLP, pre-LN (``x + f(LN(x))``) or post-LN
    (``LN(x + f(x))``, the BERT layout), dropout on each branch."""

    def __init__(self, dim: int, heads: int, hidden: int, prec: Precision,
                 norm: str = "pre", activation: str = "gelu_tanh",
                 dropout: float = 0.0):
        super().__init__()
        self.norm = norm
        self.rate = dropout
        self.self_attn = Attention(dim, heads, prec, dropout=dropout)
        self.mlp = Mlp(dim, hidden, prec, activation, dropout)
        self.ln1 = LayerNorm(dim)
        self.ln2 = LayerNorm(dim)

    def forward(self, x, mask=None, drop=None, recorder=None):
        r = self.rate
        if self.norm == "post":
            y = self.self_attn(x, x, mask, drop=drop, recorder=recorder)
            x = self.ln1(x + _drop(drop, y, r))
            y = self.mlp(x, drop)
            return self.ln2(x + _drop(drop, y, r))
        h = self.ln1(x)
        y = self.self_attn(h, h, mask, drop=drop, recorder=recorder)
        x = x + _drop(drop, y, r)
        y = self.mlp(self.ln2(x), drop)
        return x + _drop(drop, y, r)


class CrossLayer(nn.Module):
    """Pre-LN self-attention, cross-attention to a context, MLP."""

    def __init__(self, dim: int, heads: int, hidden: int, prec: Precision,
                 context_dim: int = 0, dropout: float = 0.0):
        super().__init__()
        self.rate = dropout
        self.ln1 = LayerNorm(dim)
        self.self_attn = Attention(dim, heads, prec, dropout=dropout)
        self.ln_cross = LayerNorm(dim)
        self.cross_attn = Attention(dim, heads, prec, kv_dim=context_dim,
                                    dropout=dropout)
        self.ln2 = LayerNorm(dim)
        self.mlp = Mlp(dim, hidden, prec, dropout=dropout)

    def forward(self, x, context, self_mask=None, cross_mask=None,
                causal=False, drop=None, recorder=None):
        r = self.rate
        y = self.ln1(x)
        x = x + _drop(drop, self.self_attn(y, y, self_mask, causal, drop,
                                           recorder), r)
        y = self.cross_attn(self.ln_cross(x), context, cross_mask, False,
                            drop, recorder)
        x = x + _drop(drop, y, r)
        return x + _drop(drop, self.mlp(self.ln2(x), drop), r)


class ViT(nn.Module):
    """CLIP-style or plain ViT over NHWC pixels: a patch convolution, the
    class token, learned positions, (CLIP: a LayerNorm before the
    layers), pre-LN layers, the final LayerNorm (CLIP: on the class token
    only). Returns (pooled, patch tokens)."""

    def __init__(self, c: dict, prec: Precision):
        super().__init__()
        D, P = c["hidden_dim"], c["patch_size"]
        self.c, self.prec = c, prec
        n = (c["image_size"] // P) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, D))
        self.patch_embed = nn.Conv2d(3, D, P, stride=P)
        if c["vit_style"] == "clip":
            self.ln_pre = LayerNorm(D)
        self.layers = nn.ModuleList(
            EncoderLayer(D, c["num_heads"], int(D * c["mlp_ratio"]), prec,
                         activation=c["activation"], dropout=c["dropout"])
            for _ in range(c["num_layers"]))
        self.ln_final = LayerNorm(D)

    def forward(self, pixels, drop=None, recorder=None):
        c, w = self.c, self.patch_embed
        x = F.conv2d(self.prec.q(pixels.permute(0, 3, 1, 2)),
                     self.prec.q(w.weight), w.bias, stride=c["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        if c["vit_style"] == "clip":
            x = self.ln_pre(x)
        x = _drop(drop, x, c["dropout"])
        for layer in self.layers:
            x = layer(x, None, drop, recorder)
        if c["vit_style"] == "clip":
            return self.ln_final(x[:, 0]), x[:, 1:]
        x = self.ln_final(x)
        return x[:, 0], x[:, 1:]


class TextEncoder(nn.Module):
    """BERT-family encoder: token and position embeddings, LayerNorm,
    dropout, layers under the query-and-key padding mask (pre-LN with a
    final LayerNorm, or post-LN). Returns (pooled, tokens)."""

    def __init__(self, c: dict, prec: Precision):
        super().__init__()
        D = c["hidden_dim"]
        self.c = c
        self.token_embed = Embed(c["vocab_size"], D)
        self.pos_embed = Embed(c["max_length"], D)
        self.ln_embed = LayerNorm(D)
        self.layers = nn.ModuleList(
            EncoderLayer(D, c["num_heads"], int(D * c["mlp_ratio"]), prec,
                         norm=c["norm_style"], activation=c["activation"],
                         dropout=c["dropout"])
            for _ in range(c["num_layers"]))
        if c["norm_style"] == "pre":
            self.ln_final = LayerNorm(D)

    def forward(self, ids, mask, drop=None, recorder=None):
        c = self.c
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = self.token_embed(ids) + self.pos_embed(pos)
        x = _drop(drop, self.ln_embed(x), c["dropout"])
        am = attention_mask(mask, mask)
        for layer in self.layers:
            x = layer(x, am, drop, recorder)
        if c["norm_style"] == "pre":
            x = self.ln_final(x)
        if c["pooling"] != "cls":
            raise NotImplementedError(f"pooling {c['pooling']}")
        return x[:, 0], x


class DenseMoE(nn.Module):
    """Every expert on every token (a two-layer gelu MLP with biases),
    combined by a bias-free float32 router's softmax, top-k kept and
    renormalised (ties to the lower index), then LN(x + y). The load
    balance loss is ``E * sum_e(frac_e * mean_prob_e)`` over the whole
    batch's tokens, ``frac_e`` the share of tokens that kept expert e
    (no gradient). ``forward`` returns y and the block's sums of the
    probabilities and of the assignments, with its token count, so that
    a batch computed in blocks can form the loss over the whole batch."""

    def __init__(self, dim: int, experts: int, hidden: int, top_k: int,
                 prec: Precision, dropout: float = 0.0):
        super().__init__()
        self.prec, self.k, self.rate = prec, top_k, dropout
        self.experts_w_in = nn.Parameter(torch.empty(experts, dim, hidden))
        self.experts_bias_in = nn.Parameter(torch.empty(experts, hidden))
        self.experts_w_out = nn.Parameter(torch.empty(experts, hidden, dim))
        self.experts_bias_out = nn.Parameter(torch.empty(experts, dim))
        self.router = nn.Module()
        self.router.gate = Linear(dim, experts, prec, bias=False)
        self.ln_out = LayerNorm(dim)

    def forward(self, x, drop=None):
        E = self.experts_w_in.shape[0]
        probs = torch.softmax(self.router.gate(x), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :self.k], idx[..., :self.k]
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        w = torch.zeros_like(probs).scatter(-1, idx, vals)
        h = self.prec.einsum("bld,edh->bleh", x, self.experts_w_in)
        h = gelu_tanh(h + self.experts_bias_in)
        h = _drop(drop, h, self.rate)
        y = self.prec.einsum("bleh,ehd->bled", h, self.experts_w_out)
        y = torch.einsum("bled,ble->bld", y, w) \
            + torch.einsum("ble,ed->bld", w, self.experts_bias_out)
        stats = (probs.reshape(-1, E).sum(0),
                 (w.detach() > 0).float().reshape(-1, E).sum(0),
                 probs.shape[0] * probs.shape[1])
        return self.ln_out(y + x), stats
