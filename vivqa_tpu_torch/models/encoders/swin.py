"""Swin Transformer visual encoder (counterpart of
vivqa_tpu/models/encoders/swin.py): windowed attention with shifted
windows, a learned relative-position bias, and patch merging.

Window partition and reverse are reshapes; the shift is ``torch.roll`` by
-shift before the attention and by +shift after it. The relative-position
index and the shifted windows' mask are host-built numpy constants, kept
as non-persistent buffers. A stage whose map one window covers
(H <= window) shrinks the window to the map and turns the shift off, as
timm and HF do. PatchMerging concatenates the 2x2 neighbours in the JAX
package's order, (B, H/2, 2, W/2, 2, C) transposed to (0, 1, 3, 2, 4, 5).

The window attention does not go through ``flash_attention``: it adds
the learned bias to the scores, which the kernels cannot take. It is
computed as the JAX module computes it: f32 scores / sqrt(hd), plus the
bias, -1e9 where the shift mask forbids a pair (after the bias), an f32
softmax cast to the compute dtype, then the product with v.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.config import VisualEncoderConfig
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           MlpBlock, to_activation,
                                           to_dtype)


def _rel_pos_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + ws - 1
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) boolean mask: True = may attend."""
    img = np.zeros((H, W), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wss] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    return win[:, :, None] == win[:, None, :]


def swin_out_dim(cfg: VisualEncoderConfig) -> int:
    """The last stage's width: embed * 2^(stages - 1)."""
    return cfg.swin_embed_dim * 2 ** (len(cfg.swin_depths) - 1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    x = x.view(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // ws) * (W // ws), ws * ws, C)


def window_reverse(x: torch.Tensor, ws: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    C = x.shape[-1]
    x = x.view(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor,
                     attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v (nB, h, L, hd) in the compute dtype; bias (h, L, L) f32;
    attn_mask (nW, L, L) bool or None -> (nB, h, L, hd): f32 scores /
    sqrt(hd) plus the bias, -1e9 where the mask forbids a pair, an f32
    softmax cast to v's dtype, then the product with v."""
    nB, h, L, hd = q.shape
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(hd) + bias
    if attn_mask is not None:
        nW = attn_mask.shape[0]
        attn = torch.where(attn_mask[None, :, None],
                           attn.view(nB // nW, nW, h, L, L),
                           -1e9).view(nB, h, L, L)
    return torch.matmul(torch.softmax(attn, dim=-1).to(v.dtype), v)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.proj = Dense(dim, dim, dtype=dtype)
        self.register_buffer("rel_index", torch.from_numpy(
            _rel_pos_index(window_size).astype(np.int64)), persistent=False)

    def forward(self, x: torch.Tensor,
                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: (nB, ws*ws, C); attn_mask: (nW, L, L) bool or None."""
        nB, L, C = x.shape
        h = self.num_heads
        hd = C // h
        qkv = self.qkv(x).view(nB, L, 3, h, hd).permute(2, 0, 3, 1, 4)
        out = window_attention(qkv[0], qkv[1], qkv[2], self.bias(), attn_mask)
        return self.proj(out.transpose(1, 2).reshape(nB, L, C))

    def bias(self) -> torch.Tensor:
        """The relative-position bias of every pair, (h, L, L) f32."""
        return self.rel_pos_bias[self.rel_index].permute(2, 0, 1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, input_hw: tuple, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16,
                 activation: str = "gelu_tanh", ln_eps: float = 1e-6):
        super().__init__()
        self.window_size, self.shift, self.input_hw = (window_size, shift,
                                                       tuple(input_hw))
        self.ln1 = LayerNorm(dim, dtype, eps=ln_eps)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype)
        self.ln2 = LayerNorm(dim, dtype, eps=ln_eps)
        self.mlp = MlpBlock(dim, 4 * dim, activation=to_activation(activation),
                            dtype=dtype, dropout=dropout)
        mask = None
        if shift > 0:
            mask = torch.from_numpy(_shift_attn_mask(*input_hw, window_size,
                                                     shift))
        self.register_buffer("shift_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        H, W = self.input_hw
        B, L, C = x.shape
        s, ws = self.shift, self.window_size
        shortcut = x
        x = self.ln1(x).view(B, H, W, C)
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        wins = self.attn(window_partition(x, ws), self.shift_mask)
        x = window_reverse(wins, ws, B, H, W)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = shortcut + x.reshape(B, L, C)
        return x + self.mlp(self.ln2(x), rng)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, input_hw: tuple,
                 dtype: torch.dtype = torch.bfloat16, ln_eps: float = 1e-6):
        super().__init__()
        self.input_hw = tuple(input_hw)
        self.ln = LayerNorm(4 * dim, dtype, eps=ln_eps)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.input_hw
        B, L, C = x.shape
        x = x.view(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, (H // 2) * (W // 2), 4 * C)
        return self.reduction(self.ln(x))


class SwinEncoder(nn.Module):
    def __init__(self, config: VisualEncoderConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype = to_dtype(cfg.dtype)
        E = cfg.swin_embed_dim
        self.patch_embed = nn.Conv2d(3, E, 4, stride=4)
        self.ln_embed = LayerNorm(E, dtype, eps=cfg.ln_eps)
        self.stages = []                # (flax names of a stage's blocks,
        H = cfg.image_size // 4         #  its merge's or None)
        dim = E
        for s, (depth, heads) in enumerate(zip(cfg.swin_depths,
                                               cfg.swin_heads)):
            ws = min(cfg.swin_window, H)
            names = []
            for b in range(depth):
                shift = 0 if (b % 2 == 0 or H <= ws) else ws // 2
                names.append(f"stage{s}_block{b}")
                self.add_module(names[-1], SwinBlock(
                    dim, heads, ws, shift, (H, H), cfg.dropout, dtype,
                    cfg.activation, cfg.ln_eps))
            merge = None
            if s < len(cfg.swin_depths) - 1:
                merge = f"merge{s}"
                self.add_module(merge, PatchMerging(dim, (H, H), dtype,
                                                    cfg.ln_eps))
                H, dim = H // 2, dim * 2
            self.stages.append((names, merge))
        self.ln_final = LayerNorm(dim, dtype, eps=cfg.ln_eps)
        if cfg.output_dim:
            self.projection = Dense(dim, cfg.output_dim, bias=False,
                                    dtype=dtype)

    def forward(self, pixel_values: torch.Tensor,
                rng: DropoutRNG | None = None) -> dict:
        """pixel_values: (B, H, W, 3) NHWC."""
        cfg, dtype = self.config, self.dtype
        w = self.patch_embed
        x = F.conv2d(pixel_values.to(dtype).permute(0, 3, 1, 2),
                     w.weight.to(dtype), w.bias.to(dtype), stride=4)
        x = self.ln_embed(x.flatten(2).transpose(1, 2))
        for names, merge in self.stages:
            for name in names:
                x = getattr(self, name)(x, rng)
            if merge is not None:
                x = getattr(self, merge)(x)
        x = self.ln_final(x)
        pooled, tokens = x.mean(dim=1), x
        if cfg.output_dim:
            pooled, tokens = self.projection(pooled), self.projection(tokens)
        return {"pooled": pooled, "tokens": tokens}
