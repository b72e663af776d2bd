"""Embedding lookup (counterpart of vivqa_tpu/ops/embedding.py).

The JAX package gives its embedding a one-hot-matmul backward because
scatters are slow on the TPU. The port's forward is the same gather, and
its gradient is ``F.embedding``'s own: the rows' gradients summed into
the f32 table in f32. The JAX package casts the table to the compute
dtype before the take, so its table gradient is rounded once to that
dtype (bf16 on the main path); the two agree to that rounding
(ROADMAP.md, Queue C).
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class Embed(nn.Module):
    """Token table (V, D) in float32, looked up in the compute dtype.

    Covers both ``MatmulGradEmbed`` and ``flax.linen.Embed`` (same
    ``embedding`` leaf, same ``attend``).
    """

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # the JAX module casts the table, then takes; a cast is elementwise,
        # so taking first gives the same values without casting all V rows
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """Tied output projection: (..., D) @ table^T -> (..., V)."""
        return query @ self.weight.to(query.dtype).T
