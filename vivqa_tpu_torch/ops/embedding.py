"""Embedding lookup (counterpart of vivqa_tpu/ops/embedding.py).

The JAX package gives its embedding a one-hot-matmul backward because
scatters are slow on the TPU. The port's forward is the same gather, and
its gradient is ``F.embedding``'s own: the rows' gradients summed into
the f32 table in f32. The JAX package casts the table to the compute
dtype before the take, so its table gradient is rounded once to that
dtype (bf16 on the main path); the two agree to that rounding
(ROADMAP.md, Queue C).

Split over a mesh's 'model' axis (``parallel/mesh.py``: the vocabulary
of ``token_embed`` tables), each rank holds V/m rows: a lookup masks the
ids outside the rank's range, takes the rest locally and sums over
'model' (each id's row is on one rank, so the sum is exact); the tied
output projection gathers the ranks' logits along the vocabulary.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.parallel.collectives import (Axis, copy_to_model,
                                                  gather_from_model,
                                                  reduce_from_model)


class Embed(nn.Module):
    """Token table (V, D) in float32, looked up in the compute dtype.

    Covers both ``MatmulGradEmbed`` and ``flax.linen.Embed`` (same
    ``embedding`` leaf, same ``attend``).
    """
    TP_LEAVES = ("weight",)
    axis: Optional[Axis] = None

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def use_mesh(self, mesh, sharded: set) -> set:
        if sharded:
            self.axis = mesh.model
            self.vocab_start = mesh.model.rank * self.weight.shape[0]
        return set()

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # the JAX module casts the table, then takes; a cast is elementwise,
        # so taking first gives the same values without casting all V rows
        if self.axis is None:
            return F.embedding(ids, self.weight).to(self.dtype)
        local = ids - self.vocab_start
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(inside, local, 0), self.weight)
        rows = torch.where(inside[..., None], rows, 0.0)
        return reduce_from_model(rows, self.axis).to(self.dtype)

    def attend(self, query: torch.Tensor) -> torch.Tensor:
        """Tied output projection: (..., D) @ table^T -> (..., V)."""
        if self.axis is None:
            return query @ self.weight.to(query.dtype).T
        query = copy_to_model(query, self.axis)
        return gather_from_model(query @ self.weight.to(query.dtype).T,
                                 self.axis, -1)
