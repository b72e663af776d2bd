"""Collectives over one axis of the ('data', 'model') mesh (the port's
own; the JAX package leaves them to XLA's GSPMD).

An ``Axis`` is one mesh dimension as this rank sees it: its size, this
rank's index along it and the process group of the ranks that differ
from this one only along it. Every function here is the identity on an
axis of size 1 and issues no call.

Plain collectives (no gradient): ``all_reduce``, ``all_gather`` and
``broadcast``, the three that gloo offers (it has no reduce-scatter).
Low-precision tensors are reduced in f32 and cast back, so a bf16
partial sum rounds once, as one f32-accumulated product would.

The Megatron pair and its two companions, as ``torch.autograd``
functions:

- ``copy_to_model``: identity forward, all-reduce (sum) backward. A
  replicated activation enters a column-parallel layer through it, so
  that its gradient sums the shards' contributions;
- ``reduce_from_model``: all-reduce (sum) forward, identity backward:
  the partial outputs of a row-parallel layer;
- ``gather_from_model``: all-gather along a dimension forward, this
  rank's slice of the gradient backward;
- ``all_reduce_with_grad``: all-reduce forward and backward, for a value
  that every rank then uses whole (the router's batch means under data
  parallelism).

Where ranks share a card the backend is gloo, which takes CUDA tensors
for these three collectives. ``stats`` counts the calls, the bytes
handed to the backend and the host seconds spent in the calls, for the
smoke run's report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0)


@dataclasses.dataclass(frozen=True)
class Axis:
    name: str
    size: int = 1
    rank: int = 0
    group: Optional[dist.ProcessGroup] = None


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor handed to the backend: f32 for a low-precision float;
    always a fresh contiguous copy."""
    dt = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype
    return t.detach().to(dtype=dt, copy=True).contiguous()


def _timed(fn, nbytes: int):
    t0 = time.perf_counter()
    out = fn()
    stats["calls"] += 1
    stats["bytes"] += nbytes
    stats["seconds"] += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis, in t's dtype and device."""
    if axis.size == 1:
        return t
    w = _wire(t)
    _timed(lambda: dist.all_reduce(w, group=axis.group),
           w.numel() * w.element_size())
    return w.to(t.device, t.dtype)


def all_gather(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The axis' tensors concatenated along ``dim`` in rank order."""
    if axis.size == 1:
        return t
    w = _wire(t)
    parts = [torch.empty_like(w) for _ in range(axis.size)]
    _timed(lambda: dist.all_gather(parts, w, group=axis.group),
           w.numel() * w.element_size() * axis.size)
    return torch.cat(parts, dim).to(t.device, t.dtype)


def broadcast(t: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """Rank ``src`` of the axis' tensor on every rank of it."""
    if axis.size == 1:
        return t
    w = _wire(t)
    src_global = dist.get_global_rank(axis.group, src)
    _timed(lambda: dist.broadcast(w, src_global, group=axis.group),
           w.numel() * w.element_size())
    return w.to(t.device, t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None


class _AllReduceWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axis), None


def copy_to_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Axis,
                      dim: int = -1) -> torch.Tensor:
    return x if axis.size == 1 else _GatherFromModel.apply(
        x, axis, dim % x.dim())


def all_reduce_with_grad(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return x if axis.size == 1 else _AllReduceWithGrad.apply(x, axis)
