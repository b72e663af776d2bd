"""The ('data', 'model') mesh over a torch.distributed process group
(counterpart of vivqa_tpu/parallel/mesh.py).

The JAX package shards by annotation: a ``jax.sharding.Mesh``, rules that
place each parameter, and XLA's GSPMD inserts the collectives. Here the
ranks are processes, each holds its own shard, and the modules issue the
collectives themselves (``parallel/collectives.py``):

- ``data`` splits the batch: each rank takes its rows, and the train
  step averages the gradients over ``data`` (``train/state.py``);
- ``model`` holds the tensor-parallel shards: attention heads and MLP
  hidden units (Megatron's column- and row-parallel pair), the expert
  dimension of the MoE layers (expert parallelism), and the vocabulary of
  the embedding tables.

Placement is the JAX package's rule table, unchanged: ``(path-regex,
spec)`` pairs matched with ``re.search`` against each parameter's
``/``-joined flax path (``models/from_jax.flax_paths``), the first match
winning; a spec applies only if its rank fits the flax leaf and each
sharded dimension divides by its axis, else the leaf is replicated.
``shard_pytree_by_rules`` turns each spec into the torch dimension of the
parameter that holds it (a (D, H, Dh) query kernel's H is dimension 0 of
the (H*Dh, D) weight, an (H, Dh, D) out kernel's H dimension 1 of the
(D, H*Dh) weight), and ``logical_to_mesh`` keeps each rank's slice and
tells the modules that own the sharded leaves (``TP_LEAVES``) to run
their parallel form. A split leaf whose module has no parallel form (a
plain ``Dense`` the rules match, such as ``KnowledgeAttention``'s
``k_proj``) takes the gathered form, which is what GSPMD does for the
JAX package: the parameter holds this rank's slice at rest, the owning
module's forward sees the whole tensor, all-gathered over the leaf's axis
(``gather_from_model``), and the backward keeps this rank's slice of the
whole gradient. Every rank of the axis feeds that module the same
replicated activations, so the whole gradient is the same on each and
the slice is exact; the optimizer, ``place_state``, the 'data' average
and the checkpoints see an ordinary split leaf.

``create_mesh`` with one process and no process group gives a 1x1 mesh
that needs no launcher: the single-card path, unchanged. With more ranks
it joins (or starts, under ``torchrun``) the process group; the backend is
NCCL where every rank has a card of its own and gloo on the CPU or where
ranks share a card (NCCL refuses two ranks on one device), and
``Mesh.backend`` says which. Rank r runs on ``cuda:(local_rank %
device_count)``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.models.from_jax import flax_layouts, flax_paths
from vivqa_tpu_torch.models.layers import Dense
from vivqa_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                  gather_from_model)

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig(ConfigBase):
    """Mesh shape. ``data_axis=-1`` means "all remaining devices"."""
    data_axis: int = -1
    model_axis: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        model = max(1, self.model_axis)
        data = self.data_axis
        if data in (-1, 0):
            assert n_devices % model == 0, (
                f"{n_devices} devices not divisible by model_axis={model}")
            data = n_devices // model
        assert data * model == n_devices, (
            f"mesh {data}x{model} != {n_devices} devices")
        return data, model


class Mesh:
    """This rank's view of a (data, model) mesh: ``shape`` ({'data': d,
    'model': m}), ``data`` and ``model`` (each an ``Axis``: size, this
    rank's index, group), the rank's ``device``, the ``backend`` (None for
    the 1x1 mesh without a process group) and ``device_mesh`` (torch's
    ``DeviceMesh``, None for that mesh)."""

    def __init__(self, data: Axis, model: Axis, device: torch.device,
                 backend: Optional[str] = None, device_mesh=None):
        self.data, self.model = data, model
        self.device = device
        self.backend = backend
        self.device_mesh = device_mesh

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data.size, MODEL_AXIS: self.model.size}

    @property
    def size(self) -> int:
        return self.data.size * self.model.size

    @property
    def is_main(self) -> bool:
        """The rank that logs, reports and writes: global rank 0."""
        return not dist.is_initialized() or dist.get_rank() == 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data.size}, model={self.model.size}, "
                f"device={self.device}, backend={self.backend})")


def _backend_for(device: torch.device, local_world: int) -> str:
    if device.type == "cpu":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def _rank_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is "
                           "available; pass device='cpu'")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized()
                               else 0))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def create_mesh(config: MeshConfig | None = None,
                device: str | torch.device = "cuda",
                ranks: Sequence[int] | None = None) -> Optional[Mesh]:
    """The 2-D ('data', 'model') mesh over the launched processes.

    One process without a process group: the 1x1 mesh, no collective.
    Otherwise the process group is joined (started from ``torchrun``'s
    environment if none exists: NCCL when every local rank has a card,
    gloo on the CPU or when ranks share one) and torch's ``DeviceMesh``
    gives the groups. ``ranks``: the global ranks that form the mesh
    (all of the world by default), row-major over (data, model); every
    rank of the world must call, and a rank outside ``ranks`` gets None.
    """
    config = config or MeshConfig()
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world == 1 and not dist.is_initialized():
        config.resolve(1)
        dev = _rank_device(device)
        return Mesh(Axis(DATA_AXIS), Axis(MODEL_AXIS), dev)
    if not dist.is_initialized():
        dev = torch.device(device)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        dist.init_process_group(_backend_for(dev, local_world))
    dev = _rank_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type == "cuda" and \
            int(os.environ.get("LOCAL_WORLD_SIZE", str(world))) > \
            torch.cuda.device_count():
        raise ValueError("NCCL refuses two ranks on one card: start the "
                         "process group with gloo where ranks share one")
    ranks = list(range(world)) if ranks is None else list(ranks)
    data, model = config.resolve(len(ranks))
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(dev.type, torch.tensor(ranks).view(data, model),
                    mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    coord = dm.get_coordinate()
    if coord is None:
        return None
    axes = [Axis(name, size, c, dm.get_group(name))
            for name, size, c in zip((DATA_AXIS, MODEL_AXIS),
                                     (data, model), coord)]
    return Mesh(*axes, dev, backend, dm)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lives on the mesh: split along ``axis`` at torch
    dimension ``dim`` (``flax_dim`` of the flax leaf), or replicated
    (``axis`` None)."""
    axis: Optional[str] = None
    dim: int = 0
    flax_dim: int = 0


def batch_sharding(mesh: Mesh) -> Placement:
    """Batches are split on the leading (batch) dimension over 'data'."""
    return Placement(DATA_AXIS, 0, 0)


def replicated(mesh: Mesh) -> Placement:
    return Placement()


def local_rows(batch: Mapping, mesh: Mesh) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors
    with a leading batch dimension that divides by the data axis)."""
    d = mesh.data
    if d.size == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % d.size:
            raise ValueError(f"batch '{k}' of {n} rows does not divide "
                             f"over data={d.size}")
        rows = n // d.size
        out[k] = v[d.rank * rows:(d.rank + 1) * rows]
    return out


# Path regexes are matched (re.search) against '/'-joined flax paths,
# e.g. "decoder/layers_3/mlp/wi/kernel". First match wins. A spec is a
# tuple of mesh axes (None: not split), one per leading dimension of the
# flax leaf, as jax's PartitionSpec.
#
# Tensor-parallel layout convention (Megatron-style):
#   - MLP up-projection kernel  (d_model, d_ff):      shard d_ff    -> (None, 'model')
#   - MLP down-projection kernel (d_ff, d_model):     shard d_ff    -> ('model', None)
#   - attention qkv kernels     (d_model, H, Dh):     shard heads   -> (None, 'model')
#   - attention out kernel      (H, Dh, d_model):     shard heads   -> ('model', None)
#   - MoE stacked expert weights (E, ...):            shard experts -> ('model', ...)
DEFAULT_PARTITION_RULES: tuple[tuple[str, tuple], ...] = (
    (r"experts?[/_].*w_in", (MODEL_AXIS, None, None)),
    (r"experts?[/_].*w_out", (MODEL_AXIS, None, None)),
    (r"experts?[/_].*w_gate", (MODEL_AXIS, None, None)),
    (r"experts?[/_].*(bias_in|bias_out|bias_gate)", (MODEL_AXIS, None)),
    (r"(self_attn|cross_attn|attention|attn)/(query|key|value|q_proj|k_proj|v_proj)/kernel", (None, MODEL_AXIS)),
    (r"(self_attn|cross_attn|attention|attn)/(out|o_proj|out_proj)/kernel", (MODEL_AXIS, None)),
    (r"(mlp|ffn|feed_forward)/(wi|fc1|up|gate)/kernel", (None, MODEL_AXIS)),
    (r"(mlp|ffn|feed_forward)/(wo|fc2|down)/kernel", (MODEL_AXIS, None)),
    (r"(token_embed|embedding|shared_embedding)/embedding", (MODEL_AXIS, None)),
)


def _spec_fits(spec: tuple, shape: tuple, mesh: Mesh) -> bool:
    """A spec only applies if its rank fits and every sharded dim divides
    evenly by its mesh axis size."""
    if len(spec) > len(shape):
        return False
    return all(axis is None or dim % mesh.shape[axis] == 0
               for dim, axis in zip(shape, spec))


def spec_for_path(path: str, shape: tuple, mesh: Mesh,
                  rules: Sequence[tuple[str, tuple]] = DEFAULT_PARTITION_RULES
                  ) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec if _spec_fits(spec, shape, mesh) else ()
    return ()


def _torch_dim(layout: tuple, role: str, flax_dim: int) -> int:
    """The torch dimension of a parameter that holds ``flax_dim`` of its
    flax leaf as its major part (so each rank's slice is contiguous)."""
    module, leaf, flax_shape = layout
    if isinstance(module, Dense) and leaf == "weight":
        n_in = 2 if role == "out" and len(flax_shape) == 3 else 1
        if flax_dim not in (0, n_in):
            raise NotImplementedError(
                f"splitting dimension {flax_dim} of a {flax_shape} kernel")
        return 1 if flax_dim < n_in else 0
    return flax_dim


def shard_pytree_by_rules(model: nn.Module, mesh: Mesh,
                          rules: Sequence[tuple[str, tuple]] =
                          DEFAULT_PARTITION_RULES) -> dict:
    """torch parameter name -> its ``Placement`` by the rules (on the
    unsharded model): the mesh axis, the torch dimension split along it
    and the flax dimension that dimension holds."""
    layouts = flax_layouts(model)
    out = {}
    for name, path in flax_paths(model).items():
        layout = layouts[name]
        spec = spec_for_path(path, tuple(layout[2]), mesh, rules)
        axes = [(i, a) for i, a in enumerate(spec) if a is not None]
        if len(axes) > 1:
            raise NotImplementedError(f"{path}: more than one split axis")
        if not axes:
            out[name] = Placement()
            continue
        flax_dim, axis = axes[0]
        role = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
        out[name] = Placement(axis, _torch_dim(layout, role, flax_dim),
                              flax_dim)
    return out


@dataclasses.dataclass
class Sharding:
    """A model's placements (torch name -> ``Placement``) and the names of
    the replicated parameters whose gradient each rank holds only in part
    (a column-parallel bias, used by slices), summed over 'model' by the
    train step."""
    placements: dict
    partial: frozenset

    def sharded(self, name: str) -> bool:
        return self.placements.get(name, Placement()).axis is not None


def _owner(model: nn.Module, name: str):
    """The innermost module with ``TP_LEAVES`` that holds parameter
    ``name``, and the parameter's name relative to it."""
    modules = dict(model.named_modules())
    parts = name.split(".")
    for cut in range(len(parts) - 1, -1, -1):
        mod = modules.get(".".join(parts[:cut]))
        rel = ".".join(parts[cut:])
        if mod is not None and rel in getattr(mod, "TP_LEAVES", ()):
            return ".".join(parts[:cut]), rel
    return None, None


def _axis(mesh: Mesh, name: str) -> Axis:
    return mesh.model if name == MODEL_AXIS else mesh.data


def shard_tensor(t: torch.Tensor, placement: Placement,
                 mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a full tensor (a copy)."""
    if placement.axis is None:
        return t.clone()
    axis = _axis(mesh, placement.axis)
    n = t.shape[placement.dim] // axis.size
    return t.narrow(placement.dim, axis.rank * n, n).clone()


def full_tensor(t: torch.Tensor, placement: Placement,
                mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's slice (an all-gather)."""
    if placement.axis is None:
        return t
    return all_gather(t.detach(), _axis(mesh, placement.axis),
                      placement.dim)


def gather_in_forward(module: nn.Module, leaf: str, axis: Axis,
                      dim: int) -> None:
    """The gathered form of ``module``'s split parameter ``leaf``: for
    the length of each forward call, ``module.<leaf>`` reads as the whole
    tensor (this rank's slice all-gathered along ``dim`` over ``axis``,
    whose backward keeps this rank's slice of the gradient); the
    parameter itself stays the slice."""
    def gather(mod, args):
        # an instance attribute shadows the parameter for attribute reads
        # (nn.Module looks its parameters up only when that fails)
        mod.__dict__[leaf] = gather_from_model(mod._parameters[leaf], axis,
                                               dim)

    def release(mod, args, out):
        mod.__dict__.pop(leaf, None)
    module.register_forward_pre_hook(gather)
    module.register_forward_hook(release, always_call=True)


def logical_to_mesh(model: nn.Module, mesh: Mesh,
                    rules: Sequence[tuple[str, tuple]] =
                    DEFAULT_PARTITION_RULES) -> Sharding:
    """Keep this rank's slice of every parameter the rules split (copies)
    and switch the owning modules to their parallel form, or a leaf with
    none to its gathered form (``gather_in_forward``); every module with
    ``use_mesh`` learns the mesh (the routers' and the sparse layer's
    batch statistics run over 'data')."""
    placements = shard_pytree_by_rules(model, mesh, rules)
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    by_owner: dict = {}
    for name, pl in placements.items():
        if pl.axis is None:
            continue
        owner, rel = _owner(model, name)
        if owner is None:
            mod_name, _, leaf = name.rpartition(".")
            gather_in_forward(modules[mod_name], leaf, _axis(mesh, pl.axis),
                              pl.dim)
        else:
            by_owner.setdefault(owner, set()).add(rel)
        with torch.no_grad():
            p = params[name]
            p.data = shard_tensor(p.data, pl, mesh)
    partial = set()
    for mod_name, mod in model.named_modules():
        if hasattr(mod, "use_mesh"):
            prefix = f"{mod_name}." if mod_name else ""
            partial |= {prefix + rel for rel in
                        mod.use_mesh(mesh, by_owner.get(mod_name, set()))}
    model.mesh = mesh
    model.mesh_sharding = Sharding(placements, frozenset(partial))
    return model.mesh_sharding


def process_rank() -> int:
    """This process's global rank: the process group's, else the
    launcher's ``RANK``, else 0."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank of the mesh (nothing on one process): a
    barrier over 'data', then one over 'model'. A rank leaves the second
    only when each rank of its 'model' group has left the first, which
    every rank of their 'data' groups had to enter."""
    if mesh is None or mesh.size == 1:
        return
    for axis in (mesh.data, mesh.model):
        if axis.size > 1:
            dist.barrier(group=axis.group)


def mesh_of(model: nn.Module) -> Optional[Mesh]:
    """The mesh ``logical_to_mesh`` placed ``model`` on, or None."""
    return getattr(model, "mesh", None)


__all__ = ["MeshConfig", "Mesh", "Placement", "Sharding", "create_mesh",
           "batch_sharding", "replicated", "local_rows",
           "DEFAULT_PARTITION_RULES", "spec_for_path",
           "shard_pytree_by_rules", "logical_to_mesh", "gather_in_forward",
           "mesh_of",
           "process_rank", "barrier",
           "shard_tensor", "full_tensor"]
