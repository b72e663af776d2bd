"""Optimizers and learning-rate schedules (counterpart of
vivqa_tpu/train/optimizers.py), written out to optax's formulas rather
than taken from ``torch.optim``, whose variants differ:

- ``clip_by_global_norm``: scale every gradient by max_norm / norm only
  when norm > max_norm, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- ``adamw`` / ``adam``: eps outside the square root, decoupled decay
  (adamw) only where ``decay_mask`` says so; ``mu_dtype="bfloat16"``
  stores μ in bf16 and, as optax, uses the unrounded μ in the update of
  the step that computes it (``_bf16_moment``: the jitted JAX step also
  rounds β1 to bf16);
- ``sgd``: decayed weights, then the momentum trace g + m t;
- ``radam``: decayed weights, then optax's rectified Adam (threshold 5);
- ``lamb``: Adam, decayed weights, then a trust ratio ‖p‖ / ‖u‖ per leaf;
- ``adafactor``: optax's factored second moment without clipping or
  parameter scaling, the two largest dimensions of each *flax* leaf
  factored where the second is at least 128 (so a (D, H, Dh) attention
  kernel is not), momentum as an EMA of beta1, decayed weights added
  after the learning rate;
- the schedule is read at the count BEFORE the update, so the first
  update of ``warmup_cosine`` uses lr = 0;
- ``layer_decay`` scales each update after the inner optimizer by
  decay^(L - 1 - i), i the ``layers_<i>`` of its flax path;
- ``lookahead`` keeps a slow copy and every k-th update moves the
  parameters to slow + α (fast - slow);
- a freeze mask (``train/strategies.py``) is optax's ``multi_transform``
  with ``set_to_zero``: frozen parameters get no update, decay or state,
  and the clip sees only the trainable gradients;
- the returned ``grad_norm`` is the global norm of every gradient, frozen
  ones too, before clipping;
- ``accumulate_steps`` k > 1 is ``optax.MultiSteps``: every step adds
  its gradients to a running mean (acc += (g - acc) / (n + 1)), and only
  every k-th step applies the chain to that mean and advances the
  schedule's count; the parameters do not move in between.

On a mesh (``use_mesh``, from ``train/state.py:place_state``) the
parameters are this rank's shards and ``step()`` first makes the
gradients the global batch's: the column-parallel biases' partial
gradients summed over 'model', then every gradient averaged over 'data'
(one flat all-reduce each). The global norm sums each split leaf's
squares over 'model' and counts each replicated leaf once; LAMB's norms
per leaf do the same. Adam, AdamW, SGD and RAdam are elementwise and run
on the shards, as do the layer-wise scales and the lookahead. Adafactor
factors by the dimensions of the whole flax leaf: a statistic that
averages over the split dimension sums its slice, sums that over 'model'
and divides by the whole length (so it is whole on every rank), and a
statistic that keeps the split dimension keeps this rank's slice of it
(``state_placement``); its elementwise terms run on the shards. Under
'data' alone nothing is split and every optimizer runs unchanged.

Masks and scales match on each parameter's flax path
(``models/from_jax.flax_paths``), as the JAX package matches its param
tree. Adam and AdamW run as a few ``torch._foreach_*`` calls over all
parameters; the others go parameter by parameter.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Iterable, Optional

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.models.from_jax import (check_one_to_one, flax_layouts,
                                             flax_paths, from_flax_view,
                                             to_flax_view)
from vivqa_tpu_torch.parallel.collectives import all_reduce

OPTIMIZERS = ("adamw", "adam", "sgd", "radam", "lamb", "adafactor")
MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

NO_DECAY_PATTERNS = (r"bias", r"/ln[0-9_a-z]*/", r"layernorm", r"ln_",
                     r"_embed/embedding", r"cls_token", r"pos_embed",
                     r"scale$")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig(ConfigBase):
    name: str = "adamw"             # adamw | adam | sgd | radam | lamb
    #                               # | adafactor
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    momentum: float = 0.9           # sgd
    grad_clip_norm: float = 1.0
    lookahead: bool = False
    lookahead_sync: int = 5
    lookahead_slow_step: float = 0.5
    layer_decay: float = 0.0        # 0 = off; e.g. 0.9 for LLRD
    accumulate_steps: int = 1
    # dtype of the Adam-family first moment (adam, adamw, adafactor's
    # momentum): "bfloat16" | "float32"
    mu_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SchedulerConfig(ConfigBase):
    name: str = "warmup_cosine"     # warmup_cosine | warmup_linear |
    # polynomial | step | onecycle | constant
    warmup_steps: int = 0
    warmup_ratio: float = 0.1       # used if warmup_steps == 0
    total_steps: int = 10000
    min_lr_ratio: float = 0.0
    power: float = 1.0              # polynomial
    step_size: int = 1000           # step decay
    gamma: float = 0.5              # step decay


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """torch parameter name -> True where weight decay applies."""
    return {name: not any(re.search(p, path.lower())
                          for p in NO_DECAY_PATTERNS)
            for name, path in flax_paths(model).items()}


def layer_decay_scales(model: nn.Module, decay: float) -> dict[str, float]:
    """torch parameter name -> its update's scale: decay^(L - i) for the
    ``layers_<i>`` of its flax path, L the largest such i of the model
    (at least 0); 1 where the path names no layer."""
    ids = {}
    for name, path in flax_paths(model).items():
        m = re.search(r"layers_(\d+)", path.lower())
        ids[name] = int(m.group(1)) if m else -1
    top = max(list(ids.values()) + [0])
    return {n: 1.0 if i < 0 else decay ** (top - i) for n, i in ids.items()}


def _polynomial(init: float, end: float, power: float, steps: int):
    """optax.polynomial_schedule (linear for power 1)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac ** power + end
    return schedule


def _cosine(init: float, steps: int, alpha: float):
    """optax.cosine_decay_schedule."""
    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _join(first, second, boundary: int):
    """optax.join_schedules with one boundary."""
    return lambda count: first(count) if count < boundary \
        else second(count - boundary)


def _cosine_onecycle(total: int, peak: float, pct_start: float,
                     div_factor: float = 25.0,
                     final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule: cosine from peak / div_factor up
    to peak over the first ``int(pct_start * total)`` steps, then down to
    peak / (div_factor * final_div_factor) at ``total``, flat after."""
    bounds = (0, int(pct_start * total), int(total))
    values = (peak / div_factor, peak,
              peak / (div_factor * final_div_factor))

    def schedule(count):
        if count >= bounds[2]:
            return values[2]
        i = 0 if count < bounds[1] else 1
        pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
        return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
            math.cos(math.pi * pct) + 1)
    return schedule


def create_schedule(sched: SchedulerConfig,
                    base_lr: float) -> Callable[[int], float]:
    """Step count -> learning rate, as the JAX package's optax schedules
    (computed in f64 here, in f32 there)."""
    warmup = sched.warmup_steps or max(1, int(sched.warmup_ratio
                                              * sched.total_steps))
    warmup = min(warmup, max(0, sched.total_steps - 1))
    decay_steps = max(1, sched.total_steps - warmup)
    end = base_lr * sched.min_lr_ratio
    if sched.name == "constant":
        return lambda count: base_lr
    if sched.name == "warmup_cosine":
        alpha = 0.0 if base_lr == 0.0 else end / base_lr
        return _join(_polynomial(0.0, base_lr, 1.0, warmup),
                     _cosine(base_lr, sched.total_steps - warmup, alpha),
                     warmup)
    if sched.name == "warmup_linear":
        return _join(_polynomial(0.0, base_lr, 1.0, warmup),
                     _polynomial(base_lr, end, 1.0, decay_steps), warmup)
    if sched.name == "polynomial":
        return _join(_polynomial(0.0, base_lr, 1.0, warmup),
                     _polynomial(base_lr, end, sched.power, decay_steps),
                     warmup)
    if sched.name == "step":
        bounds = [i * sched.step_size for i in range(
            1, max(1, sched.total_steps // sched.step_size) + 1)]
        return lambda count: base_lr * sched.gamma ** sum(
            count >= b for b in bounds)
    if sched.name == "onecycle":
        # optax NaNs on zero-width ramp intervals: need total >= 2 and
        # pct_start strictly inside (0, 1)
        total = max(sched.total_steps, 2)
        pct = min(max(warmup / total, 1.0 / total), 1.0 - 1.0 / total)
        return _cosine_onecycle(total, base_lr, pct)
    raise ValueError(f"unknown scheduler '{sched.name}'")


def leaf_norms(tensors: list) -> list:
    """The 2-norm of each tensor, as f32 0-d tensors. On the card the f32
    tree reduction; on the CPU the sum runs in f64, since the CPU's f32
    norm of a large leaf drifts (3.9e-3 relative over the 49M elements of
    the flagship's embedding)."""
    if tensors and tensors[0].device.type == "cpu":
        return [n.float() for n in torch._foreach_norm(
            [t.double() for t in tensors])]
    return torch._foreach_norm([t.float() for t in tensors])


def global_grad_norm(grads: Iterable[Optional[torch.Tensor]]
                     ) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm);
    a missing gradient counts as zero."""
    norms = leaf_norms([g for g in grads if g is not None])
    return torch.linalg.vector_norm(torch.stack(norms))


def factored_dims(shape: tuple, min_dim_size_to_factor: int = 128
                  ) -> Optional[tuple[int, int]]:
    """optax ``factorized._factored_dims``: the axes of the second largest
    and the largest dimension of ``shape``, or None where the second is
    below ``min_dim_size_to_factor`` (or the leaf has fewer than 2)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _f32(x) -> float:
    return float(np.float32(x))


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32, as optax computes it."""
    return _f32(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def _bf16_moment(grads: list, moments: list, decay: float) -> list:
    """optax's moment update (1 - decay) g + decay t over a bf16 moment
    t, as the jitted JAX step computes it on the CPU: ``decay`` takes t's
    dtype (0.9 -> 0.8984375), XLA fuses the two products and the sum
    into one rounding to f32 (here: exact in f64, then rounded), and
    this step's update uses that f32 result, which the state stores
    rounded to bf16 (``optax.tree.cast``)."""
    a = _f32(1 - decay)
    d = float(torch.tensor(decay, dtype=torch.bfloat16))
    out = [(a * g.double() + d * t.double()).float()
           for g, t in zip(grads, moments)]
    for t, x in zip(moments, out):
        t.copy_(x)
    return out


def _whole_layouts(model: nn.Module, layouts: dict) -> dict:
    """``flax_layouts`` with the whole flax shape of each parameter that
    a mesh has already split (a model placed by ``logical_to_mesh``)."""
    sharding = getattr(model, "mesh_sharding", None)
    if sharding is None:
        return layouts
    size = model.mesh.model.size
    out = dict(layouts)
    for n, (module, leaf, shape) in layouts.items():
        pl = sharding.placements.get(n)
        if pl is not None and pl.axis is not None:
            out[n] = (module, leaf, tuple(d * size if j == pl.flax_dim
                                          else d
                                          for j, d in enumerate(shape)))
    return out


# the optimizer state: per parameter, by optimizer (adafactor's v_row /
# v_col hold the factored leaves' statistics in the flax layout, v the
# others'; ema its momentum)
_STATE = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "sgd": ("trace",),
          "radam": ("mu", "nu"), "lamb": ("mu", "nu"),
          "adafactor": ("v_row", "v_col", "v", "ema")}


class Optimizer:
    """The JAX package's optax chain over a model's parameters:
    clip_by_global_norm(clip) -> the optimizer (with the schedule and the
    decay mask) -> layer-wise scales -> lookahead, under the freeze mask
    and in ``optax.MultiSteps`` when ``accumulate_steps`` > 1.

    ``step()`` takes the parameters' ``.grad`` (a missing one counts as
    zero, as optax sees a zero gradient) and returns the global norm of
    all of them (before clipping and accumulation) as a tensor, with no
    host sync. ``count`` is the number of updates applied, the schedule's
    count. ``state`` holds the per-parameter state by field (``_STATE``),
    each a list aligned with ``params``, the trainable parameters."""

    def __init__(self, model: nn.Module, config: OptimizerConfig,
                 schedule: Callable[[int], float],
                 freeze_mask: Optional[dict] = None):
        if config.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer '{config.name}' "
                             f"(choices: {OPTIMIZERS})")
        if config.mu_dtype not in MU_DTYPES:
            raise ValueError(f"unknown mu_dtype '{config.mu_dtype}' "
                             f"(choices: {tuple(MU_DTYPES)})")
        if config.accumulate_steps < 1:
            raise ValueError(f"accumulate_steps {config.accumulate_steps} < 1")
        self.config = config
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.all_names = [n for n, _ in named]
        self.all_params = [p for _, p in named]
        freeze_mask = freeze_mask or {}
        kept = [(n, p) for n, p in named if freeze_mask.get(n, True)]
        self.names = [n for n, _ in kept]
        self.params = [p for _, p in kept]
        self.frozen = len(kept) < len(named)
        mask = decay_mask(model)
        self.decays = [mask[n] for n in self.names]
        self.scales = None
        if config.layer_decay:
            scales = layer_decay_scales(model, config.layer_decay)
            self.scales = [scales[n] for n in self.names]
        if config.name == "lamb":
            check_one_to_one(model)      # the trust ratio is per flax leaf
        layouts = _whole_layouts(model, flax_layouts(model))
        self.layouts = [layouts[n] for n in self.names]
        # the flax layouts of the tensors this rank holds (``use_mesh``)
        self.views = list(self.layouts)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.schedule = schedule
        self.clip_norm = config.grad_clip_norm
        self.count = 0
        self.accumulate_steps = config.accumulate_steps
        self.mini_step = 0
        self.acc: list = [None] * len(self.params)  # running mean of grads
        self.mu_dtype = MU_DTYPES[config.mu_dtype]
        self.state = self._init_state()
        self.slow = ([p.detach().clone() for p in self.params]
                     if config.lookahead else None)
        self.lookahead_count = 0
        self.mesh = self.sharding = None
        self.split = [False] * len(self.params)

    def use_mesh(self, mesh, sharding) -> None:
        """Switch to this rank's shards (``parallel/mesh.py:Sharding``):
        the per-parameter state keeps the slices ``state_placement``
        gives, the parameters' own where it is of their shape (the
        parameters ``logical_to_mesh`` has already cut)."""
        self.mesh, self.sharding = mesh, sharding
        self.split = [sharding.sharded(n) for n in self.names]
        self.all_split = [sharding.sharded(n) for n in self.all_names]
        self.all_partial = [n in sharding.partial for n in self.all_names]
        fields = dict(self.state, slow=self.slow or [], acc=self.acc)
        for i, (n, p) in enumerate(zip(self.names, self.params)):
            if not self.split[i]:
                continue
            module, leaf, whole = self.layouts[i]
            pl = sharding.placements[n]
            self.views[i] = (module, leaf, tuple(
                d // mesh.model.size if j == pl.flax_dim else d
                for j, d in enumerate(whole)))
            for field, ts in fields.items():
                if i < len(ts) and ts[i] is not None:
                    ts[i] = self._own_slice(field, n, ts[i])

    def state_placement(self, field: str, name: str):
        """Where the ``field`` state of parameter ``name`` lies on the mesh
        (``parallel/mesh.py:Placement``): the parameter's placement for a
        tensor of its shape; adafactor's factored statistics (``v_row``
        averages over the largest dimension of the flax leaf, ``v_col``
        over the second largest) are whole where they average over the
        split dimension and split at its place among their own dimensions
        otherwise; the size-1 placeholders are whole."""
        from vivqa_tpu_torch.parallel.mesh import Placement
        pl = (self.sharding.placements.get(name, Placement())
              if self.sharding is not None else Placement())
        if pl.axis is None or self.config.name != "adafactor" or \
                field not in ("v_row", "v_col", "v"):
            return pl
        dims = factored_dims(self.layouts[self.index[name]][2])
        if field == "v" or dims is None:
            return pl if (field == "v") == (dims is None) else Placement()
        gone = dims[1] if field == "v_row" else dims[0]
        if pl.flax_dim == gone:
            return Placement()
        d = pl.flax_dim - (pl.flax_dim > gone)
        return Placement(pl.axis, d, d)

    def _global_norm(self, grads: list, split: list) -> torch.Tensor:
        """``global_grad_norm`` of this rank's gradients, each split leaf's
        squares summed over 'model'."""
        if self.mesh is None or self.mesh.model.size == 1:
            return global_grad_norm(grads)
        sq = [torch.zeros((), device=self.all_params[0].device)] * 2
        kept = [(g, sp) for g, sp in zip(grads, split) if g is not None]
        norms = leaf_norms([g for g, _ in kept])
        for (_, sp), n in zip(kept, norms):
            sq[sp] = sq[sp] + n * n
        return torch.sqrt(sq[0] + all_reduce(sq[1], self.mesh.model))

    def _reduce_gradients(self) -> None:
        """The global batch's gradients: partial ones summed over 'model',
        then all averaged over 'data' (a missing gradient is a zero)."""
        m = self.mesh
        if m.model.size > 1:
            part = [p for p, f in zip(self.all_params, self.all_partial)
                    if f and p.grad is not None]
            if part:
                flat = all_reduce(torch.cat([p.grad.reshape(-1)
                                             for p in part]), m.model)
                self._unflatten(flat, part)
        if m.data.size > 1:
            for p in self.all_params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = all_reduce(torch.cat([p.grad.reshape(-1)
                                         for p in self.all_params]), m.data)
            self._unflatten(flat / m.data.size, self.all_params)

    @staticmethod
    def _unflatten(flat: torch.Tensor, params: list) -> None:
        """Each parameter's gradient: its view of the reduced ``flat``."""
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    # -- state ---------------------------------------------------------------
    def _init_state(self) -> dict:
        cfg, ps = self.config, self.params
        zeros = lambda dtype=torch.float32: [
            torch.zeros_like(p, dtype=dtype) for p in ps]
        if cfg.name in ("adamw", "adam"):
            return {"mu": zeros(self.mu_dtype), "nu": zeros()}
        if cfg.name in ("radam", "lamb"):
            return {"mu": zeros(), "nu": zeros()}
        if cfg.name == "sgd":
            return {"trace": zeros()}
        state = {"v_row": [], "v_col": [], "v": [],
                 "ema": zeros(self.mu_dtype) if cfg.beta1 > 0 else []}
        one = lambda p: torch.zeros(1, device=p.device)
        for p, lay in zip(ps, self.layouts):
            dims = factored_dims(lay[2])
            if dims is None:
                state["v_row"].append(one(p))
                state["v_col"].append(one(p))
                state["v"].append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                shape = list(lay[2])
                state["v_row"].append(torch.zeros(
                    shape[:d0] + shape[d0 + 1:], device=p.device))
                state["v_col"].append(torch.zeros(
                    shape[:d1] + shape[d1 + 1:], device=p.device))
                state["v"].append(one(p))
        return state

    def state_dict(self) -> dict:
        """Everything a resume needs, keyed by parameter name."""
        by_name = lambda ts: {n: t for n, t in zip(self.names, ts)
                              if t is not None}
        out = {"count": self.count, "mini_step": self.mini_step,
               "lookahead_count": self.lookahead_count,
               "acc": by_name(self.acc),
               "state": {f: by_name(ts) for f, ts in self.state.items()}}
        if self.slow is not None:
            out["slow"] = by_name(self.slow)
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict()``'s output (tensors moved to and cast
        as this optimizer's own); raises where a parameter's state is
        missing or of another shape."""
        self.count = int(sd["count"])
        self.mini_step = int(sd.get("mini_step", 0))
        self.lookahead_count = int(sd.get("lookahead_count", 0))
        acc = sd.get("acc", {})
        self.acc = [self._own_slice("acc", n, acc[n]).to(p.device).clone()
                    if n in acc else None
                    for n, p in zip(self.names, self.params)]
        fields = dict(sd["state"])
        if self.slow is not None:
            fields["slow"] = sd["slow"]
        self.load_fields(fields)

    def _own_slice(self, field: str, name: str,
                   src: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole state tensor (one built over the
        whole parameter, or a checkpoint's); a tensor already of the
        slice's size, or of a leaf that is not split, as it is."""
        pl = self.state_placement(field, name)
        if pl.axis is None:
            return src
        whole = self.layouts[self.index[name]][2]
        dims = factored_dims(whole)
        numel = int(np.prod(whole))
        if field in ("v_row", "v_col") and dims is not None:
            numel //= whole[dims[1] if field == "v_row" else dims[0]]
        if src.numel() != numel:
            return src
        from vivqa_tpu_torch.parallel.mesh import shard_tensor
        return shard_tensor(src, pl, self.mesh)

    def load_fields(self, fields: dict) -> None:
        """Set per-parameter state from {field: {name: tensor}} (also
        ``models/from_jax.optimizer_state_from_flax``'s output; its
        ``count`` sets ``count``)."""
        if "count" in fields:
            self.count = self.lookahead_count = int(fields["count"])
        for field, by_name in fields.items():
            if field == "count":
                continue
            own = self.slow if field == "slow" else self.state[field]
            for i, n in enumerate(self.names):
                src = self._own_slice(field, n, by_name[n])
                if tuple(src.shape) != tuple(own[i].shape):
                    raise ValueError(f"{field} of {n}: {tuple(src.shape)} "
                                     f"!= {tuple(own[i].shape)}")
                own[i].copy_(src.to(own[i].device, own[i].dtype))

    def zero_grad(self) -> None:
        for p in self.all_params:
            p.grad = None

    # -- the chain -----------------------------------------------------------
    def _accumulate(self) -> bool:
        """Fold this step's gradients into the running mean; True when
        the mean is due (in ``.grad``) and an update applies now."""
        n = self.mini_step
        for i, p in enumerate(self.params):
            if p.grad is None:      # a zero gradient
                if self.acc[i] is not None:
                    self.acc[i].mul_(n / (n + 1))
            elif self.acc[i] is None:
                # optax's accumulator starts at zeros
                self.acc[i] = p.grad / (n + 1)
            else:
                self.acc[i].add_((p.grad - self.acc[i]) / (n + 1))
        self.mini_step = (n + 1) % self.accumulate_steps
        if self.mini_step:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.acc = [None] * len(self.params)
        return True

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        if self.mesh is not None:
            self._reduce_gradients()
            norm = self._global_norm([p.grad for p in self.all_params],
                                     self.all_split)
        else:
            norm = global_grad_norm(p.grad for p in self.all_params)
        clip_norm = norm if not self.frozen else None
        if self.accumulate_steps > 1:
            if not self._accumulate():
                return norm
            clip_norm = None        # the clip sees the accumulated mean
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip_norm > 0:
            if clip_norm is None:
                clip_norm = self._global_norm(grads, self.split)
            scale = torch.where(clip_norm < self.clip_norm, 1.0,
                                self.clip_norm / clip_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        updates = getattr(self, f"_{self.config.name}")(grads, lr)
        if self.scales is not None:
            torch._foreach_mul_(updates, self.scales)
        if self.slow is not None:
            updates = self._lookahead(updates)
        torch._foreach_add_(self.params, updates)
        self.count += 1
        return norm

    def _decayed(self, updates: list) -> list:
        """optax.add_decayed_weights under the decay mask: u + wd p."""
        wd = self.config.weight_decay
        return [u + wd * p if d else u
                for u, p, d in zip(updates, self.params, self.decays)]

    def _adam_direction(self, grads: list, mu_dtype) -> list:
        """optax.scale_by_adam: the moments' update, then
        mu_hat / (sqrt(nu_hat) + eps)."""
        cfg = self.config
        b1, b2, t = cfg.beta1, cfg.beta2, self.count + 1
        mu, nu = self.state["mu"], self.state["nu"]
        if mu_dtype == torch.float32:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            m = mu
        else:
            m = _bf16_moment(grads, mu, b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        den = torch._foreach_div(nu, _bias_correction(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        out = torch._foreach_div(m, _bias_correction(b1, t))
        torch._foreach_div_(out, den)
        return out

    def _adamw(self, grads: list, lr: float) -> list:
        out = self._adam_direction(grads, self.mu_dtype)
        wd = self.config.weight_decay
        decayed = [i for i, d in enumerate(self.decays) if d]
        if wd and decayed:
            torch._foreach_add_([out[i] for i in decayed],
                                [self.params[i] for i in decayed], alpha=wd)
        torch._foreach_mul_(out, -lr)
        return out

    def _adam(self, grads: list, lr: float) -> list:
        out = self._adam_direction(grads, self.mu_dtype)
        torch._foreach_mul_(out, -lr)
        return out

    def _sgd(self, grads: list, lr: float) -> list:
        g = self._decayed(grads)
        trace = self.state["trace"]
        torch._foreach_mul_(trace, self.config.momentum)
        torch._foreach_add_(trace, g)
        return torch._foreach_mul(trace, -lr)

    def _radam(self, grads: list, lr: float) -> list:
        """Decayed weights, then optax.scale_by_radam (threshold 5; its
        scalars in f32, as optax computes them)."""
        cfg = self.config
        b1, b2, t = cfg.beta1, cfg.beta2, self.count + 1
        g = self._decayed(grads)
        mu, nu = self.state["mu"], self.state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        f = np.float32
        ro_inf = 2 / (1 - b2) - 1
        b2t = f(b2) ** f(t)
        ro = f(ro_inf) - f(2 * t) * b2t / (f(1.0) - b2t)
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, t))
        if ro >= 5.0:
            r = np.sqrt((ro - f(4.0)) * (ro - f(2.0)) * f(ro_inf)
                        / (f((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            den = torch._foreach_div(nu, _bias_correction(b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, cfg.eps)
            torch._foreach_mul_(mu_hat, _f32(r))
            torch._foreach_div_(mu_hat, den)
        torch._foreach_mul_(mu_hat, -lr)
        return mu_hat

    def _lamb(self, grads: list, lr: float) -> list:
        """Adam, decayed weights, then optax.scale_by_trust_ratio:
        u ‖p‖ / ‖u‖ per leaf (u where either norm is 0)."""
        out = self._decayed(self._adam_direction(grads, torch.float32))
        p_norms = self._leaf_norms(self.params)
        u_norms = self._leaf_norms(out)
        for u, pn, un in zip(out, p_norms, u_norms):
            zero = (pn == 0.0) | (un == 0.0)
            u.mul_(torch.where(zero, 1.0, pn / un))
        torch._foreach_mul_(out, -lr)
        return out

    def _leaf_norms(self, tensors: list) -> list:
        """``leaf_norms``, a split leaf's squares summed over 'model'."""
        norms = leaf_norms(tensors)
        if self.mesh is None or not any(self.split):
            return norms
        idx = [i for i, sp in enumerate(self.split) if sp]
        sq = all_reduce(torch.stack([norms[i] * norms[i] for i in idx]),
                        self.mesh.model)
        for j, i in enumerate(idx):
            norms[i] = torch.sqrt(sq[j])
        return norms

    def _mean(self, x: torch.Tensor, dim: int, split: Optional[int],
              length: int, keepdim: bool = False) -> torch.Tensor:
        """``x.mean(dim)``; where ``dim`` is the dimension split over
        'model' (``split``), the slice's sum summed over 'model' and
        divided by the whole ``length``."""
        if dim != split:
            return x.mean(dim, keepdim=keepdim)
        return all_reduce(x.sum(dim, keepdim=keepdim),
                          self.mesh.model) / length

    def _adafactor(self, grads: list, lr: float) -> list:
        """optax.adafactor as the JAX package builds it: factored RMS (in
        the flax layout, factored by the whole leaf's dimensions), the
        learning rate, the momentum EMA, decayed weights, a sign flip."""
        cfg = self.config
        t = np.float32(self.count + 1)
        decay = _f32(np.float32(1.0) - t ** np.float32(-0.8))
        keep = _f32(np.float32(1.0) - np.float32(decay))
        st = self.state
        out = []
        for i, (g, p, lay) in enumerate(zip(grads, self.params,
                                            self.layouts)):
            dims = factored_dims(lay[2])
            if dims is None:
                v = st["v"][i]
                v.mul_(decay).add_(keep * (g * g + 1e-30))
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                s = (self.sharding.placements[self.names[i]].flax_dim
                     if self.split[i] else None)
                gf = to_flax_view(self.views[i], g)
                sq = gf * gf + 1e-30
                v_row, v_col = st["v_row"][i], st["v_col"][i]
                v_row.mul_(decay).add_(keep * self._mean(sq, d0, s,
                                                         lay[2][d0]))
                v_col.mul_(decay).add_(keep * self._mean(sq, d1, s,
                                                         lay[2][d1]))
                reduced = d1 - 1 if d1 > d0 else d1
                row_split = None if s in (None, d0) else s - (s > d0)
                row = (v_row / self._mean(v_row, reduced, row_split,
                                          lay[2][d1], keepdim=True)) ** -0.5
                col = v_col ** -0.5
                u = from_flax_view(lay, gf * row.unsqueeze(d0)
                                   * col.unsqueeze(d1), p.shape)
            out.append(u * lr)
        if cfg.beta1 > 0:
            b1 = cfg.beta1
            if self.mu_dtype == torch.float32:
                out = [(1 - b1) * u + b1 * e for u, e in zip(out, st["ema"])]
                for e, u in zip(st["ema"], out):
                    e.copy_(u)
            else:
                out = _bf16_moment(out, st["ema"], b1)
        if cfg.weight_decay:
            out = self._decayed(out)
        return [-u for u in out]

    def _lookahead(self, updates: list) -> list:
        """Every ``lookahead_sync``-th update moves the parameters to
        slow + α (p + u - slow) and syncs the slow copy to them."""
        cfg = self.config
        self.lookahead_count += 1
        if self.lookahead_count % cfg.lookahead_sync:
            return updates
        out = []
        for u, p, s in zip(updates, self.params, self.slow):
            new = s + cfg.lookahead_slow_step * ((p + u) - s) - p
            s.copy_(p + new)
            out.append(new)
        return out


def create_optimizer(config: OptimizerConfig, model: nn.Module,
                     sched: Optional[SchedulerConfig] = None,
                     freeze_mask: Optional[dict] = None) -> Optimizer:
    """``config.name`` with the decay mask and global-norm clipping, the
    schedule from ``sched`` (a constant ``config.learning_rate`` without
    one); ``freeze_mask``: {name: trainable} (``train/strategies.py``)."""
    schedule = (create_schedule(sched, config.learning_rate)
                if sched is not None else (lambda count: config.learning_rate))
    return Optimizer(model, config, schedule, freeze_mask)
