"""Optimizer and learning-rate schedules (counterpart of
vivqa_tpu/train/optimizers.py), with optax's numerics rather than torch's
defaults:

- ``clip_by_global_norm``: scale every gradient by max_norm / norm only
  when norm > max_norm, with no epsilon (``clip_grad_norm_`` adds 1e-6);
- AdamW decays decoupled, only where ``decay_mask`` says so, with eps
  outside the square root; the schedule is read at the count BEFORE the
  update, so the first update of ``warmup_cosine`` uses lr = 0;
- the returned ``grad_norm`` is the global norm before clipping;
- ``accumulate_steps`` k > 1 is ``optax.MultiSteps``: every step adds
  its gradients to a running mean (acc += (g - acc) / (n + 1)), and only
  every k-th step applies clip + AdamW to that mean and advances the
  schedule's count; the parameters do not move in between.

The weight-decay mask matches ``NO_DECAY_PATTERNS`` on each parameter's
flax path (``models/from_jax.flax_paths``), as the JAX package matches its
param tree. Only ``adamw`` with an f32 first moment is ported; the other
optimizers, layer-wise decay and lookahead wait (ROADMAP.md, Queue A
item 12).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.models.from_jax import flax_paths

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


def global_grad_norm(grads: Iterable[Optional[torch.Tensor]]
                     ) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm);
    a missing gradient counts as zero."""
    grads = [g for g in grads if g is not None]
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, mask)) over
    a model's parameters, in ``optax.MultiSteps`` when
    ``accumulate_steps`` > 1; ``step()`` takes the parameters' ``.grad``
    and returns their global norm (before clipping and accumulation) as
    a tensor (no host sync). A parameter without a gradient is left as it
    is, as optax leaves a parameter whose gradient is zero (no decay
    applies to the leaves that have none on the main path). ``count`` is
    the number of updates applied, the schedule's count."""

    def __init__(self, model: nn.Module, config: OptimizerConfig,
                 schedule: Callable[[int], float]):
        mask = decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if mask[n]],
             "weight_decay": config.weight_decay},
            {"params": [p for n, p in named if not mask[n]],
             "weight_decay": 0.0}]
        self.inner = torch.optim.AdamW(
            [g for g in groups if g["params"]], lr=0.0,
            betas=(config.beta1, config.beta2), eps=config.eps)
        self.schedule = schedule
        self.clip_norm = config.grad_clip_norm
        self.count = 0
        self.accumulate_steps = config.accumulate_steps
        self.mini_step = 0
        self.acc: list = [None] * len(self.params)  # running mean of grads

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

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

    def step(self) -> torch.Tensor:
        norm = global_grad_norm(p.grad for p in self.params)
        clip_norm = norm
        if self.accumulate_steps > 1:
            if not self._accumulate():
                return norm
            # the clip sees the mean of the accumulated gradients
            clip_norm = global_grad_norm(p.grad for p in self.params)
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.clip_norm > 0:
            scale = torch.where(clip_norm < self.clip_norm, 1.0,
                                self.clip_norm / clip_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return norm


def create_optimizer(config: OptimizerConfig, model: nn.Module,
                     sched: Optional[SchedulerConfig] = None) -> Optimizer:
    """AdamW with the decay mask and global-norm clipping; the schedule
    from ``sched`` (a constant ``config.learning_rate`` without one)."""
    if config.accumulate_steps < 1:
        raise ValueError(f"accumulate_steps {config.accumulate_steps} < 1")
    unported = {"layer_decay": config.layer_decay != 0.0,
                "lookahead": config.lookahead,
                "mu_dtype": config.mu_dtype != "float32"}
    if config.name != "adamw" or any(unported.values()):
        raise NotImplementedError(
            f"optimizer '{config.name}' with "
            f"{[k for k, v in unported.items() if v]} is not ported yet: "
            f"only adamw with an f32 first moment (ROADMAP.md, Queue A "
            f"item 12)")
    schedule = (create_schedule(sched, config.learning_rate)
                if sched is not None else (lambda count: config.learning_rate))
    return Optimizer(model, config, schedule)
