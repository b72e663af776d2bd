"""Generic VQA trainer (counterpart of vivqa_tpu/train/trainer.py): the
configurable trainer with gradient checkpointing, the freezing
strategies per epoch, early stopping, TensorBoard and wandb writers
behind their import gates, the SIGINT checkpoint, full resume, profiling
and the resource manager.

As in the JAX package:
- the step is ``train/state.py``'s ``make_train_step`` over the
  classification loss (cross-entropy plus ``moe_aux_weight`` x the MoE
  aux loss), the model in train mode with the step's generator;
- a freezing strategy is the optimizer's mask: the backward still runs
  through a frozen tower and ``grad_norm`` covers it;
- ``gradual_unfreeze`` has three stages (head only, + text, + visual),
  and at a stage change the WHOLE state is rebuilt: every optimizer
  moment resets, the step count and so the schedule restart at 0, and
  the dropout stream is re-derived from ``seed`` (the JAX package's
  ``_build_state``; a quirk of the reference, kept);
- a checkpoint holds the full state (parameters, optimizer state, step,
  seed), saved when the metric improves or on an interrupt; a resume
  restores it, or the parameters alone when the optimizer's state no
  longer fits, and continues at the saved epoch + 1.

Gradient checkpointing runs the forward under non-reentrant
``torch.utils.checkpoint``, which recomputes it in the backward. That
recompute must draw the same dropout as the first pass, and the model
draws from the step's explicit generator, which ``torch.utils.checkpoint``
does not preserve: ``checkpointed_forward`` restores the generator's
state at the start of both passes. Every attention call runs with
gradients in both passes, so on the card a checkpointed step launches
the forward with stats twice per call (72 times for the flagship's 36
calls) and the backward kernels once.

On a mesh (``mesh``, where the JAX trainer takes its own) every state is
placed (``train/state.py:place_state``) and the step is ``ShardedStep``'s;
the evaluation runs each rank's 'data' rows and gathers the logits over
'data' (the sparse MoE layer's capacity is the global batch's, so every
forward of a placed model takes a rank's rows); global rank 0 alone
writes the checkpoint
(the gathered state, the single-card format: a resume on any mesh
slices it) and the writers' logs.
"""

from __future__ import annotations

import dataclasses
import signal
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data.loader import device_prefetch
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.parallel.collectives import all_gather
from vivqa_tpu_torch.parallel.mesh import Mesh, barrier, local_rows, mesh_of
from vivqa_tpu_torch.pipelines.common import (EarlyStopping, StepTimer,
                                              load_params)
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              gathered_optimizer_state,
                                              gathered_params, partial_load)
from vivqa_tpu_torch.train.losses import cross_entropy_loss
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (ShardedStep, TrainState,
                                         make_train_step, place_state)
from vivqa_tpu_torch.train.strategies import trainable_mask
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class TrainerConfig(ConfigBase):
    num_epochs: int = 10
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    label_smoothing: float = 0.0
    moe_aux_weight: float = 0.01
    strategy: str = "full"                 # per-epoch strategies applied
    gradient_checkpointing: bool = False   # recompute the model forward
    early_stopping_patience: int = 5
    metric_for_best: str = "accuracy"
    checkpoint_dir: str = "checkpoints/trainer"
    max_checkpoints: int = 3
    resume: bool = True
    log_every: int = 10
    tensorboard_dir: str = ""              # "" = disabled
    wandb_project: str = ""                # "" = disabled (needs wandb pkg)
    profile_steps: tuple = ()              # (start, stop) step to trace
    profile_dir: str = "profiles"
    seed: int = 42


def checkpointed_forward(model: nn.Module, args: tuple,
                         generator: torch.Generator) -> dict:
    """``model(*args, generator=generator)`` under non-reentrant
    ``torch.utils.checkpoint``, the generator set to the same state at
    the start of the forward and of its recompute, so both draw the same
    dropout."""
    start = generator.get_state()

    def forward(*inputs):
        generator.set_state(start)
        return model(*inputs, generator=generator)
    return checkpoint(forward, *args, use_reentrant=False,
                      preserve_rng_state=False)


class VQATrainer:
    """Trains ``model`` (the classification contract: (pixel_values,
    input_ids, attention_mask) -> {"logits", "aux_loss"}) on ``device``
    (the model's own when None; the model is moved there)."""

    def __init__(self, config: TrainerConfig, model: nn.Module,
                 device: str | torch.device | None = None, logger=None,
                 resource_manager=None, mesh: Optional[Mesh] = None):
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            device = self.mesh.device
        self.device = (resolve_device(device) if device is not None
                       else next(model.parameters()).device)
        self.model = model.to(self.device)
        self.log = logger or get_pipeline_logger()
        self.rm = resource_manager
        self._interrupted = False
        self._tb = None
        main = self.mesh is None or self.mesh.is_main
        if config.tensorboard_dir and main:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(config.tensorboard_dir)
            except ImportError:
                self.log.warning("tensorboard unavailable; writer disabled")
        self._wandb = None
        if config.wandb_project and main:
            try:
                import wandb
                self._wandb = wandb.init(project=config.wandb_project,
                                         config=config.to_dict())
            except ImportError:
                self.log.warning("wandb unavailable; writer disabled")

    # -- building blocks ---------------------------------------------------
    def _loss_fn(self):
        cfg = self.config

        def loss_fn(model, batch, generator):
            args = (batch["pixel_values"], batch["input_ids"],
                    batch["attention_mask"])
            if cfg.gradient_checkpointing:
                out = checkpointed_forward(model, args, generator)
            else:
                out = model(*args, generator=generator)
            mesh = mesh_of(model)
            ce = cross_entropy_loss(out["logits"], batch["labels"],
                                    label_smoothing=cfg.label_smoothing,
                                    data=mesh.data if mesh else None)
            loss = ce + cfg.moe_aux_weight * out["aux_loss"]
            acc = (out["logits"].detach().argmax(-1)
                   == batch["labels"]).float().mean()
            return loss, {"accuracy": acc,
                          "aux_loss": out["aux_loss"].detach()}
        return loss_fn

    def freeze_mask(self, epoch: int = 0) -> Optional[dict]:
        cfg = self.config
        if cfg.strategy == "full":
            return None
        return trainable_mask(self.model, cfg.strategy, epoch, cfg.num_epochs)

    def _build_state(self, steps_per_epoch: int, epoch: int = 0
                     ) -> TrainState:
        """A fresh state over the model's current weights: new optimizer
        (zero moments, count 0) with the mask of ``epoch``, step 0, the
        dropout stream of ``seed``."""
        cfg = self.config
        sched = cfg.scheduler.replace(
            total_steps=max(1, steps_per_epoch * cfg.num_epochs))
        opt = create_optimizer(cfg.optimizer, self.model, sched,
                               self.freeze_mask(epoch))
        state = TrainState.create(self.model, opt, seed=cfg.seed)
        return state if self.mesh is None else place_state(state, self.mesh)

    # -- logging -------------------------------------------------------------
    def _log_step(self, step: int, metrics: Dict[str, float]) -> None:
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"train/{k}", float(v), step)
        if self._wandb is not None:
            self._wandb.log({f"train/{k}": float(v)
                             for k, v in metrics.items()}, step=step)

    def _log_epoch(self, epoch: int, metrics: Dict[str, float]) -> None:
        self.log.log_metrics(metrics, prefix=f"epoch{epoch}/")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"epoch/{k}", float(v), epoch)
        if self._wandb is not None:
            self._wandb.log({f"epoch/{k}": float(v)
                             for k, v in metrics.items()})

    # -- interrupt handling -----------------------------------------------------
    def _install_sigint(self):
        try:
            prev = signal.getsignal(signal.SIGINT)

            def handler(signum, frame):
                self._interrupted = True
                self.log.warning("SIGINT — finishing step then "
                                 "checkpointing")
            signal.signal(signal.SIGINT, handler)
            return prev
        except ValueError:          # not the main thread
            return None

    # -- checkpoint plumbing -------------------------------------------------
    @staticmethod
    def state_dict(state: TrainState) -> Dict:
        """The full resumable state: parameters, the optimizer's state
        (moments, count, accumulator, lookahead copy), the step and the
        seed of the dropout stream; whole (gathered) on a mesh."""
        return {"params": gathered_params(state.model, state.sharding,
                                          state.mesh),
                "optimizer": gathered_optimizer_state(
                    state.optimizer, state.sharding, state.mesh),
                "step": state.step, "seed": state.seed}

    def _restore_full(self, ckpt: CheckpointManager, state: TrainState):
        """Restore the latest checkpoint into ``state``: the parameters,
        and the optimizer's state, step and seed where they fit; where
        the optimizer's state does not (another optimizer or strategy, or
        a checkpoint of parameters alone), the parameters alone by name
        and shape with a warning, the optimizer fresh and the step
        continued."""
        saved, meta = ckpt.restore(map_location=self.device)
        parts = saved if "params" in saved else {"params": saved}
        if state.mesh is not None:
            load_params(self.model, parts["params"], state.sharding,
                        state.mesh)
        else:
            partial_load(parts["params"], self.model, self.log)
        try:
            state.optimizer.load_state_dict(parts["optimizer"])
        except (KeyError, ValueError, TypeError) as e:
            self.log.warning("optimizer state not restorable (%s) — "
                             "optimizer reset", e)
            state.optimizer = self._build_state(
                self._steps_per_epoch).optimizer
        state.step = int(parts.get("step", ckpt.latest_step() or 0))
        if parts.get("seed", state.seed) != state.seed:
            self.log.warning("checkpoint seed %s differs from the config's; "
                             "keeping the config's", parts["seed"])
        return state, meta

    # -- master loop -----------------------------------------------------------
    def _unfreeze_stage(self, epoch: int) -> int:
        """gradual_unfreeze has 3 stages (head-only / +text / +visual,
        reference training_utils.py:430-456); other strategies have 1."""
        if self.config.strategy != "gradual_unfreeze":
            return 0
        frac = epoch / max(1, self.config.num_epochs)
        return 2 if frac >= 2 / 3 else 1 if frac >= 1 / 3 else 0

    def train(self, train_loader, val_loader=None) -> Dict:
        """Train over ``train_loader`` (collated batches with a length),
        validating on ``val_loader`` each epoch. Returns {"state",
        "history", "best_metric", "interrupted"}."""
        cfg = self.config
        log = self.log
        self._steps_per_epoch = len(train_loader)
        state = self._build_state(len(train_loader))
        train_step = make_train_step(self._loss_fn())
        if self.mesh is not None:
            train_step = ShardedStep(self.mesh, train_step).compile(state)[0]
        current_stage = self._unfreeze_stage(0)

        ckpt = CheckpointManager(CheckpointConfig(
            directory=cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
            best_metric=cfg.metric_for_best))
        start_epoch = 0
        if cfg.resume and ckpt.latest_step() is not None:
            state, meta = self._restore_full(ckpt, state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            log.success(f"resumed from step {state.step} "
                        f"(epoch {start_epoch})")

        stopper = EarlyStopping(patience=cfg.early_stopping_patience,
                                mode="max")
        prev_sigint = self._install_sigint()
        history = []
        timer = StepTimer()
        profiler = None
        if self.rm is not None:
            self.rm.start_training(cfg.num_epochs, len(train_loader))
            self.rm.register_model("trainer_state", lambda: {
                n: p.detach() for n, p in self.model.named_parameters()})

        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                # gradual_unfreeze: rebuild the state when a new stage
                # unlocks (the reference applies the strategy per epoch,
                # vqa_trainer.py:894-900)
                stage = self._unfreeze_stage(epoch)
                if stage != current_stage:
                    current_stage = stage
                    state = self._build_state(len(train_loader), epoch)
                    log.success(f"gradual unfreeze: stage {stage} "
                                f"(epoch {epoch})")
                if self.rm is not None:
                    self.rm.start_epoch(epoch)
                losses = []
                timer.reset()
                for i, batch in enumerate(device_prefetch(iter(train_loader),
                                                          self.device)):
                    step = state.step
                    if cfg.profile_steps and step == cfg.profile_steps[0]:
                        profiler = self._start_profile()
                    timer.tic()
                    if self.mesh is not None:
                        batch = {k: v for k, v in batch.items()
                                 if isinstance(v, torch.Tensor)}
                    state, metrics = train_step(state, batch)
                    losses.append(metrics["loss"])   # stays on the device
                    timer.toc(batch["labels"].shape[0])
                    if profiler is not None and step == cfg.profile_steps[1]:
                        self._stop_profile(profiler)
                        profiler = None
                    if i % cfg.log_every == 0:
                        loss = float(metrics["loss"])
                        log.info("epoch %d step %d loss=%.4f", epoch, i, loss)
                        self._log_step(step, {"loss": loss,
                                              "accuracy": float(
                                                  metrics["accuracy"])})
                        if self.rm is not None:
                            self.rm.update_training_step(epoch, i, loss=loss)
                    if self.rm is not None and self.rm.should_shutdown():
                        self._interrupted = True
                    if self._interrupted:
                        break

                epoch_metrics = {
                    "train_loss": float(np.mean([float(x) for x in losses]))
                    if losses else 0.0,
                    "qa_pairs_per_sec": timer.items_per_sec}
                if val_loader is not None:
                    epoch_metrics.update(self.evaluate(val_loader))
                history.append({"epoch": epoch, **epoch_metrics})
                self._log_epoch(epoch, epoch_metrics)
                if self.rm is not None:
                    self.rm.end_epoch(epoch,
                                      epoch_metrics.get(cfg.metric_for_best))

                metric = epoch_metrics.get(cfg.metric_for_best, 0.0)
                if stopper.update(metric) or self._interrupted:
                    whole = self.state_dict(state)
                    if self.mesh is None or self.mesh.is_main:
                        ckpt.save(state.step, whole,
                                  metadata={"epoch": epoch,
                                            "interrupted": self._interrupted},
                                  metrics={cfg.metric_for_best: metric})
                    barrier(self.mesh)
                if self._interrupted:
                    log.warning("interrupt checkpoint saved; stopping")
                    break
                if stopper.should_stop:
                    log.warning(f"early stopping at epoch {epoch}")
                    break
        finally:
            if profiler is not None:
                self._stop_profile(profiler)
            if prev_sigint is not None:
                signal.signal(signal.SIGINT, prev_sigint)
            if self._tb is not None:
                self._tb.flush()
            if self._wandb is not None:
                self._wandb.finish()
            if self.rm is not None:
                if self._interrupted:
                    self.rm.fail_training("interrupted")
                else:
                    self.rm.complete_training()

        return {"state": state, "history": history,
                "best_metric": stopper.best,
                "interrupted": self._interrupted}

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        prof.__exit__(None, None, None)
        out = Path(self.config.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        self.log.success(f"profile trace in {out}")

    def evaluate(self, loader) -> Dict[str, float]:
        """Accuracy and mean NLL over ``loader``: the model in eval mode
        with no gradient, the first ``_num_valid`` rows of each batch."""
        total, correct, loss_sum = 0, 0.0, 0.0
        self.model.eval()
        for batch in device_prefetch(iter(loader), self.device):
            x = {k: batch[k] for k in ("pixel_values", "input_ids",
                                       "attention_mask")}
            if self.mesh is not None:
                x = local_rows(x, self.mesh)
            with torch.no_grad():
                out = self.model(x["pixel_values"], x["input_ids"],
                                 x["attention_mask"])
                logits = out["logits"].float()
                if self.mesh is not None:
                    logits = all_gather(logits, self.mesh.data)
                rows = (logits.argmax(-1) == batch["labels"]).float()
                logp = torch.log_softmax(logits, -1)
                nll = -logp.gather(-1, batch["labels"][:, None])[:, 0]
            nv = int(batch.get("_num_valid", rows.shape[0]))
            total += nv
            correct += float(rows[:nv].sum())
            loss_sum += float(nll[:nv].sum())
        return {"accuracy": correct / max(total, 1),
                "val_loss": loss_sum / max(total, 1)}
