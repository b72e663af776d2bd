"""Classification training pipeline (counterpart of
vivqa_tpu/pipelines/training_pipeline.py, with its config fields and
defaults).

Counterpart of src/core/training_pipeline.py:84-870 in the reference:
seeding, AdamW with no-decay groups and the warmup-cosine schedule, the
epoch loop with clipping, per-epoch validation computing the full metric
dict (VQA soft accuracy + exact match + BLEU/METEOR/ROUGE/CIDEr/P-R-F1
over decoded answer strings, reference :536-741), sample prediction
display, best-metric checkpointing (params + num_answers + vocabulary +
epoch), early stopping, resume, a scheduled dropout rate, and a final
evaluation that reloads the best checkpoint.

The loop is the JAX package's: the step is ``train/state.py``'s
``make_train_step(classification_loss_fn(...))`` in train mode, the
losses stay on the device until the epoch ends (read on log steps too),
the batches reach the device through ``data/loader.py:device_prefetch``.
Validation runs the model in eval mode with no gradient, so on the card
every attention call goes through the serving forward kernel, and every
train step through the three training kernels. A ``KnowledgeProvider``
that wraps the loaders adds its arrays to the batches, and both the step
and the validation pass them to the model. Gradient accumulation is
the optimizer's (``optax.MultiSteps``): the schedule spans steps /
``accumulate_steps`` updates. ``mix_mode`` mixes each training batch
(MixUp, CutMix or a coin between them, ``ops/batch_mix.py``) before the
forward; ``strategy`` freezes by the mask of epoch 0 for the whole run,
as the JAX pipeline does (so ``gradual_unfreeze`` never unlocks an
encoder here; ``train/trainer.py`` rebuilds per stage).

On a mesh (``ModelPipelineOutput.mesh``, passed to ``run`` and
``validate``) the state is placed (``train/state.py:place_state``) and
the step is ``ShardedStep``'s: every rank loads the global batch and
trains on its 'data' rows; validation runs each rank's rows and gathers
the logits over 'data' before the metrics, so every rank computes the
same metrics. A checkpoint holds the gathered, whole parameters, written
by global rank 0 alone (the single-card format); the others wait for it
and load their slices of the best one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data.augmentation import DropoutScheduler
from vivqa_tpu_torch.data.loader import device_prefetch
from vivqa_tpu_torch.parallel.collectives import all_gather
from vivqa_tpu_torch.parallel.mesh import (Mesh, barrier, local_rows,
                                           logical_to_mesh, mesh_of)
from vivqa_tpu_torch.metrics import (BLEUScore, CIDErScore,
                                     ExactMatchAccuracy, F1Score,
                                     METEORScore, PrecisionRecallF1,
                                     ROUGEScore, TopKAccuracy, VQAAccuracy,
                                     WUPS)
from vivqa_tpu_torch.pipelines.common import (EarlyStopping, StepTimer,
                                              load_params)
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              gathered_params)
from vivqa_tpu_torch.train.losses import cross_entropy_loss
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (KNOWLEDGE_KEYS, ShardedStep,
                                         TrainState, classification_loss_fn,
                                         knowledge_of, make_train_step,
                                         place_state)
from vivqa_tpu_torch.train.strategies import trainable_mask
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class TrainingPipelineConfig(ConfigBase):
    num_epochs: int = 10
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    label_smoothing: float = 0.0
    # batch-mix augmentation (reference augmentation.py:219-348
    # MixUp/CutMix; ops/batch_mix.py)
    mix_mode: str = "none"              # none | mixup | cutmix | both
    mix_alpha: float = 0.4              # Beta(alpha, alpha) mixing ratio
    # scheduled dropout (reference augmentation.py:475-562
    # DropoutScheduler); "" = off. Epoch-granular.
    dropout_schedule: str = ""          # "" | linear | cosine
    initial_dropout: float = 0.1
    final_dropout: float = 0.3
    dropout_warmup_epochs: int = 0
    moe_aux_weight: float = 0.01
    # freezing strategy (train/strategies.py): epoch 0's mask holds for
    # the whole run, so gradual_unfreeze keeps both encoders frozen
    strategy: str = "full"
    early_stopping_patience: int = 5
    metric_for_best: str = "vqa_accuracy"
    checkpoint_dir: str = "checkpoints/vqa"
    max_checkpoints: int = 3
    log_every: int = 10
    num_display_samples: int = 3
    seed: int = 42
    # ablation: per-expert multiplier, () = no masking
    expert_mask: tuple = ()
    # resume from checkpoint_dir when checkpoints exist there: restore
    # the best params and continue at the saved epoch + 1 with a FRESH
    # optimizer
    resume: bool = False


@dataclasses.dataclass
class TrainingPipelineOutput:
    state: TrainState
    history: list
    best_metric: float
    best_step: Optional[int]
    final_metrics: Dict[str, float]
    # per epoch, the host seconds of each step from the end of the one
    # before (the wait for its batch included; the step is dispatched,
    # not finished), and of the whole loop to the end-of-epoch loss read,
    # which waits for the device
    step_seconds: list = dataclasses.field(default_factory=list)
    loop_seconds: list = dataclasses.field(default_factory=list)


class TrainingPipeline:
    def __init__(self, config: TrainingPipelineConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def _build_state(self, model: torch.nn.Module,
                     steps_per_epoch: int) -> TrainState:
        """A fresh train state: the optimizer over ``model``'s parameters
        with the schedule spread over the whole run and the strategy's
        mask of epoch 0."""
        cfg = self.config
        total = max(1, steps_per_epoch * cfg.num_epochs //
                    max(1, cfg.optimizer.accumulate_steps))
        sched = cfg.scheduler.replace(total_steps=total)
        freeze = None
        if cfg.strategy != "full":
            # epoch 0's mask for the whole run, as the JAX pipeline
            freeze = trainable_mask(model, cfg.strategy, 0, cfg.num_epochs)
        return TrainState.create(
            model, create_optimizer(cfg.optimizer, model, sched, freeze),
            seed=cfg.seed)

    def _expert_mask(self, device: torch.device) -> Optional[torch.Tensor]:
        m = self.config.expert_mask
        return torch.tensor(m, dtype=torch.float32, device=device) \
            if m else None

    # ----- run ------------------------------------------------------------
    def run(self, model: torch.nn.Module, train_loader: Iterable,
            val_loader: Iterable, id2answer: Dict[int, str],
            mesh: Optional[Mesh] = None) -> TrainingPipelineOutput:
        """Train ``model`` (a ``VietnameseVQAModel``, on the device it is
        on) over ``train_loader`` (collated batches, with a length),
        validating each epoch over ``val_loader``; on ``mesh`` when it is
        given and larger than one rank."""
        cfg = self.config
        log = self.log
        log.start_stage("training_pipeline")
        device = next(model.parameters()).device
        state = self._build_state(model, len(train_loader))
        if mesh is not None and mesh.size > 1:
            place_state(state, mesh)
        else:
            mesh = None
        expert_mask = self._expert_mask(device)
        train_step = make_train_step(classification_loss_fn(
            cfg.moe_aux_weight, cfg.label_smoothing, expert_mask,
            cfg.mix_mode, cfg.mix_alpha))
        if mesh is not None:
            train_step = ShardedStep(mesh, train_step).compile(state)[0]

        ckpt = CheckpointManager(CheckpointConfig(
            directory=cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
            best_metric=cfg.metric_for_best))
        stopper = EarlyStopping(patience=cfg.early_stopping_patience)
        history, step_seconds, loop_seconds = [], [], []
        timer = StepTimer()

        start_epoch = 0
        if cfg.resume and ckpt.latest_step() is not None:
            restored, meta = ckpt.restore_best(map_location=device)
            load_params(model, restored["params"], state.sharding, mesh)
            start_epoch = int((meta or {}).get("epoch", -1)) + 1
            log.info("resumed best checkpoint from %s — continuing at "
                     "epoch %d (fresh optimizer)", cfg.checkpoint_dir,
                     start_epoch)

        drop_sched = None
        if cfg.dropout_schedule:
            # ramp over num_epochs-1: epochs are queried 0..E-1, so the
            # LAST epoch must hit progress 1.0 and train at final_dropout
            drop_sched = DropoutScheduler(
                cfg.initial_dropout, cfg.final_dropout,
                total_steps=max(cfg.num_epochs - 1, 1),
                warmup_steps=cfg.dropout_warmup_epochs,
                schedule=cfg.dropout_schedule)
        cur_rate = None

        for epoch in range(start_epoch, cfg.num_epochs):
            if drop_sched is not None:
                rate = drop_sched.get_dropout(epoch)
                if rate != cur_rate:
                    # the rates change on the live modules: parameters
                    # and optimizer state are untouched
                    DropoutScheduler.apply_to_model(model, rate)
                    log.info("dropout schedule: rate=%.3f at epoch %d",
                             rate, epoch)
                    cur_rate = rate
            # -- train epoch -----------------------------------------------
            losses, stamps = [], [time.perf_counter()]
            timer.reset()
            for i, batch in enumerate(device_prefetch(iter(train_loader),
                                                      device)):
                timer.tic()
                if mesh is not None:
                    batch = {k: v for k, v in batch.items()
                             if isinstance(v, torch.Tensor)}
                state, metrics = train_step(state, batch)
                # the loss stays on the device; it is read on log steps
                # and at the end of the epoch
                losses.append(metrics["loss"])
                if i % cfg.log_every == 0:
                    log.info("epoch %d step %d loss=%.4f acc=%.3f",
                             epoch, i, float(metrics["loss"]),
                             float(metrics["accuracy"]))
                timer.toc(batch["labels"].shape[0])
                stamps.append(time.perf_counter())
            losses = [float(x) for x in losses]
            step_seconds.append([b - a for a, b in zip(stamps, stamps[1:])])
            loop_seconds.append(time.perf_counter() - stamps[0])
            train_loss = float(np.mean(losses)) if losses else 0.0

            # -- validate epoch ---------------------------------------------
            val = self.validate(model, val_loader, id2answer, mesh)
            val["train_loss"] = train_loss
            val["epoch"] = epoch
            val["qa_pairs_per_sec"] = timer.items_per_sec
            history.append(val)
            log.log_metrics(val, prefix=f"epoch{epoch}/")

            # -- checkpoint best --------------------------------------------
            metric = val.get(cfg.metric_for_best, 0.0)
            if stopper.update(metric):
                params = gathered_params(model, state.sharding, mesh)
                if mesh is None or mesh.is_main:
                    ckpt.save(state.step, {"params": params},
                              metadata={"num_answers": len(id2answer),
                                        "vocabulary": {str(k): v for k, v
                                                       in id2answer.items()},
                                        "epoch": epoch},
                              metrics={cfg.metric_for_best: metric})
                    log.log_checkpoint(cfg.checkpoint_dir, state.step,
                                       metric)
                barrier(mesh)
            if stopper.should_stop:
                log.warning(f"early stopping at epoch {epoch} "
                            f"(best {stopper.best:.4f})")
                break

        # -- final evaluation on best checkpoint ---------------------------
        final = history[-1] if history else {}
        best_step = ckpt.best_step()
        if best_step is not None:
            restored, _ = ckpt.restore_best(map_location=device)
            load_params(model, restored["params"], state.sharding, mesh)
            final = self.validate(model, val_loader, id2answer, mesh)
            log.log_metrics(final, prefix="final/")
        log.end_stage("training_pipeline")
        return TrainingPipelineOutput(state, history,
                                      stopper.best or 0.0, best_step, final,
                                      step_seconds, loop_seconds)

    # ----- validation ------------------------------------------------------
    def validate(self, model: torch.nn.Module, val_loader: Iterable,
                 id2answer: Dict[int, str],
                 mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """Full metric dict over the validation set (reference :536-741):
        the model in eval mode with no gradient, on its device; the
        metrics from its f32 logits over the first ``_num_valid`` rows
        of each batch. The knowledge arrays a provider attached to the
        batches reach the model, as in the train step. On ``mesh`` (the
        model placed on it by ``run``, or split here) each rank runs its
        'data' rows and the logits are gathered before the metrics."""
        cfg = self.config
        device = next(model.parameters()).device
        expert_mask = self._expert_mask(device)
        if mesh is not None and mesh.size > 1:
            if mesh_of(model) is None:
                logical_to_mesh(model, mesh)
        else:
            mesh = None
        model.eval()
        vqa_acc, top5 = VQAAccuracy(), TopKAccuracy(5)
        em, f1 = ExactMatchAccuracy(), F1Score("macro")
        bleu, meteor = BLEUScore(), METEORScore()
        rouge, cider = ROUGEScore(), CIDErScore()
        prf, wups9 = PrecisionRecallF1(), WUPS(0.9)
        losses = []
        shown = 0
        for batch in device_prefetch(iter(val_loader), device):
            x = {k: batch[k] for k in ("pixel_values", "input_ids",
                                       "attention_mask") + KNOWLEDGE_KEYS
                 if k in batch}
            if mesh is not None:
                x = local_rows(x, mesh)
            with torch.no_grad():
                out = model(x["pixel_values"], x["input_ids"],
                            x["attention_mask"], expert_mask=expert_mask,
                            **knowledge_of(x))
            logits = out["logits"]
            if mesh is not None:
                logits = all_gather(logits, mesh.data)
            nv = batch.get("_num_valid", len(batch["labels"]))
            logits = logits.float().cpu().numpy()[:nv]
            labels = batch["labels"].cpu().numpy()[:nv]
            losses.append(float(cross_entropy_loss(
                torch.from_numpy(logits), torch.from_numpy(labels))))
            preds = logits.argmax(-1)
            pred_strs = [id2answer.get(int(p), "<unk>") for p in preds]
            refs = batch.get("all_answers",
                             [[id2answer.get(int(l), "<unk>")] for l in labels])
            refs = refs[:nv]
            vqa_acc.update(preds, batch.get(
                "answer_counts", [{int(l): 10} for l in labels])[:nv])
            top5.update(logits, labels)
            f1.update(preds, labels)
            em.update(pred_strs, refs)
            bleu.update(pred_strs, refs)
            meteor.update(pred_strs, refs)
            rouge.update(pred_strs, refs)
            cider.update(pred_strs, refs)
            prf.update(pred_strs, refs)
            wups9.update(pred_strs, refs)
            # sample display (reference :771)
            if shown < cfg.num_display_samples and "question" in batch:
                q = batch["question"][0]
                self.log.info("  sample: Q='%s' pred='%s' gold=%s",
                              q, pred_strs[0], refs[0][:3])
                shown += 1
        rouge_r = rouge.compute()
        prf_r = prf.compute()
        return {
            "val_loss": float(np.mean(losses)) if losses else 0.0,
            "vqa_accuracy": vqa_acc.compute().value,
            "top5_accuracy": top5.compute().value,
            "exact_match": em.compute().value,
            "f1_macro": f1.compute().value,
            "bleu": bleu.compute().value,
            "meteor": meteor.compute().value,
            "rouge_l": rouge_r.value,
            "cider": cider.compute().value,
            "precision": prf_r.metadata["precision"],
            "recall": prf_r.metadata["recall"],
            "token_f1": prf_r.value,
            "wups_0.9": wups9.compute().value,
        }
