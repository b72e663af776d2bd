"""Generative (seq2seq) training pipeline (counterpart of
vivqa_tpu/pipelines/generative_training_pipeline.py).

AdamW with no-decay groups and the OneCycle schedule by default, the
teacher-forcing loss with -100 label masking and token counting
(``train/state.py:generative_loss_fn``), validation that GENERATES
answers with the KV-cached decode (``models/decoding.py``) and computes
the NLG and VQA metrics, perplexity exp(min(loss, 100)), early stopping
and a checkpoint on improvement of ``metric_for_best`` (BLEU).

The loop is the JAX package's: the losses stay on the device until the
epoch ends, ``n_tokens`` is read once an epoch, the loss only every
``log_every`` steps. It runs on the model's device. Batches are dicts of
numpy arrays (``data/dataset.py:generative_collate``), moved to the
model's device by ``data/loader.py:device_prefetch`` (a host thread,
pinned buffers and copies on a side stream), as the JAX package moves
them with its prefetcher, with the knowledge arrays a
``KnowledgeProvider`` attached, which the step and the validation's
generate pass to the model. The JAX package's settled reads (defenses
of its TPU runtime) have no counterpart here.

On a mesh (``run``'s ``mesh``, as ``TrainingPipeline`` takes it) the
state is placed and the step is ``ShardedStep``'s: each rank trains on
its 'data' rows, the loss divides by the global count of answer tokens,
``n_tokens`` is the global batch's; validation decodes each rank's rows
with the model's 'model' shards and gathers the sequences before the
metrics. Global rank 0 alone writes the checkpoint, from the gathered
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data.loader import device_prefetch, host_tensor
from vivqa_tpu_torch.metrics import (BLEUScore, CIDErScore,
                                     ExactMatchAccuracy, METEORScore,
                                     PrecisionRecallF1, ROUGEScore)
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.parallel.collectives import all_gather
from vivqa_tpu_torch.parallel.mesh import Mesh, barrier, local_rows
from vivqa_tpu_torch.pipelines.common import (EarlyStopping, StepTimer,
                                              load_params)
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager,
                                              gathered_params)
from vivqa_tpu_torch.train.losses import perplexity
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (KNOWLEDGE_KEYS, ShardedStep,
                                         TrainState, generative_loss_fn,
                                         knowledge_of, make_train_step,
                                         place_state)
from vivqa_tpu_torch.train.strategies import trainable_mask
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class GenerativeTrainingConfig(ConfigBase):
    num_epochs: int = 10
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=lambda: OptimizerConfig(learning_rate=3e-5))
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=lambda: SchedulerConfig(name="onecycle"))
    label_smoothing: float = 0.1
    moe_aux_weight: float = 0.01
    early_stopping_patience: int = 5
    metric_for_best: str = "bleu"
    checkpoint_dir: str = "checkpoints/generative"
    max_checkpoints: int = 3
    log_every: int = 10
    # freezing strategy (full / freeze_visual / freeze_text /
    # linear_probe / gradual_unfreeze; train/strategies.py), epoch 0's
    # mask for the whole run
    strategy: str = "full"
    decode_strategy: str = "greedy"
    num_beams: int = 4
    # sampling knobs for decode_strategy top_k / top_p
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.9
    max_generate_length: int = 0       # 0 = model.max_answer_length
    max_eval_batches: int = 0          # 0 = all
    seed: int = 42
    expert_mask: tuple = ()            # ablation masking, () = off
    # resume from checkpoint_dir when checkpoints exist there: restore
    # best params, continue at saved epoch + 1 with a fresh optimizer
    resume: bool = False


@dataclasses.dataclass
class GenerativeTrainingOutput:
    state: TrainState
    history: list
    best_metric: float
    final_metrics: Dict[str, float]


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The numpy arrays of a collated batch as tensors on ``device``, by
    ``device_prefetch``'s rule (signed integers as int64), copied in the
    caller's thread; other values (answer texts, counts) stay as they
    are."""
    return {k: host_tensor(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


class GenerativeTrainingPipeline:
    def __init__(self, config: GenerativeTrainingConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def run(self, model, train_loader: Iterable, val_loader: Iterable,
            tokenizer, mesh: Optional[Mesh] = None
            ) -> GenerativeTrainingOutput:
        """Train ``model`` (a ``GenerativeVQAModel``, on the device it is
        on) for ``num_epochs`` epochs over ``train_loader`` (an iterable
        of collated batches with a length), validating each epoch over
        ``val_loader`` with answers decoded by ``tokenizer``; on ``mesh``
        when it is given and larger than one rank."""
        cfg = self.config
        log = self.log
        log.start_stage("generative_training")
        device = next(model.parameters()).device
        expert_mask = torch.tensor(cfg.expert_mask, dtype=torch.float32,
                                   device=device) if cfg.expert_mask else None

        total = max(1, len(train_loader) * cfg.num_epochs)
        freeze = None
        if cfg.strategy != "full":
            # epoch 0's mask for the whole run, as the JAX pipeline
            freeze = trainable_mask(model, cfg.strategy, 0, cfg.num_epochs)
        state = TrainState.create(
            model, create_optimizer(cfg.optimizer, model,
                                    cfg.scheduler.replace(total_steps=total),
                                    freeze),
            seed=cfg.seed)
        if mesh is not None and mesh.size > 1:
            place_state(state, mesh)
        else:
            mesh = None
        train_step = make_train_step(generative_loss_fn(
            cfg.label_smoothing, cfg.moe_aux_weight, expert_mask))
        if mesh is not None:
            train_step = ShardedStep(mesh, train_step).compile(state)[0]

        mcfg = model.config
        generate = build_generate_fn(model, DecodeConfig(
            max_length=cfg.max_generate_length or mcfg.max_answer_length,
            bos_token_id=mcfg.bos_token_id, eos_token_id=mcfg.eos_token_id,
            pad_token_id=mcfg.pad_token_id, strategy=cfg.decode_strategy,
            num_beams=cfg.num_beams, temperature=cfg.temperature,
            top_k=cfg.top_k, top_p=cfg.top_p))

        ckpt = CheckpointManager(CheckpointConfig(
            directory=cfg.checkpoint_dir, max_to_keep=cfg.max_checkpoints,
            best_metric=cfg.metric_for_best))
        stopper = EarlyStopping(patience=cfg.early_stopping_patience)
        history = []
        timer = StepTimer()

        start_epoch = 0
        if cfg.resume and ckpt.latest_step() is not None:
            restored, meta = ckpt.restore_best(map_location=device)
            load_params(model, restored["params"], state.sharding, mesh)
            start_epoch = int((meta or {}).get("epoch", -1)) + 1
            log.info("resumed best checkpoint from %s — continuing at "
                     "epoch %d (fresh optimizer)", cfg.checkpoint_dir,
                     start_epoch)

        for epoch in range(start_epoch, cfg.num_epochs):
            losses = []
            timer.reset()
            for i, dev in enumerate(device_prefetch(iter(train_loader),
                                                    device)):
                timer.tic()
                if mesh is not None:
                    dev = {k: v for k, v in dev.items()
                           if isinstance(v, torch.Tensor)}
                state, metrics = train_step(state, dev)
                losses.append(metrics["loss"])     # stays on the device
                n_tok = int(metrics["n_tokens"]) if i == 0 else n_tok
                if i % cfg.log_every == 0:
                    loss = float(metrics["loss"])
                    log.info("epoch %d step %d loss=%.4f ppl=%.2f",
                             epoch, i, loss,
                             float(perplexity(torch.tensor(loss))))
                timer.toc(n_tok)
            losses = [float(x) for x in losses]
            train_loss = float(np.mean(losses)) if losses else 0.0

            val = self._validate(generate, val_loader, tokenizer, device,
                                 expert_mask, mesh)
            val.update(train_loss=train_loss, epoch=epoch,
                       perplexity=float(perplexity(torch.tensor(train_loss))),
                       tokens_per_sec=timer.items_per_sec)
            history.append(val)
            log.log_metrics(val, prefix=f"epoch{epoch}/")

            metric = val.get(cfg.metric_for_best, 0.0)
            if stopper.update(metric):
                params = gathered_params(model, state.sharding, mesh)
                if mesh is None or mesh.is_main:
                    ckpt.save(state.step, {"params": params},
                              metadata={"epoch": epoch,
                                        "config": mcfg.to_dict()},
                              metrics={cfg.metric_for_best: metric})
                    log.log_checkpoint(cfg.checkpoint_dir, state.step,
                                       metric)
                barrier(mesh)
            if stopper.should_stop:
                log.warning(f"early stopping at epoch {epoch}")
                break

        final = history[-1] if history else {}
        log.end_stage("generative_training")
        return GenerativeTrainingOutput(state, history,
                                        stopper.best or 0.0, final)

    def _validate(self, generate, val_loader, tokenizer, device,
                  expert_mask, mesh: Optional[Mesh] = None
                  ) -> Dict[str, float]:
        """The metrics of ``generate``'s answers over ``val_loader``; on a
        mesh each rank decodes its 'data' rows and the sequences are
        gathered."""
        cfg = self.config
        if mesh is not None and mesh.size <= 1:
            mesh = None
        bleu, meteor, rouge = BLEUScore(), METEORScore(), ROUGEScore()
        cider, em, prf = CIDErScore(), ExactMatchAccuracy(), PrecisionRecallF1()
        n = 0
        for dev in device_prefetch(iter(val_loader), device):
            if cfg.max_eval_batches and n >= cfg.max_eval_batches:
                break
            n += 1
            # decode with the SAME expert composition the model was
            # trained with (ablation masks)
            x = {k: dev[k] for k in ("pixel_values", "question_ids",
                                     "question_mask") + KNOWLEDGE_KEYS
                 if k in dev}
            if mesh is not None:
                x = local_rows(x, mesh)
            seqs, _ = generate(x["pixel_values"], x["question_ids"],
                               x["question_mask"], expert_mask=expert_mask,
                               **knowledge_of(x))
            if mesh is not None:
                seqs = all_gather(seqs, mesh.data)
            nv = dev.get("_num_valid", len(seqs))
            preds = [tokenizer.decode(s) for s in seqs[:nv].cpu().numpy()]
            refs = dev.get("all_answers", [[t] for t in
                                           dev.get("answer_text", [])])[:nv]
            for metric in (bleu, meteor, rouge, cider, em, prf):
                metric.update(preds, refs)
        return {"bleu": bleu.compute().value,
                "meteor": meteor.compute().value,
                "rouge_l": rouge.compute().value,
                "cider": cider.compute().value,
                "exact_match": em.compute().value,
                "token_f1": prf.compute().value}

