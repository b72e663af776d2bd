"""Generative (seq2seq) training pipeline on one card (counterpart of
vivqa_tpu/pipelines/generative_training_pipeline.py).

AdamW with no-decay groups and the OneCycle schedule by default, the
teacher-forcing loss with -100 label masking and token counting
(``train/state.py:generative_loss_fn``), validation that GENERATES
answers with the KV-cached decode (``models/decoding.py``) and computes
the NLG and VQA metrics, perplexity exp(min(loss, 100)), early stopping
and a checkpoint on improvement of ``metric_for_best`` (BLEU).

The loop is the JAX package's: the losses stay on the device until the
epoch ends, ``n_tokens`` is read once an epoch, the loss only every
``log_every`` steps. It runs on the model's device. The JAX package's
mesh, its batch prefetcher and its settled reads (defenses of its TPU
runtime) have no counterpart here: batches are dicts of numpy arrays
(``data/dataset.py:generative_collate``), moved to the model's device
step by step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np
import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.metrics import (BLEUScore, CIDErScore,
                                     ExactMatchAccuracy, METEORScore,
                                     PrecisionRecallF1, ROUGEScore)
from vivqa_tpu_torch.models.decoding import DecodeConfig, build_generate_fn
from vivqa_tpu_torch.pipelines.common import EarlyStopping, StepTimer
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.train.losses import perplexity
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer)
from vivqa_tpu_torch.train.state import (TrainState, generative_loss_fn,
                                         make_train_step)
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
    # linear_probe / gradual_unfreeze); only "full" is ported
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
    """The numpy arrays of a collated batch as tensors on ``device``
    (integer arrays as int64); other values (answer texts, counts) stay
    as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            out[k] = (t.long() if v.dtype.kind in "iu" else t).to(device)
        else:
            out[k] = v
    return out


class GenerativeTrainingPipeline:
    def __init__(self, config: GenerativeTrainingConfig, logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def run(self, model, train_loader: Iterable, val_loader: Iterable,
            tokenizer) -> GenerativeTrainingOutput:
        """Train ``model`` (a ``GenerativeVQAModel``, on the device it is
        on) for ``num_epochs`` epochs over ``train_loader`` (an iterable
        of collated batches with a length), validating each epoch over
        ``val_loader`` with answers decoded by ``tokenizer``."""
        cfg = self.config
        log = self.log
        if cfg.strategy != "full":
            raise NotImplementedError(
                f"strategy '{cfg.strategy}': freezing strategies "
                f"(train/strategies.py) are not ported yet (ROADMAP.md, "
                f"Queue A item 12)")
        log.start_stage("generative_training")
        device = next(model.parameters()).device
        expert_mask = torch.tensor(cfg.expert_mask, dtype=torch.float32,
                                   device=device) if cfg.expert_mask else None

        total = max(1, len(train_loader) * cfg.num_epochs)
        state = TrainState.create(
            model, create_optimizer(cfg.optimizer, model,
                                    cfg.scheduler.replace(total_steps=total)),
            seed=cfg.seed)
        train_step = make_train_step(generative_loss_fn(
            cfg.label_smoothing, cfg.moe_aux_weight, expert_mask))

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
            load_params(model, restored["params"])
            start_epoch = int((meta or {}).get("epoch", -1)) + 1
            log.info("resumed best checkpoint from %s — continuing at "
                     "epoch %d (fresh optimizer)", cfg.checkpoint_dir,
                     start_epoch)

        for epoch in range(start_epoch, cfg.num_epochs):
            losses = []
            timer.reset()
            for i, batch in enumerate(train_loader):
                dev = batch_to_device(batch, device)
                timer.tic()
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
                                 expert_mask)
            val.update(train_loss=train_loss, epoch=epoch,
                       perplexity=float(perplexity(torch.tensor(train_loss))),
                       tokens_per_sec=timer.items_per_sec)
            history.append(val)
            log.log_metrics(val, prefix=f"epoch{epoch}/")

            metric = val.get(cfg.metric_for_best, 0.0)
            if stopper.update(metric):
                params = {n: p.detach().cpu()
                          for n, p in model.named_parameters()}
                ckpt.save(state.step, {"params": params},
                          metadata={"epoch": epoch,
                                    "config": mcfg.to_dict()},
                          metrics={cfg.metric_for_best: metric})
                log.log_checkpoint(cfg.checkpoint_dir, state.step, metric)
            if stopper.should_stop:
                log.warning(f"early stopping at epoch {epoch}")
                break

        final = history[-1] if history else {}
        log.end_stage("generative_training")
        return GenerativeTrainingOutput(state, history,
                                        stopper.best or 0.0, final)

    def _validate(self, generate, val_loader, tokenizer, device,
                  expert_mask) -> Dict[str, float]:
        cfg = self.config
        bleu, meteor, rouge = BLEUScore(), METEORScore(), ROUGEScore()
        cider, em, prf = CIDErScore(), ExactMatchAccuracy(), PrecisionRecallF1()
        n = 0
        for batch in val_loader:
            if cfg.max_eval_batches and n >= cfg.max_eval_batches:
                break
            n += 1
            dev = batch_to_device(batch, device)
            # decode with the SAME expert composition the model was
            # trained with (ablation masks)
            seqs, _ = generate(dev["pixel_values"], dev["question_ids"],
                               dev["question_mask"], expert_mask=expert_mask)
            nv = batch.get("_num_valid", len(seqs))
            preds = [tokenizer.decode(s) for s in seqs[:nv].cpu().numpy()]
            refs = batch.get("all_answers", [[t] for t in
                                             batch.get("answer_text", [])])[:nv]
            for metric in (bleu, meteor, rouge, cider, em, prf):
                metric.update(preds, refs)
        return {"bleu": bleu.compute().value,
                "meteor": meteor.compute().value,
                "rouge_l": rouge.compute().value,
                "cider": cider.compute().value,
                "exact_match": em.compute().value,
                "token_f1": prf.compute().value}


def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]
                ) -> None:
    """Copy a checkpoint's {parameter name: tensor} into ``model`` in
    place (the optimizer keeps its references); raises unless the names
    and shapes match the model's exactly."""
    own = dict(model.named_parameters())
    if sorted(own) != sorted(params):
        raise ValueError(f"checkpoint parameters do not match the model: "
                         f"missing {sorted(set(own) - set(params))}, "
                         f"unused {sorted(set(params) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])
