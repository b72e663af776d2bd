"""Per-experiment training with modification, persistence, OOM retry
(counterpart of vivqa_tpu/ablation/trainer.py).

``run_experiment`` applies the expert/router modifications, builds the
port's classification or generative model on the trainer's device with
seeded random weights, runs the port's ``TrainingPipeline`` or
``GenerativeTrainingPipeline`` (``resume=True``, the experiment's
``expert_mask``), persists per-epoch CSV/JSON
(``epoch_results/<id>/{train,val}_history.csv``, ``epoch_summary.json``),
retries once with doubled gradient accumulation after the card runs out
of memory, and returns an ``ExperimentResult``. Post-hoc rows evaluate
the trained full baseline's best checkpoint with the row's mask;
``backfill_correct_mask`` computes a finished row's mask from its
checkpoint.

Router telemetry and the per-sample ``correct_mask`` are computed with
the model in eval mode, no gradient, and the batch's attention mask
passed, so they describe the same forward as the reported metrics. As
in the JAX package a failure of either leaves it ``None`` and the
experiment still completes; a caller that needs them checks.

On a mesh of several ranks (``mesh``, as the JAX trainer takes it) the
pipelines train on it, the post-hoc rows place the restored model on it,
and each rank runs its 'data' rows of every validation batch: the
predictions are gathered against the global batch's labels, and the
router telemetry's means are averaged over 'data' (the load imbalance
then recomputed from the global usage). Only global rank 0 writes the
epoch files; the pipelines hold their checkpoints to it too.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from vivqa_tpu_torch.ablation.config import AblationConfig, ExperimentConfig
from vivqa_tpu_torch.ablation.modifier import (apply_expert_ablation,
                                               apply_router_ablation,
                                               build_expert_mask,
                                               collect_moe_metrics)
from vivqa_tpu_torch.data.loader import device_prefetch
from vivqa_tpu_torch.device import resolve_device
from vivqa_tpu_torch.parallel.collectives import all_gather, all_reduce
from vivqa_tpu_torch.parallel.mesh import (local_rows, logical_to_mesh,
                                           process_rank)
from vivqa_tpu_torch.pipelines.common import load_params
from vivqa_tpu_torch.train.checkpoint import (CheckpointConfig,
                                              CheckpointManager)
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass
class ExperimentResult:
    experiment_id: str
    status: str                       # completed | failed | interrupted
    metrics: Dict[str, float]
    history: list
    wall_seconds: float
    error: str = ""
    moe_metrics: Optional[Dict] = None
    # per-val-sample 0/1 exact-match correctness with the best params —
    # enables paired (McNemar) comparisons between experiments, which
    # are far more sensitive than independent binomial bounds
    correct_mask: Optional[list] = None


class AblationTrainer:
    """Runs one experiment end-to-end against pre-built data loaders on
    ``device`` (the card unless the caller names the CPU), or on
    ``mesh`` (``parallel/mesh.py:create_mesh``; its rank's device) when
    it spans several ranks."""

    def __init__(self, config: AblationConfig, base_model_config,
                 data_out, device: str | torch.device = "cuda",
                 logger=None, mesh=None):
        """data_out: DataPipelineOutput (loaders + vocab + tokenizer)."""
        self.config = config
        self.base_model_config = base_model_config
        self.data = data_out
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.log = logger or get_pipeline_logger()
        self.main = process_rank() == 0

    def _local(self, batch: dict) -> dict:
        """This rank's rows of a batch's tensors (all of them on one
        process)."""
        x = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
        return local_rows(x, self.mesh) if self.mesh is not None else x

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of a per-row tensor."""
        return all_gather(t, self.mesh.data) if self.mesh is not None else t

    def _epoch_dir(self, experiment_id: str) -> Path:
        d = Path(self.config.output_dir) / "epoch_results" / experiment_id
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _save_epoch_results(self, experiment_id: str, history: list) -> None:
        """train/val history CSVs + epoch summary JSON (global rank 0)."""
        if not history or not self.main:
            return
        d = self._epoch_dir(experiment_id)
        keys = sorted({k for h in history for k in h})
        with open(d / "val_history.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for h in history:
                w.writerow({k: h.get(k) for k in keys})
        train_keys = [k for k in keys if "train" in k or k == "epoch"]
        with open(d / "train_history.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=train_keys)
            w.writeheader()
            for h in history:
                w.writerow({k: h.get(k) for k in train_keys})
        (d / "epoch_summary.json").write_text(
            json.dumps(history, indent=2, default=str))

    def _modified_model(self, experiment: ExperimentConfig):
        cfg = self.base_model_config
        cfg = apply_expert_ablation(cfg, experiment.expert)
        if cfg.moe.use_moe:
            cfg = apply_router_ablation(cfg, experiment.router)
        mask = None
        if cfg.moe.use_moe:
            num_experts = cfg.moe.num_experts
            if cfg.moe.moe_type == "vqa":
                num_experts = (cfg.moe.num_vision_experts +
                               cfg.moe.num_text_experts +
                               cfg.moe.num_multimodal_experts +
                               cfg.moe.num_specialized_experts)
            mask = build_expert_mask(experiment.expert, num_experts)
        return cfg, mask

    def _build_model(self, model_cfg):
        """The experiment's model on the trainer's device, its weights
        from the study's seed."""
        gen = torch.Generator().manual_seed(self.config.seed)
        if self.config.model_type == "generative":
            from vivqa_tpu_torch.models.generative import (
                create_generative_vqa_model)
            return create_generative_vqa_model(model_cfg, device=self.device,
                                               generator=gen)
        from vivqa_tpu_torch.models.vqa_model import create_vqa_model
        mc = model_cfg.replace(num_answers=len(self.data.answer2id))
        return create_vqa_model(mc, device=self.device, generator=gen)

    def _mask_tensor(self, mask) -> Optional[torch.Tensor]:
        return torch.tensor(mask, dtype=torch.float32,
                            device=self.device) if mask else None

    def _build_and_run(self, experiment: ExperimentConfig, accumulate: int):
        cfg = self.config
        model_cfg, mask = self._modified_model(experiment)
        from vivqa_tpu_torch.train.optimizers import OptimizerConfig
        opt = OptimizerConfig(learning_rate=cfg.learning_rate,
                              accumulate_steps=accumulate)
        ckpt_dir = str(Path(cfg.output_dir) / "checkpoints" /
                       experiment.experiment_id)
        model = self._build_model(model_cfg)
        if cfg.model_type == "generative":
            from vivqa_tpu_torch.pipelines.generative_training_pipeline \
                import GenerativeTrainingConfig, GenerativeTrainingPipeline
            tp = GenerativeTrainingPipeline(GenerativeTrainingConfig(
                num_epochs=cfg.num_epochs, optimizer=opt,
                checkpoint_dir=ckpt_dir, log_every=1000,
                expert_mask=mask or (), seed=cfg.seed,
                resume=True), self.log)
            out = tp.run(model, self.data.train_loader,
                         self.data.val_loader, self.data.tokenizer,
                         self.mesh)
        else:
            from vivqa_tpu_torch.pipelines.training_pipeline import (
                TrainingPipeline, TrainingPipelineConfig)
            tp = TrainingPipeline(TrainingPipelineConfig(
                num_epochs=cfg.num_epochs, optimizer=opt,
                checkpoint_dir=ckpt_dir, log_every=1000,
                metric_for_best=cfg.primary_metric,
                expert_mask=mask or (), seed=cfg.seed,
                # an interrupted experiment resumes from its best epoch
                # instead of restarting
                resume=True), self.log)
            # the pipeline ends with the best checkpoint's params in the
            # model, which the mask and the telemetry then describe
            out = tp.run(model, self.data.train_loader,
                         self.data.val_loader, self.data.id2answer,
                         self.mesh)
        moe_metrics = self._collect_moe_metrics(model, mask)
        correct_mask = self._collect_correct_mask(model, mask)
        return out, moe_metrics, correct_mask

    def _moe_metrics(self, model, mask) -> Dict:
        """Router telemetry on one val batch (its means over the global
        batch on a mesh)."""
        batch = self._local(next(device_prefetch(iter(self.data.val_loader),
                                                 self.device)))
        em = self._mask_tensor(mask)
        model.eval()
        with torch.no_grad():
            if self.config.model_type == "generative":
                res = model(batch["pixel_values"], batch["question_ids"],
                            batch["decoder_input_ids"],
                            batch["question_mask"], batch["decoder_mask"],
                            expert_mask=em)
            else:
                res = model(batch["pixel_values"], batch["input_ids"],
                            batch["attention_mask"], expert_mask=em)
        return collect_moe_metrics(self._data_mean(
            {k: v.float() for k, v in res.get("moe_metrics", {}).items()}))

    def _data_mean(self, metrics: Dict) -> Dict:
        """A rank's telemetry (means over its tokens) -> the global
        batch's: each averaged over 'data' (every rank holds as many
        tokens), the load imbalance recomputed from the averaged usage
        as the router computes it. As numpy."""
        if self.mesh is not None and metrics:
            keys = sorted(metrics)
            flat = all_reduce(torch.cat([metrics[k].reshape(-1)
                                         for k in keys]), self.mesh.data)
            out, offset = {}, 0
            for k in keys:
                n = metrics[k].numel()
                out[k] = (flat[offset:offset + n] / self.mesh.data.size
                          ).view(metrics[k].shape)
                offset += n
            usage = out.get("expert_usage")
            if usage is not None and "load_imbalance" in out:
                out["load_imbalance"] = torch.std(usage, correction=0) / (
                    torch.mean(usage) + 1e-9)
            metrics = out
        return {k: v.cpu().numpy() for k, v in metrics.items()}

    def _collect_moe_metrics(self, model, mask):
        """The JAX package's rule: a failure leaves the telemetry out."""
        try:
            return self._moe_metrics(model, mask)
        except Exception:  # noqa: BLE001
            self.log.warning("router telemetry failed:\n%s",
                             traceback.format_exc(limit=5))
            return None

    def _correct_mask(self, model, mask) -> list:
        """argmax == label per val sample. The attention mask rides
        along: without it padded question tokens attend and the
        predictions are not the reported evaluation's."""
        em = self._mask_tensor(mask)
        model.eval()
        bits = []
        for batch in device_prefetch(iter(self.data.val_loader),
                                     self.device):
            x = self._local(batch)
            with torch.no_grad():
                logits = self._gathered(model(
                    x["pixel_values"], x["input_ids"], x["attention_mask"],
                    expert_mask=em)["logits"])
            nv = batch.get("_num_valid", len(batch["labels"]))
            preds = logits.float().argmax(-1).cpu().numpy()[:nv]
            labels = batch["labels"].cpu().numpy()[:nv]
            bits.extend((preds == labels).astype(int).tolist())
        return bits

    def check_mask_consistency(self, correct_mask, exact_match,
                               experiment_id=""):
        """The per-sample mask and the reported exact_match describe the
        SAME params on the SAME val set — their means must agree. A gap
        means the mask was computed through a different code path than
        the metric (paired tests built on it would be garbage)."""
        if not correct_mask or exact_match is None:
            return True
        gap = abs(sum(correct_mask) / len(correct_mask) - exact_match)
        if gap > 0.02:
            self.log.warning(
                f"correct_mask mean {sum(correct_mask)/len(correct_mask):.4f} "
                f"disagrees with exact_match {exact_match:.4f} "
                f"({experiment_id}) — DISCARDING the mask (paired tests "
                f"must not run on inconsistent data)")
            return False
        return True

    def _generative_mask(self, model, mask) -> list:
        """Per-sample exact match of the greedy KV-cached decode against
        the reference answers — the same ExactMatchAccuracy the reported
        metrics use, read out per sample."""
        from vivqa_tpu_torch.metrics import ExactMatchAccuracy
        from vivqa_tpu_torch.models.decoding import (DecodeConfig,
                                                     build_generate_fn)
        cfg = model.config
        gen = build_generate_fn(model, DecodeConfig(
            max_length=cfg.max_answer_length, strategy="greedy",
            bos_token_id=cfg.bos_token_id, eos_token_id=cfg.eos_token_id,
            pad_token_id=cfg.pad_token_id))
        em_mask = self._mask_tensor(mask)
        em = ExactMatchAccuracy()
        tok = self.data.tokenizer
        for batch in device_prefetch(iter(self.data.val_loader),
                                     self.device):
            x = self._local(batch)
            seqs, _ = gen(x["pixel_values"], x["question_ids"],
                          x["question_mask"], expert_mask=em_mask)
            seqs = self._gathered(seqs)
            nv = batch.get("_num_valid", len(seqs))
            preds = [tok.decode(s) for s in seqs[:nv].cpu().numpy()]
            refs = batch.get("all_answers",
                             [[t] for t in batch.get("answer_text", [])])[:nv]
            em.update(preds, refs)
        return [int(x) for x in em.compute().per_sample]

    def _mask_of(self, model, mask) -> list:
        if self.config.model_type == "generative":
            return self._generative_mask(model, mask)
        return self._correct_mask(model, mask)

    def _collect_correct_mask(self, model, mask):
        """Per-sample exact-match correctness on the full val set with
        the model's (best) params; a failure leaves it out, as in the JAX
        package."""
        try:
            return self._mask_of(model, mask)
        except Exception:  # noqa: BLE001
            self.log.warning("correct_mask failed:\n%s",
                             traceback.format_exc(limit=5))
            return None

    def _baseline_checkpoint_dir(self) -> Path:
        """Checkpoint dir of the trained FULL baseline (priority-0 row of
        the matrix) — the model post-hoc ablations are applied to."""
        matrix = self.config.generate_experiment_matrix()
        base = next((e for e in matrix
                     if e.expert.mode == "full" and not e.expert.post_hoc),
                    None)
        if base is None:
            raise RuntimeError("post-hoc ablation needs a 'full' baseline "
                               "in the experiment matrix (include_full)")
        return Path(self.config.output_dir) / "checkpoints" / \
            base.experiment_id

    def _restored_model(self, experiment: ExperimentConfig,
                        checkpoint_dir: Path):
        """The experiment's model with the best params of
        ``checkpoint_dir``, and its expert mask."""
        model_cfg, mask = self._modified_model(experiment)
        model = self._build_model(model_cfg)
        ckpt = CheckpointManager(CheckpointConfig(
            directory=str(checkpoint_dir),
            best_metric=self.config.primary_metric))
        restored, _ = ckpt.restore_best(map_location=self.device)
        load_params(model, restored["params"])
        if self.mesh is not None:
            logical_to_mesh(model, self.mesh)
        return model, mask

    def _run_post_hoc_experiment(self,
                                 experiment: ExperimentConfig
                                 ) -> ExperimentResult:
        """Evaluate the trained FULL baseline with the experiment's
        expert mask applied at eval time — no retraining. The
        instrument's positive control: a mask that silently failed to
        bite would leave these rows identical to the baseline."""
        eid = experiment.experiment_id
        self.log.section(f"EXPERIMENT {eid} (post-hoc)")
        t0 = time.time()
        # full architecture + the masked modes' mask; the router config
        # stays the baseline's (the matrix gives post-hoc rows the
        # default router)
        model, mask = self._restored_model(experiment,
                                           self._baseline_checkpoint_dir())
        correct_mask = self._mask_of(model, mask)
        metrics = {"exact_match": (sum(correct_mask) / len(correct_mask)
                                   if correct_mask else 0.0),
                   "n_eval": len(correct_mask)}
        moe_metrics = None
        if self.config.model_type != "generative":
            moe_metrics = self._collect_moe_metrics(model, mask)
        return ExperimentResult(
            experiment_id=eid, status="completed", metrics=metrics,
            history=[], wall_seconds=time.time() - t0,
            moe_metrics=moe_metrics, correct_mask=correct_mask)

    def backfill_correct_mask(self, experiment: ExperimentConfig):
        """Compute ``correct_mask`` for an already-trained experiment
        from its saved best checkpoint — lets older studies gain paired
        McNemar tests without retraining."""
        model, mask = self._restored_model(
            experiment, Path(self.config.output_dir) / "checkpoints" /
            experiment.experiment_id)
        return self._mask_of(model, mask)

    def run_experiment(self, experiment: ExperimentConfig) -> ExperimentResult:
        eid = experiment.experiment_id
        log = self.log
        t0 = time.time()
        if experiment.expert.post_hoc:
            try:
                return self._run_post_hoc_experiment(experiment)
            except KeyboardInterrupt:
                return ExperimentResult(
                    experiment_id=eid, status="interrupted", metrics={},
                    history=[], wall_seconds=time.time() - t0,
                    error="KeyboardInterrupt")
            except Exception:  # noqa: BLE001
                log.failure(f"post-hoc experiment {eid} failed")
                return ExperimentResult(
                    experiment_id=eid, status="failed", metrics={},
                    history=[], wall_seconds=time.time() - t0,
                    error=traceback.format_exc(limit=5))
        log.section(f"EXPERIMENT {eid}")
        accumulate = 1
        for attempt in range(2):
            try:
                out, moe_metrics, correct_mask = self._build_and_run(
                    experiment, accumulate)
                history = out.history
                final = dict(history[-1]) if history else {}
                # the classification pipeline reloads the BEST checkpoint
                # and re-validates it into final_metrics; the reported
                # metrics describe those same params (correct_mask and
                # telemetry are computed from them)
                if getattr(out, "final_metrics", None):
                    final.update(out.final_metrics)
                try:
                    # val-set size: lets the evaluator bound the binomial
                    # noise floor on accuracy-like metrics
                    final["n_eval"] = len(self.data.val_loader.dataset)
                except (AttributeError, TypeError):
                    pass
                self._save_epoch_results(eid, history)
                if not self.check_mask_consistency(
                        correct_mask, final.get("exact_match"), eid):
                    correct_mask = None
                return ExperimentResult(
                    experiment_id=eid, status="completed", metrics=final,
                    history=history, wall_seconds=time.time() - t0,
                    moe_metrics=moe_metrics, correct_mask=correct_mask)
            except KeyboardInterrupt:
                return ExperimentResult(
                    experiment_id=eid, status="interrupted", metrics={},
                    history=[], wall_seconds=time.time() - t0,
                    error="KeyboardInterrupt")
            except torch.OutOfMemoryError:
                if attempt == 0:
                    torch.cuda.empty_cache()
                    accumulate *= 2
                    log.warning(f"out of memory in {eid}; retrying with "
                                f"gradient accumulation x{accumulate}")
                    continue
                log.failure(f"experiment {eid} failed: out of memory")
                return ExperimentResult(
                    experiment_id=eid, status="failed", metrics={},
                    history=[], wall_seconds=time.time() - t0,
                    error=traceback.format_exc(limit=5))
            except Exception as e:  # noqa: BLE001
                log.failure(f"experiment {eid} failed: "
                            f"{str(e).splitlines()[0] if str(e) else e!r}")
                return ExperimentResult(
                    experiment_id=eid, status="failed", metrics={},
                    history=[], wall_seconds=time.time() - t0,
                    error=traceback.format_exc(limit=5))
        return ExperimentResult(eid, "failed", {}, [], time.time() - t0,
                                "unreachable")
