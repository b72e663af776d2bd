"""Ablation runner: orchestration, resume, interrupts, incremental reports.

A copy of vivqa_tpu/ablation/runner.py on the port's own modules.

Counterpart of src/ablation/ablation_runner.py:45-633 in the reference:
manifest JSON, resume from per-experiment result JSONs, sequential loop
with skip-completed / force-rerun, Ctrl-C -> graceful interrupt with
partial report, per-experiment result JSON + progress.json, incremental
report after every completion, final evaluate/analyze/report + best-
experiment summary.

On the trainer's mesh of several ranks every rank runs every experiment
(their collectives keep them in step), and only global rank 0 writes:
the manifest, the progress, the result JSONs and the reports. The others
wait for its writes at a barrier and read the results it wrote when they
resume.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import List, Optional, Sequence

from vivqa_tpu_torch.ablation.analyzer import AblationAnalyzer
from vivqa_tpu_torch.ablation.config import AblationConfig, ExperimentConfig
from vivqa_tpu_torch.ablation.evaluator import AblationEvaluator
from vivqa_tpu_torch.ablation.reporter import AblationReporter
from vivqa_tpu_torch.ablation.trainer import AblationTrainer, ExperimentResult
from vivqa_tpu_torch.parallel.mesh import barrier, process_rank
from vivqa_tpu_torch.utils import get_pipeline_logger


class GracefulInterrupt(Exception):
    """Raised after an interrupted experiment has been persisted."""


class AblationRunner:
    def __init__(self, config: AblationConfig, trainer: AblationTrainer,
                 logger=None):
        self.config = config
        self.trainer = trainer
        self.log = logger or get_pipeline_logger()
        self.out = Path(config.output_dir)
        self.results_dir = self.out / "results"
        self.mesh = getattr(trainer, "mesh", None)
        self.main = process_rank() == 0
        if self.main:
            self.results_dir.mkdir(parents=True, exist_ok=True)

    def _synced(self) -> None:
        """Wait until rank 0's writes are done (nothing on one process)."""
        barrier(self.mesh)

    # -- persistence -----------------------------------------------------------
    def _result_path(self, eid: str) -> Path:
        return self.results_dir / f"{eid}.json"

    def _save_result(self, r: ExperimentResult) -> None:
        if not self.main:
            return
        self._result_path(r.experiment_id).write_text(
            json.dumps(dataclasses.asdict(r), indent=2, default=str))

    def _load_completed(self) -> dict:
        done = {}
        for p in self.results_dir.glob("*.json"):
            try:
                d = json.loads(p.read_text())
                if d.get("status") == "completed":
                    done[d["experiment_id"]] = ExperimentResult(**d)
            except (json.JSONDecodeError, TypeError):
                continue
        return done

    def _save_progress(self, done: int, total: int, current: str) -> None:
        if not self.main:
            return
        (self.out / "progress.json").write_text(json.dumps({
            "completed": done, "total": total, "current": current,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}))

    def _save_manifest(self, matrix: List[ExperimentConfig]) -> None:
        if not self.main:
            return
        (self.out / "manifest.json").write_text(json.dumps({
            "num_experiments": len(matrix),
            "experiments": [{"id": e.experiment_id,
                             "priority": e.priority,
                             "expert_mode": e.expert.mode,
                             "router": e.router.router_type}
                            for e in matrix],
            "config": self.config.to_dict()}, indent=2))

    # -- reporting --------------------------------------------------------------
    def _n_eval(self) -> Optional[int]:
        try:
            return len(self.trainer.data.val_loader.dataset)
        except (AttributeError, TypeError):
            return None

    def _report(self, results: List[ExperimentResult]) -> None:
        ev = AblationEvaluator(results, self.config.primary_metric,
                               self.config.model_type, n_eval=self._n_eval())
        if not ev.results:
            return
        an = AblationAnalyzer(ev)
        AblationReporter(ev, an, self.config.expert_label).save_all_reports(
            self.out / "reports")

    def backfill_masks(self, selected: Optional[Sequence[int]] = None,
                       force: bool = False):
        """Fill ``correct_mask`` into completed result JSONs from saved
        checkpoints (no retraining), then regenerate reports. ``force``
        recomputes masks that already exist (e.g. after a mask-path
        fix)."""
        matrix = self.config.generate_experiment_matrix()
        if selected:
            matrix = [matrix[i] for i in selected if 0 <= i < len(matrix)]
        completed = self._load_completed()
        updated = 0
        for exp in matrix:
            r = completed.get(exp.experiment_id)
            if r is None or (r.correct_mask and not force):
                continue
            self.log.info("backfilling mask for %s", exp.experiment_id)
            try:
                mask = self.trainer.backfill_correct_mask(exp)
            except Exception as e:  # noqa: BLE001
                self.log.warning("backfill failed for %s: %s",
                                 exp.experiment_id, e)
                continue
            if mask and not self.trainer.check_mask_consistency(
                    mask, r.metrics.get("exact_match"),
                    exp.experiment_id):
                mask = None
            if mask:
                r.correct_mask = mask
                self._save_result(r)
                updated += 1
        self.log.info("backfilled %d experiments", updated)
        self._synced()
        results = list(self._load_completed().values())
        self._report(results)
        return results

    # -- main loop -----------------------------------------------------------------
    def run(self, selected: Optional[Sequence[int]] = None,
            rerun: bool = False, resume: bool = True) -> List[ExperimentResult]:
        cfg = self.config
        log = self.log
        matrix = cfg.generate_experiment_matrix()
        self._save_manifest(matrix)
        if selected:
            matrix = [matrix[i] for i in selected if 0 <= i < len(matrix)]
        log.section(f"ABLATION STUDY: {len(matrix)} experiments")

        completed = {} if (rerun or not resume) else self._load_completed()
        if rerun and self.main:
            for e in matrix:
                p = self._result_path(e.experiment_id)
                if p.exists():
                    p.unlink()
        self._synced()
        if completed:
            log.info("resuming: %d experiments already completed",
                     len(completed))

        results: List[ExperimentResult] = list(completed.values())
        try:
            for i, exp in enumerate(matrix):
                eid = exp.experiment_id
                if eid in completed:
                    log.info("[%d/%d] skip completed %s", i + 1,
                             len(matrix), eid)
                    continue
                self._save_progress(len([r for r in results
                                         if r.status == "completed"]),
                                    len(matrix), eid)
                r = self.trainer.run_experiment(exp)
                self._save_result(r)
                results.append(r)
                if r.status == "interrupted":
                    log.warning("interrupted during %s — writing partial "
                                "report", eid)
                    self._report(results)
                    raise GracefulInterrupt(eid)
                self._report(results)          # incremental report
                self._synced()
        except KeyboardInterrupt:
            log.warning("interrupted — writing partial report")
            self._report(results)
            raise GracefulInterrupt("keyboard")

        self._save_progress(len([r for r in results
                                 if r.status == "completed"]),
                            len(matrix), "")
        self._report(results)
        self._synced()
        self._summary(results)
        return results

    def _summary(self, results: List[ExperimentResult]) -> None:
        ev = AblationEvaluator(results, self.config.primary_metric,
                               self.config.model_type)
        ranking = ev.ranking()
        if ranking:
            best = ranking[0]
            self.log.section("BEST EXPERIMENT")
            self.log.key_value("id", best.experiment_id)
            self.log.key_value(self.config.primary_metric,
                               f"{best.metrics.get(self.config.primary_metric, 0):.4f}")
        failed = [r for r in results if r.status == "failed"]
        if failed:
            self.log.warning(f"{len(failed)} experiments failed: "
                             f"{[r.experiment_id for r in failed]}")
