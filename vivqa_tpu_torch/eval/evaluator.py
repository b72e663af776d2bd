"""Standalone evaluator with question-type breakdown and error analysis
(counterpart of vivqa_tpu/eval/evaluator.py).

Counterpart of src/pipeline/evaluator/vqa_evaluator.py:65-541 in the
reference: full metric setup, Vietnamese question-type classification,
per-type accuracy + confusion data, error analysis (worst classes,
common confusions), JSON export, console summary table. The forward runs
in eval mode with no gradient on the model's device, so on the card it
goes through the serving attention kernel; metrics are computed on the
host from the f32 logits, as the JAX package computes them.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.data.loader import device_prefetch
from vivqa_tpu_torch.metrics import (ExactMatchAccuracy, F1Score,
                                     TopKAccuracy, VQAAccuracy, WUPS,
                                     classify_question_type)
from vivqa_tpu_torch.utils import get_pipeline_logger


@dataclasses.dataclass(frozen=True)
class EvaluatorConfig(ConfigBase):
    top_k: int = 5
    wups_threshold: float = 0.9
    num_error_examples: int = 10
    output_dir: str = "outputs/evaluation"


@dataclasses.dataclass
class EvaluationResult:
    metrics: Dict[str, float]
    per_question_type: Dict[str, Dict[str, float]]
    error_analysis: Dict
    num_samples: int
    wall_seconds: float


class VQAEvaluator:
    def __init__(self, config: EvaluatorConfig = EvaluatorConfig(),
                 logger=None):
        self.config = config
        self.log = logger or get_pipeline_logger()

    def evaluate(self, model: torch.nn.Module, loader,
                 id2answer: Dict[int, str]) -> EvaluationResult:
        """Evaluate ``model`` (on the device it is on) over ``loader``'s
        collated batches."""
        cfg = self.config
        t0 = time.time()
        device = next(model.parameters()).device
        model.eval()

        vqa, topk = VQAAccuracy(), TopKAccuracy(cfg.top_k)
        em, f1 = ExactMatchAccuracy(), F1Score("macro")
        wups = WUPS(cfg.wups_threshold)
        type_correct = defaultdict(int)
        type_total = defaultdict(int)
        confusions = Counter()
        errors: List[Dict] = []

        n = 0
        for batch in device_prefetch(iter(loader), device):
            with torch.no_grad():
                out = model(batch["pixel_values"], batch["input_ids"],
                            batch["attention_mask"])
            logits = out["logits"].float().cpu().numpy()
            nv = batch.get("_num_valid", len(batch["labels"]))
            logits = logits[:nv]
            labels = batch["labels"].cpu().numpy()[:nv]
            preds = logits.argmax(-1)
            n += len(labels)
            pred_strs = [id2answer.get(int(p), "<unk>") for p in preds]
            gold_strs = [id2answer.get(int(l), "<unk>") for l in labels]
            refs = batch.get("all_answers", [[g] for g in gold_strs])

            vqa.update(preds, batch.get("answer_counts",
                                        [{int(l): 10} for l in labels]))
            topk.update(logits, labels)
            f1.update(preds, labels)
            em.update(pred_strs, refs)
            wups.update(pred_strs, refs)

            questions = batch.get("question", [""] * len(labels))
            for i, (p, l, q) in enumerate(zip(preds, labels, questions)):
                qt = classify_question_type(q)
                type_total[qt] += 1
                if int(p) == int(l):
                    type_correct[qt] += 1
                else:
                    confusions[(gold_strs[i], pred_strs[i])] += 1
                    if len(errors) < cfg.num_error_examples:
                        probs = torch.softmax(torch.from_numpy(logits[i]), -1)
                        errors.append({"question": q, "gold": gold_strs[i],
                                       "pred": pred_strs[i],
                                       "confidence": float(probs[p])})

        metrics = {
            "vqa_accuracy": vqa.compute().value,
            f"top{cfg.top_k}_accuracy": topk.compute().value,
            "exact_match": em.compute().value,
            "f1_macro": f1.compute().value,
            f"wups_{cfg.wups_threshold}": wups.compute().value,
        }
        per_type = {t: {"accuracy": type_correct[t] / type_total[t],
                        "count": type_total[t]}
                    for t in type_total}
        error_analysis = {
            "top_confusions": [{"gold": g, "pred": p, "count": c}
                               for (g, p), c in confusions.most_common(10)],
            "examples": errors,
        }
        result = EvaluationResult(metrics, per_type, error_analysis, n,
                                  time.time() - t0)
        self._report(result)
        return result

    def _report(self, r: EvaluationResult) -> None:
        log = self.log
        log.subsection("Evaluation summary")
        log.log_metrics(r.metrics)
        if r.per_question_type:
            log.table(("question type", "accuracy", "count"),
                      [(t, f"{v['accuracy']:.3f}", v["count"])
                       for t, v in sorted(r.per_question_type.items())])

    def save(self, result: EvaluationResult,
             path: Optional[str] = None) -> Path:
        path = Path(path or Path(self.config.output_dir) /
                    "evaluation_results.json")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(dataclasses.asdict(result), indent=2,
                                   ensure_ascii=False, default=str))
        self.log.success(f"evaluation saved to {path}")
        return path
