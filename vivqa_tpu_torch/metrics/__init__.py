"""Metric suite + factory bundles: a copy of vivqa_tpu/metrics (host-side
Python; the port imports nothing of the JAX package). Reference:
create_* factories, src/solvers/metrics/vqa_metrics.py:1199-1234."""

from vivqa_tpu_torch.metrics.base import BaseMetric, MetricCollection, MetricResult
from vivqa_tpu_torch.metrics.nlg_metrics import (BLEUScore, CIDErScore, METEORScore,
                                           ROUGEScore, meteor_score,
                                           rouge_l_f1, rouge_n_f1)
from vivqa_tpu_torch.metrics.vqa_metrics import (AnswerTypeAccuracy,
                                           ExactMatchAccuracy, F1Score,
                                           PrecisionRecallF1, TopKAccuracy,
                                           VQAAccuracy, VQASoftAccuracy, WUPS,
                                           classify_question_type,
                                           normalize_answer)


def create_classification_metrics(top_k: int = 5) -> MetricCollection:
    """Bundle used by classification validation (reference
    training_pipeline.py:536-741 computes these inline)."""
    return MetricCollection({
        "vqa_accuracy": VQAAccuracy(),
        "topk_accuracy": TopKAccuracy(k=top_k),
        "f1_macro": F1Score("macro"),
        "f1_weighted": F1Score("weighted"),
        "answer_type_accuracy": AnswerTypeAccuracy(),
    })


def create_generative_metrics() -> MetricCollection:
    """Bundle for generative validation (reference
    generative_training_pipeline.py:364-469)."""
    return MetricCollection({
        "bleu": BLEUScore(),
        "meteor": METEORScore(),
        "rouge": ROUGEScore(),
        "cider": CIDErScore(),
        "exact_match": ExactMatchAccuracy(),
        "token_prf": PrecisionRecallF1(),
        "wups_0.9": WUPS(0.9),
        "wups_0.0": WUPS(0.0),
    })


__all__ = [
    "BaseMetric", "MetricCollection", "MetricResult",
    "VQAAccuracy", "VQASoftAccuracy", "TopKAccuracy", "ExactMatchAccuracy",
    "F1Score", "AnswerTypeAccuracy", "PrecisionRecallF1", "WUPS",
    "BLEUScore", "METEORScore", "ROUGEScore", "CIDErScore",
    "normalize_answer", "classify_question_type",
    "meteor_score", "rouge_l_f1", "rouge_n_f1",
    "create_classification_metrics", "create_generative_metrics",
]
