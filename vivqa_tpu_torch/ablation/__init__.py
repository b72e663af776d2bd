"""The MoE ablation study (counterpart of vivqa_tpu/ablation): the
experiment matrix, expert masks and router swaps, per-experiment training
on the card, the runner with resume, rerun and incremental reports, and
the analysis. ``python -m vivqa_tpu_torch.ablation.run_ablation`` is its
CLI."""

from vivqa_tpu_torch.ablation.analyzer import (AblationAnalyzer,
                                               ExpertContribution,
                                               MOERecommendation,
                                               PairwiseSynergy)
from vivqa_tpu_torch.ablation.config import (AblationConfig,
                                             AblationSearchSpace,
                                             ExperimentConfig,
                                             ExpertAblationConfig,
                                             RouterAblationConfig)
from vivqa_tpu_torch.ablation.evaluator import (AblationEvaluator,
                                                ExpertImportance,
                                                get_metrics_for_model_type)
from vivqa_tpu_torch.ablation.modifier import (apply_expert_ablation,
                                               apply_router_ablation,
                                               build_expert_mask,
                                               collect_moe_metrics,
                                               compute_expert_index_ranges)
from vivqa_tpu_torch.ablation.reporter import AblationReporter
from vivqa_tpu_torch.ablation.runner import AblationRunner, GracefulInterrupt
from vivqa_tpu_torch.ablation.trainer import AblationTrainer, ExperimentResult

__all__ = [
    "AblationConfig", "AblationSearchSpace", "ExperimentConfig",
    "ExpertAblationConfig", "RouterAblationConfig",
    "build_expert_mask", "apply_expert_ablation", "apply_router_ablation",
    "collect_moe_metrics", "compute_expert_index_ranges",
    "AblationTrainer", "ExperimentResult",
    "AblationRunner", "GracefulInterrupt",
    "AblationEvaluator", "ExpertImportance", "get_metrics_for_model_type",
    "AblationAnalyzer", "ExpertContribution", "PairwiseSynergy",
    "MOERecommendation", "AblationReporter",
]
