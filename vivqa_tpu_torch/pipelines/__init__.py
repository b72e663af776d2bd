"""Pipelines of the port (counterpart of vivqa_tpu/pipelines): so far the
generative training pipeline and the shared utilities."""

from vivqa_tpu_torch.pipelines.common import (EarlyStopping, StepTimer,
                                              count_parameters)
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingOutput,
    GenerativeTrainingPipeline)

__all__ = ["EarlyStopping", "StepTimer", "count_parameters",
           "GenerativeTrainingConfig", "GenerativeTrainingOutput",
           "GenerativeTrainingPipeline"]
