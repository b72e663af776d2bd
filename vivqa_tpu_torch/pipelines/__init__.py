"""Pipelines of the port (counterpart of vivqa_tpu/pipelines): the
classification data, model, training and CLI pipelines, the generative
training and CLI pipelines, the external ViVQA evaluation and the shared
utilities."""

from vivqa_tpu_torch.pipelines.common import (EarlyStopping, StepTimer,
                                              count_parameters, load_params)
from vivqa_tpu_torch.pipelines.data_pipeline import (DataPipeline,
                                                     DataPipelineConfig,
                                                     DataPipelineOutput)
from vivqa_tpu_torch.pipelines.generative_training_pipeline import (
    GenerativeTrainingConfig, GenerativeTrainingOutput,
    GenerativeTrainingPipeline)
from vivqa_tpu_torch.pipelines.generative_vqa_pipeline import (
    GenerativeVQAPipeline, GenerativeVQAPipelineConfig)
from vivqa_tpu_torch.pipelines.model_pipeline import (ModelPipeline,
                                                      ModelPipelineConfig,
                                                      ModelPipelineOutput)
from vivqa_tpu_torch.pipelines.training_pipeline import (
    TrainingPipeline, TrainingPipelineConfig, TrainingPipelineOutput)
from vivqa_tpu_torch.pipelines.vivqa_evaluation import (
    VivqaEvaluationConfig, VivqaEvaluationPipeline)
from vivqa_tpu_torch.pipelines.vqa_pipeline import (VQAPipeline,
                                                    VQAPipelineConfig,
                                                    build_argparser, main)

__all__ = ["EarlyStopping", "StepTimer", "count_parameters", "load_params",
           "DataPipeline", "DataPipelineConfig", "DataPipelineOutput",
           "GenerativeTrainingConfig", "GenerativeTrainingOutput",
           "GenerativeTrainingPipeline",
           "GenerativeVQAPipeline", "GenerativeVQAPipelineConfig",
           "VivqaEvaluationPipeline", "VivqaEvaluationConfig",
           "ModelPipeline", "ModelPipelineConfig", "ModelPipelineOutput",
           "TrainingPipeline", "TrainingPipelineConfig",
           "TrainingPipelineOutput",
           "VQAPipeline", "VQAPipelineConfig",
           "build_argparser", "main"]
