"""Host-side utilities (counterpart of vivqa_tpu/utils): the pipeline
logger."""

from vivqa_tpu_torch.utils.logger import PipelineLogger, get_pipeline_logger

__all__ = ["PipelineLogger", "get_pipeline_logger"]
