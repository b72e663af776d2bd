"""Host-side utilities (counterpart of vivqa_tpu/utils): the pipeline
logger, seeding, YAML, the memory guard, the device stopwatch and the
sample visualization."""

from vivqa_tpu_torch.utils.logger import PipelineLogger, get_pipeline_logger
from vivqa_tpu_torch.utils.memory_guard import (MemoryGuard,
                                                MemoryOverflowException,
                                                get_memory_guard)
from vivqa_tpu_torch.utils.profiling import (peak_tflops, time_chained,
                                             time_train_steps,
                                             train_step_flops)
from vivqa_tpu_torch.utils.seeding import set_seed
from vivqa_tpu_torch.utils.visualization import show_batch, show_sample
from vivqa_tpu_torch.utils.yaml_io import load_yaml, save_yaml

__all__ = ["PipelineLogger", "get_pipeline_logger", "set_seed",
           "load_yaml", "save_yaml", "MemoryGuard",
           "MemoryOverflowException", "get_memory_guard", "peak_tflops",
           "time_chained", "time_train_steps",
           "train_step_flops", "show_sample", "show_batch"]
