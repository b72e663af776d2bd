"""Training: losses, optimizers, freezing strategies, the train step and
the trainer (counterpart of vivqa_tpu/train)."""
from vivqa_tpu_torch.train.losses import (MultiTaskLoss,
                                          binary_cross_entropy_loss,
                                          contrastive_loss, create_loss,
                                          cross_entropy_loss, focal_loss,
                                          info_nce_loss, perplexity,
                                          soft_target_loss, triplet_loss)
from vivqa_tpu_torch.train.optimizers import (OptimizerConfig,
                                              SchedulerConfig,
                                              create_optimizer,
                                              create_schedule, decay_mask)
from vivqa_tpu_torch.train.state import (TrainState, make_eval_step,
                                         make_train_step)
from vivqa_tpu_torch.train.strategies import STRATEGIES, trainable_mask

__all__ = [
    "cross_entropy_loss", "soft_target_loss", "binary_cross_entropy_loss",
    "focal_loss", "contrastive_loss", "triplet_loss", "info_nce_loss",
    "perplexity", "MultiTaskLoss", "create_loss",
    "OptimizerConfig", "SchedulerConfig", "create_optimizer",
    "create_schedule", "decay_mask",
    "TrainState", "make_train_step", "make_eval_step",
    "STRATEGIES", "trainable_mask",
]
