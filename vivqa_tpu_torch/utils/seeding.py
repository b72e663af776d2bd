"""Seeding (counterpart of vivqa_tpu/utils/seeding.py): one call seeds
Python's ``random``, numpy's global generator and torch's, for the
host-side shuffles and the weight init that read them. The port's device
randomness comes from explicit ``torch.Generator``s seeded from the
returned seed (``train/state.py:TrainState``), as the JAX package hands
out an explicit key. The JAX package's ``enable_fast_prng`` selects a TPU
generator and has no counterpart here.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> int:
    """Seed ``random``, numpy and torch (CPU and every card); returns
    ``seed`` for the explicit generators."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return seed
