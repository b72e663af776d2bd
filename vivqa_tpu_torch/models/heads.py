"""Answer classification head (counterpart of vivqa_tpu/models/heads.py):
an MLP over ``hidden_dims`` in bf16, then the classifier in f32 so the
logits feed a stable softmax whatever the trunk's dtype."""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.config import AnswerHeadConfig
from vivqa_tpu_torch.models.layers import Dense, DropoutRNG, dropout, gelu_tanh

# flax's nn.gelu is the tanh form
_ACTS = {"gelu": gelu_tanh, "relu": F.relu, "tanh": torch.tanh,
         "silu": F.silu}


class AnswerHead(nn.Module):
    def __init__(self, config: AnswerHeadConfig, num_answers: int,
                 input_dim: int):
        super().__init__()
        self.act = _ACTS[config.activation]
        self.num_hidden = len(config.hidden_dims)
        self.dropout = config.dropout
        dim = input_dim
        for i, hidden in enumerate(config.hidden_dims):
            self.add_module(f"fc{i}", Dense(dim, hidden, dtype=torch.bfloat16))
            dim = hidden
        self.classifier = Dense(dim, num_answers, dtype=torch.float32)

    def forward(self, x: torch.Tensor,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        for i in range(self.num_hidden):
            x = self.act(getattr(self, f"fc{i}")(x))
            x = dropout(x, self.dropout, rng)
        return self.classifier(x)
