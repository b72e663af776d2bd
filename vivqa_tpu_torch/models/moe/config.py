"""MoE configuration, copied from vivqa_tpu/models/moe/config.py (reference: src/modeling/moe/moe_config.py:10-158)."""

from __future__ import annotations

import dataclasses

from vivqa_tpu_torch.config.base import ConfigBase

ROUTER_TYPES = ("topk", "noisy_topk", "soft", "expert_choice")
EXPERT_TYPES = ("feedforward", "glu", "vision", "text", "multimodal",
                "segmentation", "object_detection", "ocr",
                "scene_understanding", "spatial_reasoning", "counting")
SPECIALIZED_TYPES = ("segmentation", "object_detection", "ocr",
                     "scene_understanding", "spatial_reasoning", "counting")


@dataclasses.dataclass(frozen=True)
class RouterConfig(ConfigBase):
    router_type: str = "topk"
    top_k: int = 2
    temperature: float = 1.0
    noise_std: float = 1.0          # noisy_topk initial noise scale
    capacity_factor: float = 1.25   # expert_choice / sparse dispatch
    load_balance_weight: float = 0.01
    z_loss_weight: float = 0.0
    entropy_weight: float = 0.0     # soft router entropy regularizer


@dataclasses.dataclass(frozen=True)
class ExpertConfig(ConfigBase):
    expert_type: str = "feedforward"
    hidden_dim: int = 1024
    num_heads: int = 8
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class MoEConfig(ConfigBase):
    """Standard/sparse/hierarchical MoE over homogeneous experts."""
    num_experts: int = 4
    input_dim: int = 512
    expert: ExpertConfig = dataclasses.field(default_factory=ExpertConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    moe_type: str = "standard"      # standard | sparse | hierarchical
    num_groups: int = 2             # hierarchical only


@dataclasses.dataclass(frozen=True)
class VQAMoEConfig(ConfigBase):
    """Heterogeneous VQA MoE: vision/text/multimodal/specialized expert
    groups in a FIXED order (reference VQAMOELayer builds them in order
    vision->text->multimodal->specialized, moe_layer.py:617-689 — the
    ablation expert masks index into that order)."""
    input_dim: int = 512
    num_vision_experts: int = 2
    num_text_experts: int = 2
    num_multimodal_experts: int = 2
    specialized_types: tuple = ()   # subset of SPECIALIZED_TYPES
    expert_hidden_dim: int = 1024
    num_heads: int = 8
    dropout: float = 0.1
    router: RouterConfig = dataclasses.field(
        default_factory=lambda: RouterConfig(router_type="noisy_topk"))

    @property
    def num_experts(self) -> int:
        return (self.num_vision_experts + self.num_text_experts +
                self.num_multimodal_experts + len(self.specialized_types))

    def expert_index_ranges(self) -> dict[str, tuple[int, int]]:
        """Fixed-order index ranges for ablation masks
        (reference: ablation_trainer.py:47-71)."""
        out, start = {}, 0
        for name, n in (("vision", self.num_vision_experts),
                        ("text", self.num_text_experts),
                        ("multimodal", self.num_multimodal_experts),
                        ("specialized", len(self.specialized_types))):
            out[name] = (start, start + n)
            start += n
        return out
