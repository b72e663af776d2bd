"""Mixture-of-experts layers and routers (counterpart of vivqa_tpu/models/moe)."""
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               RouterConfig, VQAMoEConfig)
from vivqa_tpu_torch.models.moe.layer import (HierarchicalMoE, MOELayer,
                                              SparseMOELayer, VQAMoELayer,
                                              create_moe_layer)
from vivqa_tpu_torch.models.moe.routed import RoutedMoE, SigmoidRouter
from vivqa_tpu_torch.models.moe.routers import (ExpertChoiceRouter,
                                                NoisyTopKRouter, SoftRouter,
                                                TopKRouter, create_router,
                                                load_balance_loss,
                                                router_z_loss)

__all__ = [
    "ExpertConfig", "MoEConfig", "RouterConfig", "VQAMoEConfig",
    "MOELayer", "SparseMOELayer", "VQAMoELayer", "HierarchicalMoE",
    "create_moe_layer", "create_router", "TopKRouter", "NoisyTopKRouter",
    "SoftRouter", "ExpertChoiceRouter", "load_balance_loss", "router_z_loss",
    "RoutedMoE", "SigmoidRouter",
]
