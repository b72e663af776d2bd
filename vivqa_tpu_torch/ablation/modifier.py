"""Functional MoE modification for ablation experiments.

A copy of vivqa_tpu/ablation/modifier.py on the port's own modules.

Counterpart of the reference's MOEModifier (src/ablation/
ablation_trainer.py:47-305), which monkey-patches `router.forward` at
runtime. Here modifications are DATA, not patches:

- `build_expert_mask` produces the (E,) multiplier passed into the model
  (`expert_mask` argument); routers apply -inf masking + renormalization
  (vivqa_tpu/models/moe/routers.py) — numerically the same semantics as
  the reference's zero+renormalize (:174-192), jit-compatible.
- `swap_router` / `disable_moe` return modified model CONFIGS; the
  param tree is re-initialized and compatible weights are merged by
  shape (router gates re-init, experts keep their weights).
- `collect_moe_metrics` summarizes router telemetry (entropy, usage,
  imbalance) from the metrics dict every layer already returns.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from vivqa_tpu_torch.ablation.config import ExpertAblationConfig, RouterAblationConfig


def compute_expert_index_ranges(num_vision: int, num_text: int,
                                num_multimodal: int, num_specialized: int
                                ) -> Dict[str, Tuple[int, int]]:
    """Fixed order vision -> text -> multimodal -> specialized
    (reference :47-71)."""
    out, start = {}, 0
    for name, n in (("vision", num_vision), ("text", num_text),
                    ("multimodal", num_multimodal),
                    ("specialized", num_specialized)):
        out[name] = (start, start + n)
        start += n
    return out


def build_expert_mask(ablation: ExpertAblationConfig,
                      num_experts: int) -> Optional[Tuple[float, ...]]:
    """(E,) multiplier tuple; None = no masking (reference :74-105)."""
    if ablation.mode in ("full", "no_moe"):
        return None
    mask = np.zeros(num_experts)
    if ablation.mode in ("single_expert", "subset"):
        for i in ablation.expert_indices:
            mask[i] = 1.0
    elif ablation.mode == "leave_one_out":
        mask[:] = 1.0
        for i in ablation.expert_indices:
            mask[i] = 0.0
    else:
        raise ValueError(f"unknown ablation mode '{ablation.mode}'")
    if mask.sum() == 0:
        raise ValueError(f"expert mask disables ALL {num_experts} experts "
                         f"({ablation.mode} {ablation.expert_indices})")
    return tuple(float(x) for x in mask)


def apply_router_ablation(model_config, router: RouterAblationConfig):
    """Return a model config with the router swapped (reference
    swap_router, :199-224). Works for both VQAModelConfig and
    GenerativeVQAConfig (both carry a MoEModelConfig `.moe`)."""
    moe = model_config.moe.replace(
        router_type=router.router_type,
        top_k=router.top_k or model_config.moe.top_k,
        load_balance_weight=router.load_balance_weight)
    return model_config.replace(moe=moe)


def apply_expert_ablation(model_config, ablation: ExpertAblationConfig):
    """no_moe -> disable the MoE layer entirely (reference disable_moe,
    :226-240); other modes leave the config alone (mask handles them)."""
    if ablation.mode == "no_moe":
        return model_config.replace(moe=model_config.moe.replace(use_moe=False))
    return model_config


def collect_moe_metrics(moe_metrics: Dict) -> Dict[str, float]:
    """Routing entropy / usage ratios / load imbalance (reference
    collect_moe_metrics, :252-305)."""
    if not moe_metrics:
        return {}
    usage = np.asarray(moe_metrics.get("expert_usage", []), np.float32)
    out = {
        "routing_entropy": float(moe_metrics.get("routing_entropy", 0.0)),
        "load_imbalance": float(moe_metrics.get("load_imbalance", 0.0)),
    }
    if usage.size:
        out["expert_usage"] = [float(u) for u in usage]
        out["num_active_experts"] = int((usage > 1e-6).sum())
        mean = float(usage.mean())
        out["usage_std_over_mean"] = (float(usage.std()) / mean
                                      if mean > 0 else 0.0)
    return out
