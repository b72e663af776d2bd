"""Ablation study configuration & experiment matrix.

A copy of vivqa_tpu/ablation/config.py on the port's own modules.

Counterpart of src/ablation/ablation_config.py:28-677 in the reference:
expert ablation modes (full / no_moe / single_expert / leave_one_out /
subset), router ablations (type x top_k x load-balance weight with
redundancy skips), experiment ids `expertpart__routerpart`, matrix
generation with priority sort, YAML/JSON round-trip.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List

from vivqa_tpu_torch.config.base import ConfigBase

EXPERT_ABLATION_MODES = ("full", "no_moe", "single_expert", "leave_one_out",
                         "subset")
ROUTER_TYPES = ("topk", "noisy_topk", "soft", "expert_choice")


@dataclasses.dataclass(frozen=True)
class ExpertAblationConfig(ConfigBase):
    mode: str = "full"
    # expert indices kept (subset/single_expert) or dropped (leave_one_out)
    expert_indices: tuple = ()
    description: str = ""
    # post-hoc = apply the expert mask at EVAL time to the trained FULL
    # baseline (no retraining). Retrained ablations measure whether the
    # remaining capacity can re-learn the task; post-hoc ablations
    # measure whether the trained router/experts are load-bearing right
    # now — the classic trained-network ablation, and the study's
    # positive control (retraining heals redundant-capacity ablations,
    # so retrained rows can be null while post-hoc rows fire).
    post_hoc: bool = False

    @property
    def experiment_part(self) -> str:
        if self.mode == "full":
            return "full"
        if self.mode == "no_moe":
            return "no_moe"
        idx = "-".join(map(str, self.expert_indices))
        prefix = "ph_" if self.post_hoc else ""
        return f"{prefix}{self.mode}_{idx}"


@dataclasses.dataclass(frozen=True)
class RouterAblationConfig(ConfigBase):
    router_type: str = "noisy_topk"
    top_k: int = 2
    load_balance_weight: float = 0.01

    @property
    def experiment_part(self) -> str:
        return f"{self.router_type}_k{self.top_k}_lb{self.load_balance_weight}"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig(ConfigBase):
    expert: ExpertAblationConfig = dataclasses.field(
        default_factory=ExpertAblationConfig)
    router: RouterAblationConfig = dataclasses.field(
        default_factory=RouterAblationConfig)
    priority: int = 0

    @property
    def experiment_id(self) -> str:
        return f"{self.expert.experiment_part}__{self.router.experiment_part}"


@dataclasses.dataclass(frozen=True)
class AblationSearchSpace(ConfigBase):
    """What to sweep (reference AblationSearchSpace, :221-361)."""
    num_experts: int = 6
    include_full: bool = True
    include_no_moe: bool = True
    include_single_expert: bool = True
    include_leave_one_out: bool = True
    subset_sizes: tuple = ()              # e.g. (2, 3)
    max_subsets_per_size: int = 10
    router_types: tuple = ("noisy_topk",)
    top_k_values: tuple = (2,)
    load_balance_weights: tuple = (0.01,)
    cross_expert_router: bool = False     # full cross product if True
    # emit a post-hoc (eval-time, no retraining) twin of every masked
    # ablation — see ExpertAblationConfig.post_hoc. Twins are cheap (one
    # val sweep over the trained full baseline) and serve as the study's
    # positive control: they must fire where retrained rows heal.
    post_hoc_masks: bool = False

    def generate_expert_configs(self) -> List[ExpertAblationConfig]:
        out: List[ExpertAblationConfig] = []
        E = self.num_experts
        if self.include_full:
            out.append(ExpertAblationConfig("full",
                                            tuple(range(E)),
                                            "all experts enabled"))
        if self.include_no_moe:
            out.append(ExpertAblationConfig("no_moe", (),
                                            "MoE disabled entirely"))

        def _emit(mode, idx, desc):
            out.append(ExpertAblationConfig(mode, idx, desc))
            if self.post_hoc_masks:
                out.append(ExpertAblationConfig(
                    mode, idx, f"{desc} (post-hoc, eval-time)",
                    post_hoc=True))

        if self.include_single_expert:
            for i in range(E):
                _emit("single_expert", (i,), f"only expert {i}")
        if self.include_leave_one_out:
            for i in range(E):
                _emit("leave_one_out", (i,), f"all but expert {i}")
        for size in self.subset_sizes:
            combos = list(itertools.combinations(range(E), size))
            for c in combos[: self.max_subsets_per_size]:
                _emit("subset", c, f"subset {c}")
        return out

    def generate_router_configs(self) -> List[RouterAblationConfig]:
        """Cross product with redundancy skips: soft and expert_choice
        ignore top_k, so only emit them once per load-balance weight
        (reference :339-361)."""
        out: List[RouterAblationConfig] = []
        seen = set()
        for rt, k, lb in itertools.product(self.router_types,
                                           self.top_k_values,
                                           self.load_balance_weights):
            if rt in ("soft", "expert_choice"):
                key = (rt, lb)
                if key in seen:
                    continue
                seen.add(key)
                k = 0
            out.append(RouterAblationConfig(rt, k, lb))
        return out


@dataclasses.dataclass(frozen=True)
class AblationConfig(ConfigBase):
    """Root config: search space + shared training defaults."""
    search: AblationSearchSpace = dataclasses.field(
        default_factory=AblationSearchSpace)
    model_type: str = "classification"    # classification | generative
    num_epochs: int = 3
    batch_size: int = 16
    learning_rate: float = 1e-4
    output_dir: str = "outputs/ablation"
    primary_metric: str = "vqa_accuracy"  # bleu for generative
    seed: int = 42
    # optional human labels for expert indices (reports only); must
    # match the model's fixed expert order vision->text->multimodal->
    # specialized when set
    expert_names: tuple = ()

    def expert_label(self, index: int) -> str:
        if 0 <= index < len(self.expert_names):
            return f"{index}:{self.expert_names[index]}"
        return str(index)

    def generate_experiment_matrix(self) -> List[ExperimentConfig]:
        """Expert ablations with the default router + router ablations on
        the full-expert baseline (or the full cross product when
        cross_expert_router) — reference :470-563. Priority: baselines
        first, then expert ablations, then router ablations."""
        experts = self.search.generate_expert_configs()
        routers = self.search.generate_router_configs()
        default_router = routers[0] if routers else RouterAblationConfig()
        exps: List[ExperimentConfig] = []
        if self.search.cross_expert_router:
            for e, r in itertools.product(experts, routers):
                exps.append(ExperimentConfig(e, r))
        else:
            for e in experts:
                exps.append(ExperimentConfig(e, default_router))
            full = next((e for e in experts if e.mode == "full"),
                        ExpertAblationConfig("full",
                                             tuple(range(self.search.num_experts))))
            for r in routers[1:]:
                exps.append(ExperimentConfig(full, r))

        def priority(x: ExperimentConfig) -> int:
            if x.expert.mode == "full" and x.router == default_router:
                return 0
            if x.expert.mode == "no_moe":
                return 1
            if x.expert.mode in ("leave_one_out", "single_expert"):
                return 2
            return 3
        exps = [dataclasses.replace(x, priority=priority(x)) for x in exps]
        # dedupe by id, stable priority sort
        seen, unique = set(), []
        for x in sorted(exps, key=lambda x: x.priority):
            if x.experiment_id not in seen:
                seen.add(x.experiment_id)
                unique.append(x)
        return unique
