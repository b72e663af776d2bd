"""MoE layers (counterpart of vivqa_tpu/models/moe/layer.py).

- ``MOELayer`` (dense): every expert sees every token; the router's
  combine is fused into the output einsum ('bleh,ehd,ble->bld') and the
  residual + LayerNorm sit outside it: y = LN(x + sum_e w_e * FF_e(x)).
  It computes in its input's dtype; the ``glu`` expert type gates the
  hidden units with sigmoid(x W_gate), any other type is the
  feed-forward expert, as in the JAX package.
- ``VQAMoELayer``: heterogeneous experts in the FIXED order vision ->
  text -> multimodal -> specialized (the ablation's expert masks index
  into it), each computed on every token; their outputs are stacked
  (B, L, E, D), combined densely by the router's weights and
  LayerNormed. A masked expert is still computed (its weight is 0).

- ``SparseMOELayer``: capacity dispatch, compute in k/E of the dense
  layer's. Each token takes its top-k experts by the router's combine
  weights (ties to the lower index); the T*k assignments are sorted by
  expert with a stable sort, so within an expert the earlier token comes
  first; an exclusive cumsum of the experts' counts gives each its place
  in its expert's queue, and an assignment past ``max(1, int(cf*T*k/E))``
  goes to a trash row at ``E*cap`` and is dropped (the residual carries
  the token). The kept rows are gathered into (E, cap, D), run through
  the bias-free stacked experts (no GLU, no dropout) and added back to
  their tokens, weighted by their gates, with ``index_add``.
  ``metrics["dropped_token_fraction"]`` joins the router's metrics.
- ``HierarchicalMoE``: a top-1 ``group_router`` over G groups, each a
  dense ``MOELayer`` of E/G experts (``group_{g}``) given its slice of
  ``expert_mask``, so an ablation's mask indexes the experts in group
  order; the groups' outputs are combined by the group router's weights,
  the aux losses summed, the metrics the group router's.

Expert parallelism: on a mesh whose 'model' axis splits the stacked
experts along E (``parallel/mesh.py``), ``MOELayer`` and
``SparseMOELayer`` compute this rank's E/m experts for all its tokens;
the router is replicated and decides on the full logits, the tokens and
the combine weights enter through ``copy_to_model`` (their gradients sum
the ranks' parts) and the partial combine is summed over 'model'. Under
data parallelism the sparse layer's capacity and queue order are the
global batch's: ``cap = cf * T * k / E`` with T the global token count,
and each rank's places in an expert's queue follow the preceding ranks'
tokens (their per-expert counts are all-gathered), so the same tokens
are dropped as on one device.

The experts live in a ``ModuleDict`` named ``experts`` whose keys are the
flax names after ``experts/`` (``vision_0``, ``specialized_3_ocr``), so
``from_jax.py`` maps them by path; the hierarchical layer's groups are a
``ModuleList`` named ``group``, whose ``group.0`` maps to ``group_0``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.layers import (DropoutRNG, LayerNorm, dropout,
                                           gelu_tanh, runs_split)
from vivqa_tpu_torch.models.moe.config import (ExpertConfig, MoEConfig,
                                               VQAMoEConfig)
from vivqa_tpu_torch.models.moe.experts import (MultimodalExpert, TextExpert,
                                                VisionExpert, create_expert)
from vivqa_tpu_torch.models.moe.routers import _top_k, create_router
from vivqa_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                  copy_to_model,
                                                  reduce_from_model)


class _ExpertParallel:
    """The expert-parallel split of a layer with stacked experts: this
    rank's experts are [e0, e1) of E."""
    axis: Optional[Axis] = None
    e0 = 0

    def use_mesh(self, mesh, sharded: set) -> set:
        if runs_split(self, sharded):
            self.axis = mesh.model
            self.e0 = mesh.model.rank * self.experts_w_in.shape[0]
        return set()


class MOELayer(_ExpertParallel, nn.Module):
    TP_LEAVES = ("experts_w_in", "experts_bias_in", "experts_w_out",
                 "experts_bias_out", "experts_w_gate")

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        E, H, D = cfg.num_experts, cfg.expert.hidden_dim, cfg.input_dim
        self.config = cfg
        self.dropout = cfg.expert.dropout       # on the experts' hidden units
        self.router = create_router(cfg.router, E, D)
        self.experts_w_in = nn.Parameter(torch.empty(E, D, H))
        self.experts_bias_in = nn.Parameter(torch.zeros(E, H))
        self.experts_w_out = nn.Parameter(torch.empty(E, H, D))
        self.experts_bias_out = nn.Parameter(torch.zeros(E, D))
        self.experts_w_gate = nn.Parameter(torch.empty(E, D, H)) \
            if cfg.expert.expert_type == "glu" else None
        self.ln_out = LayerNorm(D, dtype=None)     # in x's dtype

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        rout = self.router(x, expert_mask, rng)
        dt = x.dtype
        w = rout.combine_weights.to(dt)                          # (B, L, E)
        xe, split = x, None
        if self.axis is not None:
            El = self.experts_w_in.shape[0]
            xe, split = copy_to_model(x, self.axis), (2, self.axis)
            w = copy_to_model(w, self.axis)[..., self.e0:self.e0 + El]
        h = torch.einsum("bld,edh->bleh", xe, self.experts_w_in.to(dt))
        h = gelu_tanh(h + self.experts_bias_in.to(dt))
        if self.experts_w_gate is not None:
            h = h * torch.sigmoid(torch.einsum(
                "bld,edh->bleh", xe, self.experts_w_gate.to(dt)))
        h = dropout(h, self.dropout, rng, split)
        y = torch.einsum("bleh,ehd,ble->bld", h, self.experts_w_out.to(dt), w)
        y = y + torch.einsum("ble,ed->bld", w, self.experts_bias_out.to(dt))
        if self.axis is not None:
            y = reduce_from_model(y, self.axis)
        y = self.ln_out(y + x)
        return y, {"aux_loss": rout.aux_loss, "metrics": rout.metrics}


class VQAMoELayer(nn.Module):
    def __init__(self, config: VQAMoEConfig):
        super().__init__()
        cfg = config
        D = cfg.input_dim
        ex_cfg = ExpertConfig(hidden_dim=cfg.expert_hidden_dim,
                              num_heads=cfg.num_heads, dropout=cfg.dropout)
        experts = {}
        for kind, cls, n in (("vision", VisionExpert, cfg.num_vision_experts),
                             ("text", TextExpert, cfg.num_text_experts),
                             ("multimodal", MultimodalExpert,
                              cfg.num_multimodal_experts)):
            for i in range(n):
                experts[f"{kind}_{i}"] = cls(ex_cfg, D)
        for i, s in enumerate(cfg.specialized_types):
            experts[f"specialized_{i}_{s}"] = create_expert(
                ex_cfg.replace(expert_type=s), D)
        if len(experts) != cfg.num_experts:
            raise ValueError(f"{len(experts)} experts built, the config "
                             f"counts {cfg.num_experts}")
        self.config = cfg
        self.router = create_router(cfg.router, len(experts), D)
        self.experts = nn.ModuleDict(experts)
        self.ln_out = LayerNorm(D, dtype=None)     # in the experts' dtype

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        rout = self.router(x, expert_mask, rng)
        outs = [ex(x, rng) for ex in self.experts.values()]
        dt = outs[0].dtype
        for o in outs[1:]:
            dt = torch.promote_types(dt, o.dtype)
        outs = torch.stack([o.to(dt) for o in outs], dim=2)   # (B, L, E, D)
        y = torch.einsum("ble,bled->bld", rout.combine_weights.to(dt), outs)
        y = self.ln_out(y + x.to(dt))
        return y, {"aux_loss": rout.aux_loss, "metrics": rout.metrics}


class SparseMOELayer(_ExpertParallel, nn.Module):
    TP_LEAVES = ("experts_w_in", "experts_w_out")
    data: Optional[Axis] = None

    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        E, H, D = cfg.num_experts, cfg.expert.hidden_dim, cfg.input_dim
        self.config = cfg
        self.router = create_router(cfg.router, E, D)
        self.experts_w_in = nn.Parameter(torch.empty(E, D, H))
        self.experts_w_out = nn.Parameter(torch.empty(E, H, D))
        self.ln_out = LayerNorm(D, dtype=None)     # in x's dtype

    def use_mesh(self, mesh, sharded: set) -> set:
        self.data = mesh.data
        return super().use_mesh(mesh, sharded)

    def dispatch(self, combine_weights: torch.Tensor):
        """The capacity and each assignment's queue: (cap, sorted_e,
        sorted_t, sorted_g, pos, keep) for combine weights (T, E), the
        T*k assignments sorted by expert (stable: earlier tokens first),
        ``pos`` the place in the expert's queue of the global batch."""
        T, E = combine_weights.shape
        k = min(self.config.router.top_k, E)
        dev = combine_weights.device
        d = self.data if self.data is not None else Axis("data")
        cap = max(1, int(self.config.router.capacity_factor * T * d.size
                         * k / E))
        gates, top_idx = _top_k(combine_weights.float(), k)
        expert_flat = top_idx.reshape(T * k)
        order = torch.sort(expert_flat, stable=True).indices
        sorted_e = expert_flat[order]
        sorted_t = torch.arange(T, device=dev).repeat_interleave(k)[order]
        sorted_g = gates.reshape(T * k)[order]
        counts = F.one_hot(expert_flat, E).sum(0)       # no host sync
        seg_start = torch.cumsum(counts, 0) - counts
        pos = torch.arange(T * k, device=dev) - seg_start[sorted_e]
        if d.size > 1:
            before = all_gather(counts[None], d)[:d.rank].sum(0)
            pos = pos + before[sorted_e]
        return cap, sorted_e, sorted_t, sorted_g, pos, pos < cap

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        cfg = self.config
        B, L, D = x.shape
        E, k = cfg.num_experts, min(cfg.router.top_k, cfg.num_experts)
        T, dt, dev = B * L, x.dtype, x.device
        rout = self.router(x, expert_mask, rng)
        combine, xe = rout.combine_weights.reshape(T, E), x
        El, e0 = self.experts_w_in.shape[0], self.e0
        if self.axis is not None:
            combine = copy_to_model(combine, self.axis)
            xe = copy_to_model(x, self.axis)
        cap, sorted_e, sorted_t, sorted_g, pos, keep = self.dispatch(combine)
        dest = torch.where(keep, sorted_e * cap + pos, E * cap)
        # slot -> the token row that fills it; row T is a zero row, the
        # source of the empty slots (the trash row at E*cap is cut off)
        slot_token = torch.full((E * cap + 1,), T, dtype=torch.long,
                                device=dev)
        slot_token[dest] = sorted_t
        rows = torch.cat([xe.reshape(T, D), x.new_zeros(1, D)])
        expert_in = rows[slot_token[e0 * cap:(e0 + El) * cap]].view(
            El, cap, D)
        h = gelu_tanh(torch.einsum("ecd,edh->ech", expert_in,
                                   self.experts_w_in.to(dt)))
        expert_out = torch.einsum("ech,ehd->ecd", h,
                                  self.experts_w_out.to(dt)).reshape(
                                      El * cap, D)
        mine = keep & (sorted_e >= e0) & (sorted_e < e0 + El)
        contrib = expert_out[torch.where(mine, dest - e0 * cap, 0)] * \
            (sorted_g * mine.float())[:, None].to(dt)
        y = x.new_zeros(T, D).index_add(0, sorted_t, contrib)
        if self.axis is not None:
            y = reduce_from_model(y, self.axis)
        y = self.ln_out(y.view(B, L, D) + x)
        metrics = dict(rout.metrics)
        metrics["dropped_token_fraction"] = \
            1.0 - keep.sum().float() / max(T * k, 1)
        return y, {"aux_loss": rout.aux_loss, "metrics": metrics}


class HierarchicalMoE(nn.Module):
    def __init__(self, config: MoEConfig):
        super().__init__()
        cfg = config
        G = cfg.num_groups
        self.config = cfg
        self.per_group = cfg.num_experts // G
        self.group_router = create_router(cfg.router.replace(top_k=1), G,
                                          cfg.input_dim)
        self.group = nn.ModuleList(
            MOELayer(cfg.replace(num_experts=self.per_group,
                                 moe_type="standard"))
            for _ in range(G))

    def forward(self, x: torch.Tensor,
                expert_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None):
        g_out = self.group_router(x, None, rng)
        total_aux, ys = g_out.aux_loss, []
        for g, sub in enumerate(self.group):
            sub_mask = None if expert_mask is None else expert_mask[
                g * self.per_group:(g + 1) * self.per_group]
            y_g, aux_g = sub(x, sub_mask, rng)
            total_aux = total_aux + aux_g["aux_loss"]
            ys.append(y_g)
        ys = torch.stack(ys, dim=2)                             # (B, L, G, D)
        y = torch.einsum("blg,blgd->bld", g_out.combine_weights.to(ys.dtype),
                         ys)
        return y, {"aux_loss": total_aux, "metrics": g_out.metrics}


_LAYERS = {"standard": MOELayer, "sparse": SparseMOELayer,
           "hierarchical": HierarchicalMoE}


def create_moe_layer(config: MoEConfig | VQAMoEConfig) -> nn.Module:
    if isinstance(config, VQAMoEConfig):
        return VQAMoELayer(config)
    if config.moe_type not in _LAYERS:
        raise ValueError(f"unknown moe_type '{config.moe_type}'")
    return _LAYERS[config.moe_type](config)
