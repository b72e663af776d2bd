"""A dropless, sigmoid-routed expert layer with shared experts
(DeepSeek-V3's ``DeepseekV3MoE``, Kimi-VL's), that holds the routed
experts [e0, e1) of E.

- ``SigmoidRouter``: f32 logits over all E experts, s = sigmoid; the
  top-k of s + ``e_score_correction_bias`` are chosen (``noaux_tc`` with
  one group), weighted by s, normalised to sum 1 (``norm_topk_prob``) and
  scaled by ``routed_scaling_factor``. The bias steers selection only
  and is a persistent buffer: a checkpoint or a pretrained model
  carries it. Two optional stand-ins for a bias trained to keep the
  experts' loads even, both off by default (the bias then stays as
  initialised or loaded), both on the real tokens of the call's first
  ``fit_samples`` samples (``SigmoidRouter.fit_bias``, on the device):

  - ``fit_samples``: the layer's first training call, if the bias is
    still zero (as initialised), first fits it so that each expert
    takes k/E of those tokens (20 damped iterations);
  - ``update_iterations``: every later training call first moves the
    bias on from where it is by that many iterations of the same fit
    (the routers of a model in training move its loads from step to
    step faster than DeepSeek-V3's sign update of the bias, or the fit
    one step behind, keeps them steady).
- ``RoutedMoE``: each token's assignments to the held experts run
  through those experts' SwiGLUs (stacked (E_held, in, out), no biases),
  with no capacity: every such assignment is computed. The assignments
  are sorted by expert; the host reads each held expert's count (one
  wait for the card a layer, while the shared experts' products are
  queued) and each expert runs its rows as three cuBLAS products. The
  weighted outputs are added to their tokens in f32. Positions that
  ``real`` marks as padding are not routed. The shared experts (one
  SwiGLU of ``n_shared * hidden``) run on every position.

On one chip of a deployment that spreads the experts over chips, the
layer's output is this chip's part: what the absent experts would add is
left out, and no exchange stands in for them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from vivqa_tpu_torch.models.layers import Dense
from vivqa_tpu_torch.utils.profiling import count, span

# the bias fit's damped iterations: its residual halves with each
FIT_ITERATIONS = 20


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), bias-free (DeepseekV3MLP)."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.gate_proj = Dense(dim, hidden, bias=False, dtype=dtype)
        self.up_proj = Dense(dim, hidden, bias=False, dtype=dtype)
        self.down_proj = Dense(hidden, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class SigmoidRouter(nn.Module):
    def __init__(self, dim: int, num_experts: int, top_k: int,
                 scaling: float, normalize: bool):
        super().__init__()
        self.top_k, self.scaling, self.normalize = top_k, scaling, normalize
        self.gate = Dense(dim, num_experts, bias=False, dtype=torch.float32)
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(num_experts))
        # whether the first training call's fit was done or passed over
        self.fitted = False

    @torch.no_grad()
    def fit_bias(self, x: torch.Tensor, real: Optional[torch.Tensor] = None,
                 iterations: int = FIT_ITERATIONS) -> None:
        """Move the correction bias towards the value under which each
        expert is chosen for T = N k / E of the N real tokens among x
        (M, D) (``real`` (M,) bool; None: all M). From the present bias,
        each iteration moves every expert's bias half the way to the
        value at which, the others' biases held, it would take exactly T
        tokens: the midpoint of the T-th and (T+1)-th largest of its
        margins (by how much its biased score clears the k-th best of
        the other experts'). On the device, with no host read."""
        s = torch.sigmoid(self.gate(x))
        M, E = s.shape
        k = self.top_k
        n = torch.full((), M, device=s.device) if real is None \
            else real.sum()
        T = torch.minimum(n * k // E, n - 1).clamp(min=1).view(1)
        b = self.e_score_correction_bias.clone()
        for _ in range(iterations):
            v = s + b
            top = v.topk(k + 1, dim=-1).values
            margin = v - torch.where(v >= top[:, k - 1:k], top[:, k:k + 1],
                                     top[:, k - 1:k])
            if real is not None:
                margin = margin.masked_fill(~real[:, None], -torch.inf)
            m = margin.sort(0, descending=True).values
            b = b - (m.index_select(0, T - 1) + m.index_select(0, T))[0] / 4
        self.e_score_correction_bias.copy_(b)

    def forward(self, x: torch.Tensor):
        """x (..., D) -> (expert ids (..., k) int64, weights (..., k)
        f32)."""
        scores = torch.sigmoid(self.gate(x))
        idx = torch.topk(scores + self.e_score_correction_bias, self.top_k,
                         dim=-1).indices
        w = scores.gather(-1, idx)
        if self.normalize:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.scaling


class RoutedMoE(nn.Module):
    def __init__(self, dim: int, hidden: int, num_experts: int,
                 held: tuple, top_k: int, n_shared: int, scaling: float,
                 normalize: bool = True,
                 dtype: torch.dtype = torch.bfloat16, fit_samples: int = 0,
                 update_iterations: int = 0):
        super().__init__()
        e0, e1 = held
        if not 0 <= e0 < e1 <= num_experts:
            raise ValueError(f"held experts [{e0}, {e1}) do not lie in "
                             f"[0, {num_experts})")
        if update_iterations and not fit_samples:
            raise ValueError("the bias update reads the first fit_samples "
                             "samples: give fit_samples")
        self.e0, self.dtype = e0, dtype
        self.fit_samples, self.update_iterations = fit_samples, \
            update_iterations
        E = e1 - e0
        self.router = SigmoidRouter(dim, num_experts, top_k, scaling,
                                    normalize)
        self.experts_w_gate = nn.Parameter(torch.empty(E, dim, hidden))
        self.experts_w_up = nn.Parameter(torch.empty(E, dim, hidden))
        self.experts_w_down = nn.Parameter(torch.empty(E, hidden, dim))
        self.shared = SwiGLU(dim, n_shared * hidden, dtype) if n_shared \
            else None

    def forward(self, x: torch.Tensor,
                real: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, L, D), ``real`` (B, L) bool (None: every position) ->
        (B, L, D) in the compute dtype. Under a profiler: spans
        ``router``, ``shared`` and ``routed``; counters ``moe.routed``
        (real tokens x k), ``moe.held`` (assignments the held experts
        computed), ``moe.expert_rows`` (rows their products ran) and
        ``moe.held_peak`` (E_held x the busiest held expert's
        assignments)."""
        B, L, D = x.shape
        E = self.experts_w_gate.shape[0]
        x = x.to(self.dtype)
        flat = x.reshape(B * L, D)
        fit_n = self.fit_samples * L
        sample = None if real is None else real.reshape(-1)[:fit_n]
        router = self.router
        with span("router"):
            iterations = self.update_iterations
            if self.training and self.fit_samples and not router.fitted:
                # once: fit a bias still at zero (as initialised) in
                # full, keep a loaded one (one host read)
                router.fitted = True
                if not bool(router.e_score_correction_bias.any()):
                    iterations = FIT_ITERATIONS
            if self.training and iterations:
                router.fit_bias(flat[:fit_n], sample, iterations)
            idx, w = router(flat)
            k = idx.shape[-1]
            expert = idx.reshape(-1) - self.e0
            held = (expert >= 0) & (expert < E)
            if real is not None:
                held = held & real.reshape(-1, 1).expand(-1, k).reshape(-1)
            key = torch.where(held, expert, E)
            order = torch.argsort(key, stable=True)
            on_card = x.is_cuda
            counts = torch.empty(E + 1, dtype=torch.int64,
                                 pin_memory=on_card)
            counts.copy_(torch.zeros(E + 1, dtype=torch.int64,
                                     device=x.device).index_add_(
                0, key, torch.ones_like(key)), non_blocking=on_card)
            if on_card:
                ready = torch.cuda.Event()
                ready.record()
        count("moe.routed", B * L * k if real is None else real.sum() * k)
        if self.shared is None:
            y = torch.zeros(B * L, D, dtype=torch.float32, device=x.device)
        else:
            with span("shared"):
                y = self.shared(flat).float()
        with span("routed"):
            if on_card:
                ready.synchronize()
            sizes = counts[:E].tolist()
            n = sum(sizes)
            order = order[:n]
            tokens = order // k
            xs = flat.index_select(0, tokens)
            wg, wu, wd = (p.to(self.dtype) for p in (
                self.experts_w_gate, self.experts_w_up,
                self.experts_w_down))
            outs, start = [], 0
            for e, size in enumerate(sizes):
                xe = xs[start:start + size]
                start += size
                outs.append((F.silu(xe @ wg[e]) * (xe @ wu[e])) @ wd[e])
            ys = torch.cat(outs).float() * w.reshape(-1)[order][:, None]
            y = y.index_add(0, tokens, ys)
        count("moe.held", n)
        count("moe.expert_rows", n)
        count("moe.held_peak", E * max(sizes))
        return y.to(self.dtype).view(B, L, D)
