"""Plain reference of the decoder-only VQA model on Kimi-VL-A3B's language
model (the DeepSeek-V3 layout), as one chip of an expert-parallel
deployment holds it, in float32.

The image's patch tokens (the ViT tower of ``layers.py``) pass through
a projector (LayerNorm, linear, exact GELU, linear) and start each
sample's sequence: the image tokens, the question's real tokens, BOS and
the answer's tokens, then zeros up to image + question + answer
positions. Position p is the p-th token. Each layer is
x + MLA(RMSNorm(x)), then + FFN(RMSNorm(.)): a dense SwiGLU in the first
``first_k_dense_replace`` layers, after them the MoE. Then a final
RMSNorm and the untied head, over the labelled answer positions.

- MLA (HF's ``DeepseekV3Attention``, no query compression): q = W_q x,
  per head ``qk_nope_head_dim`` + ``qk_rope_head_dim``; [c, k_pe] = W_kva
  x; [k_nope, v] = W_kvb RMSNorm(c); the rotary embedding of q_pe and of
  the one shared k_pe; softmax(q k^T / sqrt(nope + rope)) over the keys
  that are at or before the query and real; W_o.
- The rotary embedding turns each adjacent pair (x[2i], x[2i+1]) by
  p / theta^(2i / rope), in place. HF first lays the pairs out as halves
  and turns those; q and k are laid out alike, so q . k is the same.
- MoE (HF's ``DeepseekV3MoE``, ``noaux_tc``, one group): s = sigmoid of
  the router's logits over all ``n_routed_experts``; each real token's
  top ``num_experts_per_tok`` by s + the correction bias, weighted by s
  normalised to sum 1 and times ``routed_scaling_factor``. The bias
  starts at zero and stands in for one that keeps the loads even, as
  the configuration asks, from the real tokens of the first
  ``bias_fit_samples`` samples of a step (its first block): the fit
  moves it towards the bias under which each expert is chosen for
  T = N k / E of those N tokens; each iteration moves every expert's
  bias half the way to the midpoint of the T-th and (T+1)-th largest of
  its margins over the k-th best of the other experts' biased scores.
  The first step's first block fits it so, 20 times, before routing;
  with ``bias_update_iterations``, each later step's first block first
  moves it on by that many iterations, and the step's blocks route by
  the bias it found. Only the held experts [e0, e1)
  are computed, each on the tokens routed to it (gathered, so a product
  counter sees the routed work); the shared experts (one SwiGLU of
  ``n_shared_experts`` x the expert width) on every position.

On the meta device (the benchmark's product count) each held expert
takes the even share of the real tokens' assignments, real tokens x k /
``n_routed_experts`` rows, and the head the positions the decoder mask
marks (the traffic labels exactly those). The tower's attention calls
are recorded, no MLA call: MLA runs on no kernel of the attention
metrics. Every product's operands go through ``Precision``.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from benchmark.reference.layers import Embed, LayerNorm, Linear, Precision, ViT
from benchmark.reference.vqa import cross_entropy_sum

IGNORE_INDEX = -100


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * self.weight


def rotate_pairs(x, theta: float):
    """x (..., L, d): pair i of position p turned by p / theta^(2i/d)."""
    L, d = x.shape[-2], x.shape[-1]
    freq = theta ** (-torch.arange(0, d, 2, dtype=torch.float64) / d)
    ang = (torch.arange(L, dtype=torch.float64)[:, None] * freq).float() \
        .to(x.device)
    cos, sin = ang.cos(), ang.sin()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1) \
        .flatten(-2)


def fit_bias(s, k: int, bias, iterations: int = 20):
    """``bias`` (E,) moved towards the one under which each expert is
    among the top k of s + bias for T = N k / E of the N rows of s
    (N, E)."""
    N, E = s.shape
    T = max(1, min(N - 1, N * k // E))
    for _ in range(iterations):
        v = s + bias
        kth, next_ = v.topk(k + 1, dim=-1).values[:, k - 1:].unbind(-1)
        # the k-th best of the other experts: the (k+1)-th where this
        # one is in the top k
        other = torch.where(v >= kth[:, None], next_[:, None], kth[:, None])
        ranked = (v - other).sort(0, descending=True).values
        bias = bias - 0.5 * (ranked[T - 1] + ranked[T]) / 2
    return bias


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, prec):
        super().__init__()
        self.gate_proj = Linear(dim, hidden, prec, bias=False)
        self.up_proj = Linear(dim, hidden, prec, bias=False)
        self.down_proj = Linear(hidden, dim, prec, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MLA(nn.Module):
    def __init__(self, c: dict, prec):
        super().__init__()
        D, H = c["hidden_size"], c["num_attention_heads"]
        self.c, self.prec = c, prec
        nope, rope, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                          c["v_head_dim"])
        self.q_proj = Linear(D, H * (nope + rope), prec, bias=False)
        self.kv_a_proj = Linear(D, c["kv_lora_rank"] + rope, prec,
                                bias=False)
        self.ln_kv = RMSNorm(c["kv_lora_rank"], c["rms_norm_eps"])
        self.kv_b_proj = Linear(c["kv_lora_rank"], H * (nope + vd), prec,
                                bias=False)
        self.o_proj = Linear(H * vd, D, prec, bias=False)

    def forward(self, x, allowed):
        c = self.c
        B, L, _ = x.shape
        H, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                             c["qk_rope_head_dim"], c["v_head_dim"])
        q = self.q_proj(x).view(B, L, H, nope + rope).transpose(1, 2)
        ckv = self.kv_a_proj(x)
        kv = self.kv_b_proj(self.ln_kv(ckv[..., :c["kv_lora_rank"]]))
        kv = kv.view(B, L, H, nope + vd).transpose(1, 2)
        k_pe = rotate_pairs(ckv[..., c["kv_lora_rank"]:], c["rope_theta"])
        q_pe = rotate_pairs(q[..., nope:], c["rope_theta"])
        s = (self.prec.einsum("bhqd,bhkd->bhqk", q[..., :nope],
                              kv[..., :nope])
             + self.prec.einsum("bhqd,bkd->bhqk", q_pe, k_pe)) \
            / (nope + rope) ** 0.5
        p = torch.softmax(torch.where(allowed, s, -1e30), dim=-1)
        o = self.prec.einsum("bhqk,bhkd->bqhd", p, kv[..., nope:])
        return self.o_proj(o.reshape(B, L, H * vd))


class MoE(nn.Module):
    def __init__(self, c: dict, prec):
        super().__init__()
        D, F_ = c["hidden_size"], c["moe_intermediate_size"]
        e0, e1 = c["experts_held"]
        self.c, self.prec, self.e0 = c, prec, e0
        self.router = nn.Module()
        self.router.gate = Linear(D, c["n_routed_experts"], prec, bias=False)
        self.experts_w_gate = nn.Parameter(torch.empty(e1 - e0, D, F_))
        self.experts_w_up = nn.Parameter(torch.empty(e1 - e0, D, F_))
        self.experts_w_down = nn.Parameter(torch.empty(e1 - e0, F_, D))
        self.shared = SwiGLU(D, c["n_shared_experts"] * F_, prec)
        self.register_buffer("bias", torch.zeros(c["n_routed_experts"]))
        self.fit = c.get("bias_fit_samples", 0)
        self.iterations = c.get("bias_update_iterations", 0)
        # the router's weights' version at the step's first block
        self.step_at = None

    def expert(self, e: int, x):
        q = self.prec.q
        h = F.silu(q(x) @ q(self.experts_w_gate[e])) \
            * (q(x) @ q(self.experts_w_up[e]))
        return q(h) @ q(self.experts_w_down[e])

    def forward(self, x, real, length: int):
        """x (N, D) every position of samples of ``length`` positions,
        ``real`` (N,) bool on the host."""
        c = self.c
        k, E = c["num_experts_per_tok"], self.experts_w_gate.shape[0]
        y = self.shared(x)
        s = torch.sigmoid(self.router.gate(x))
        version = self.router.gate.weight._version
        if x.device.type != "meta" and version != self.step_at:
            # a new step's first block
            n = self.fit * length
            first = self.step_at is None
            if self.fit and (first or self.iterations):
                self.bias.copy_(fit_bias(
                    s[:n][real[:n].to(x.device)].detach(), k, self.bias,
                    20 if first else self.iterations))
            self.step_at = version
        if x.device.type == "meta":
            n = int(real.sum()) * k // c["n_routed_experts"]
            rows = torch.zeros(n, dtype=torch.long, device="meta")
            for e in range(E):
                y = y.index_add(0, rows, self.expert(e, x[:n]))
            return y
        top = torch.topk(s + self.bias, k, dim=-1).indices
        w = s.gather(-1, top)
        if c["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * c["routed_scaling_factor"]
        real = real.to(x.device)
        for e in range(E):
            hit = (top == self.e0 + e) & real[:, None]
            rows = hit.any(-1).nonzero()[:, 0]
            if len(rows):
                gate = (w * hit).sum(-1)[rows, None]
                y = y.index_add(0, rows, gate * self.expert(e, x[rows]))
        return y


class Layer(nn.Module):
    def __init__(self, c: dict, prec, dense: bool):
        super().__init__()
        self.ln_attn = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        self.attn = MLA(c, prec)
        self.ln_mlp = RMSNorm(c["hidden_size"], c["rms_norm_eps"])
        if dense:
            self.mlp = SwiGLU(c["hidden_size"], c["intermediate_size"], prec)
        else:
            self.moe = MoE(c, prec)

    def forward(self, x, allowed, real):
        x = x + self.attn(self.ln_attn(x), allowed)
        h = self.ln_mlp(x)
        if hasattr(self, "mlp"):
            return x + self.mlp(h)
        B, L, D = h.shape
        return x + self.moe(h.reshape(B * L, D), real.reshape(-1), L) \
            .view(B, L, D)


class Model(nn.Module):
    """``batch``: pixel_values, question_ids, question_mask,
    decoder_input_ids, decoder_mask, labels."""
    task = "generative"
    routers = 0

    def __init__(self, config: dict, prec: Precision = Precision()):
        super().__init__()
        c = config
        self.c, self.prec = c, prec
        V, D = c["vocab_size"], c["hidden_size"]
        self.visual_encoder = ViT(c["visual"], prec)
        self.projector = nn.Module()
        self.projector.ln_in = LayerNorm(c["visual"]["hidden_dim"],
                                         c["projector_ln_eps"])
        self.projector.fc1 = Linear(c["visual"]["hidden_dim"],
                                    c["visual"]["hidden_dim"], prec)
        self.projector.fc2 = Linear(c["visual"]["hidden_dim"], D, prec)
        self.token_embed = Embed(V, D)
        self.layers = nn.ModuleList(
            Layer(c, prec, i < c["first_k_dense_replace"])
            for i in range(c["num_hidden_layers"]))
        self.ln_final = RMSNorm(D, c["rms_norm_eps"])
        self.lm_head = Linear(D, V, prec, bias=False)

    def hidden(self, batch: dict, recorder=None):
        """(hidden (B, S, D) of every position, the image and question
        lengths (B,) on the host, S)."""
        p = self.projector
        _, img = self.visual_encoder(batch["pixel_values"], None, recorder)
        img = p.fc2(F.gelu(p.fc1(p.ln_in(img))))
        q = self.token_embed(batch["question_ids"])
        a = self.token_embed(batch["decoder_input_ids"])
        qlen = batch["question_mask"].sum(1).tolist()
        alen = batch["decoder_mask"].sum(1).tolist()
        B, Lv, D = img.shape
        S = Lv + q.shape[1] + a.shape[1]
        rows = []
        for b in range(B):
            n = Lv + qlen[b] + alen[b]
            rows.append(torch.cat([img[b], q[b, :qlen[b]], a[b, :alen[b]],
                                   img.new_zeros(S - n, D)]))
        x = torch.stack(rows)
        length = torch.tensor([Lv + qn + an for qn, an in zip(qlen, alen)])
        pos = torch.arange(S)
        real = pos[None] < length[:, None]
        allowed = (pos[:, None] >= pos[None]) & real[:, None, None, :]
        allowed = allowed.to(x.device)
        for layer in self.layers:
            x = layer(x, allowed, real)
        return x, [Lv + n for n in qlen], S

    def logits(self, batch: dict, drop=None, recorder=None):
        """Logits (n, vocab) of the labelled answer positions, row-major,
        and no router statistics."""
        x, start, S = self.hidden(batch, recorder)
        labels = batch["labels"]
        if labels.device.type == "meta":
            labelled = batch["decoder_mask"] != 0
        else:
            labelled = labels != IGNORE_INDEX
        b, t = labelled.cpu().nonzero(as_tuple=True)
        at = b * S + torch.tensor(start)[b] + t
        h = self.ln_final(x.flatten(0, 1)[at.to(x.device)])
        return self.lm_head(h), []

    def loss_count(self, batch: dict) -> int:
        return int((batch["labels"] != IGNORE_INDEX).sum())

    def loss_sum(self, batch: dict, drop=None, recorder=None,
                 label_smoothing: float = 0.0):
        logits, stats = self.logits(batch, drop, recorder)
        labels = batch["labels"]
        if labels.device.type == "meta":
            labels = torch.zeros(logits.shape[0], dtype=torch.long,
                                 device="meta")
        else:
            labels = labels[labels != IGNORE_INDEX]
        return cross_entropy_sum(logits, labels.long(), label_smoothing), \
            stats
