"""Plain reference of the classification VQA model: a ViT image tower, a
BERT-family question tower, MCAN fusion (self-attention layers over the
question; self-attention and question-guided attention layers over the
image tokens; attentional flattening of both), a dense top-k MoE over
the fused tokens whose masked mean joins the pooled vector, and an MLP
answer head over ``num_answers`` classes.

The configuration is the program's configuration as a dict (the
``config`` of the benchmark's configuration file). Each departure from
the program's arithmetic is on purpose: float32 everywhere, where the
program computes the towers, the fusion and the MoE in bfloat16; a
plain LayerNorm, where the program takes the variance as E[x^2] - E[x]^2.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.layers import (CrossLayer, DenseMoE, EncoderLayer,
                                        Linear, LayerNorm, Precision,
                                        TextEncoder, ViT, attention_mask,
                                        gelu_tanh)


class AttFlat(nn.Module):
    """MLP -> softmax over the tokens (masked at -1e9) -> weighted sum ->
    merge."""

    def __init__(self, dim: int, mlp_dim: int, glimpses: int, prec,
                 dropout: float):
        super().__init__()
        self.rate, self.prec = dropout, prec
        self.att_fc1 = Linear(dim, mlp_dim, prec)
        self.att_fc2 = Linear(mlp_dim, glimpses, prec)
        self.merge = Linear(glimpses * dim, dim, prec)

    def forward(self, x, mask=None, drop=None):
        att = gelu_tanh(self.att_fc1(x))
        att = self.att_fc2(drop(att, self.rate) if drop is not None else att)
        if mask is not None:
            att = torch.where(mask.to(att.device)[..., None] > 0, att, -1e9)
        att = torch.softmax(att, dim=1)
        flat = self.prec.einsum("blg,bld->bgd", att, x)
        return self.merge(flat.reshape(x.shape[0], -1))


class MCAN(nn.Module):
    def __init__(self, c: dict, visual_dim: int, text_dim: int, prec):
        super().__init__()
        D, H, r = c["hidden_dim"], c["num_heads"], c["dropout"]
        self.v_proj = Linear(visual_dim, D, prec)
        self.q_proj = Linear(text_dim, D, prec)
        self.enc = nn.ModuleList(EncoderLayer(D, H, 4 * D, prec, dropout=r)
                                 for _ in range(c["num_layers"]))
        self.dec = nn.ModuleList(CrossLayer(D, H, 4 * D, prec, dropout=r)
                                 for _ in range(c["num_layers"]))
        g, m = c["mcan_flat_glimpses"], c["mcan_flat_mlp_dim"]
        self.q_flat = AttFlat(D, m, g, prec, r)
        self.v_flat = AttFlat(D, m, g, prec, r)
        self.ln = LayerNorm(D)

    def forward(self, v_tokens, q_tokens, q_mask, drop=None, recorder=None):
        v, q = self.v_proj(v_tokens), self.q_proj(q_tokens)
        v_ones = torch.ones(v.shape[:2], dtype=q_mask.dtype,
                            device=q_mask.device)
        qq = attention_mask(q_mask, q_mask)
        v2q = attention_mask(v_ones, q_mask)
        for layer in self.enc:
            q = layer(q, qq, drop, recorder)
        for layer in self.dec:
            v = layer(v, q, cross_mask=v2q, drop=drop, recorder=recorder)
        pooled = self.ln(self.q_flat(q, q_mask, drop)
                         + self.v_flat(v, None, drop))
        tokens = torch.cat([v, q], dim=1)
        mask = torch.cat([v_ones, q_mask], dim=1)
        return pooled, tokens, mask


class Model(nn.Module):
    """``batch``: pixel_values (B, S, S, 3), input_ids (B, L),
    attention_mask (B, L), labels (B,)."""
    task = "classification"

    def __init__(self, config: dict, prec: Precision = Precision()):
        super().__init__()
        c = config
        for key in ("visual", "text", "fusion", "moe", "head", "knowledge"):
            if key not in c:
                raise ValueError(f"configuration has no '{key}'")
        if c["fusion"]["fusion_type"] != "mcan" \
                or c["visual"]["backbone"] not in ("vit", "clip") \
                or c["knowledge"]["use_knowledge"] \
                or c["visual"]["output_dim"] or c["text"]["output_dim"]:
            raise NotImplementedError("the reference covers ViT towers, "
                                      "MCAN fusion and no knowledge")
        m = c["moe"]
        if m["use_moe"] and (m["moe_type"] != "standard"
                             or m["router_type"] != "topk"
                             or m["router_z_weight"]):
            raise NotImplementedError("the reference covers the dense "
                                      "top-k MoE")
        self.config = c
        self.visual_encoder = ViT(c["visual"], prec)
        self.text_encoder = TextEncoder(c["text"], prec)
        D = c["fusion"]["hidden_dim"]
        self.fusion = MCAN(c["fusion"], c["visual"]["hidden_dim"],
                           c["text"]["hidden_dim"], prec)
        self.routers = 0
        if m["use_moe"]:
            # the experts' dropout is the MoE subsystem's default, 0.1
            self.moe = DenseMoE(D, m["num_experts"], m["expert_hidden_dim"],
                                m["top_k"], prec, dropout=0.1)
            self.routers = 1
        h = c["head"]
        if h["activation"] != "gelu":
            raise NotImplementedError("the reference's head is gelu")
        self.answer_head = nn.Module()
        dim = D
        for i, hidden in enumerate(h["hidden_dims"]):
            self.answer_head.add_module(f"fc{i}", Linear(dim, hidden, prec))
            dim = hidden
        self.answer_head.classifier = Linear(dim, c["num_answers"], prec)

    def logits(self, batch: dict, drop=None, recorder=None):
        """(logits (B, A), [(prob sums, assignment sums, tokens) of each
        router])."""
        _, v_tokens = self.visual_encoder(batch["pixel_values"], drop,
                                          recorder)
        _, q_tokens = self.text_encoder(batch["input_ids"],
                                        batch["attention_mask"], drop,
                                        recorder)
        pooled, tokens, mask = self.fusion(v_tokens, q_tokens,
                                           batch["attention_mask"], drop,
                                           recorder)
        stats = []
        if self.routers:
            tokens, s = self.moe(tokens, drop)
            stats.append(s)
            m = mask.to(tokens.device)[..., None].to(tokens.dtype)
            pooled = pooled + (tokens * m).sum(1) / m.sum(1).clamp(min=1e-6)
        x = pooled
        head = self.answer_head
        for i in range(len(self.config["head"]["hidden_dims"])):
            x = gelu_tanh(getattr(head, f"fc{i}")(x))
            if drop is not None:
                x = drop(x, self.config["head"]["dropout"])
        return head.classifier(x), stats

    def loss_count(self, batch: dict) -> int:
        return batch["labels"].shape[0]

    def loss_sum(self, batch: dict, drop=None, recorder=None,
                 label_smoothing: float = 0.0):
        """(sum over the rows of the cross-entropy, router stats)."""
        logits, stats = self.logits(batch, drop, recorder)
        return cross_entropy_sum(logits, batch["labels"].long(),
                                 label_smoothing), stats


def cross_entropy_sum(logits, labels, label_smoothing: float = 0.0,
                      ignore_index: int | None = None):
    """Sum of -sum_c t_c log softmax(logits)_c over the positions, t the
    label's one-hot smoothed to (1 - s) one-hot + s / C; positions at
    ``ignore_index`` count nothing."""
    logp = torch.log_softmax(logits, dim=-1)
    valid = None
    if ignore_index is not None:
        valid = labels != ignore_index
        labels = torch.where(valid, labels, 0)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if label_smoothing:
        nll = (1 - label_smoothing) * nll \
            - label_smoothing * logp.mean(dim=-1)
    if valid is not None:
        nll = torch.where(valid, nll, 0.0)
    return nll.sum()
