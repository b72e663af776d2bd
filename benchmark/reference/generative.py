"""Plain reference of the generative VQA model: the ViT image tower and
the BERT-family question tower, a fusion encoder over the concatenated
image and question tokens (pre-LN layers under the padding mask, a final
LayerNorm), and a pre-LN transformer decoder (scaled token embedding
plus sinusoidal positions; causal self-attention, cross-attention to the
fused memory, MLP) whose output projection is the token embedding's
transpose, in float32.

Teacher forcing: ``decoder_input_ids`` is BOS and the answer, ``labels``
the answer and EOS, padded with -100. The loss is the label-smoothed
cross-entropy over the labels that count, divided by their number.
Departures from the program's arithmetic, on purpose: float32
everywhere; the embedding scale is sqrt(D) in float32, where the
program rounds it to its compute type first.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark.reference.layers import (CrossLayer, EncoderLayer, Embed,
                                        LayerNorm, Linear, Precision,
                                        TextEncoder, ViT, attention_mask)
from benchmark.reference.vqa import cross_entropy_sum

IGNORE_INDEX = -100


def sinusoidal(length: int, dim: int) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    table = np.zeros((length, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div[: (dim + 1) // 2])
    return torch.from_numpy(table)


class Fusion(nn.Module):
    def __init__(self, c: dict, prec):
        super().__init__()
        D = c["fusion_dim"]
        self.v_proj = Linear(c["visual"]["hidden_dim"], D, prec)
        self.q_proj = Linear(c["text"]["hidden_dim"], D, prec)
        self.layers = nn.ModuleList(
            EncoderLayer(D, c["fusion_heads"], 4 * D, prec,
                         dropout=c["dropout"])
            for _ in range(c["fusion_layers"]))
        self.ln_final = LayerNorm(D)

    def forward(self, v_tokens, q_tokens, q_mask, drop=None, recorder=None):
        x = torch.cat([self.v_proj(v_tokens), self.q_proj(q_tokens)], dim=1)
        mask = torch.cat([torch.ones(v_tokens.shape[:2], dtype=q_mask.dtype,
                                     device=q_mask.device), q_mask], dim=1)
        am = attention_mask(mask, mask)
        for layer in self.layers:
            x = layer(x, am, drop, recorder)
        return self.ln_final(x), mask


class Decoder(nn.Module):
    def __init__(self, c: dict, prec):
        super().__init__()
        D = c["decoder_dim"]
        self.c, self.prec = c, prec
        self.token_embed = Embed(c["vocab_size"], D)
        self.layers = nn.ModuleList(
            CrossLayer(D, c["decoder_heads"], c["decoder_ff_dim"], prec,
                       context_dim=c["fusion_dim"], dropout=c["dropout"])
            for _ in range(c["decoder_layers"]))
        self.ln_final = LayerNorm(D)

    def forward(self, ids, dec_mask, memory, memory_mask, drop=None,
                recorder=None):
        c = self.c
        L, D = ids.shape[1], c["decoder_dim"]
        pos = sinusoidal(c["max_answer_length"], D)[:L].to(memory.device)
        x = self.token_embed(ids) * math.sqrt(D) + pos
        x = x if drop is None else drop(x, c["dropout"])
        self_mask = attention_mask(dec_mask, dec_mask)
        cross_mask = attention_mask(None, memory_mask)
        for layer in self.layers:
            x = layer(x, memory, self_mask, cross_mask, causal=True,
                      drop=drop, recorder=recorder)
        x = self.ln_final(x)
        return self.prec.einsum("bld,vd->blv", x, self.token_embed.weight)


class Model(nn.Module):
    """``batch``: pixel_values, question_ids, question_mask,
    decoder_input_ids, decoder_mask, labels."""
    task = "generative"
    routers = 0

    def __init__(self, config: dict, prec: Precision = Precision()):
        super().__init__()
        c = config
        if c["moe"]["use_moe"] or c["knowledge"]["use_knowledge"] \
                or not c["tie_embeddings"] \
                or c["visual"]["backbone"] not in ("vit", "clip") \
                or c["visual"]["output_dim"] or c["text"]["output_dim"]:
            raise NotImplementedError("the reference covers ViT towers, "
                                      "tied embeddings, no MoE and no "
                                      "knowledge")
        self.config = c
        self.visual_encoder = ViT(c["visual"], prec)
        self.question_encoder = TextEncoder(c["text"], prec)
        self.fusion = Fusion(c, prec)
        self.decoder = Decoder(c, prec)

    def logits(self, batch: dict, drop=None, recorder=None):
        _, v_tokens = self.visual_encoder(batch["pixel_values"], drop,
                                          recorder)
        _, q_tokens = self.question_encoder(batch["question_ids"],
                                            batch["question_mask"], drop,
                                            recorder)
        memory, mask = self.fusion(v_tokens, q_tokens,
                                   batch["question_mask"], drop, recorder)
        return self.decoder(batch["decoder_input_ids"],
                            batch["decoder_mask"], memory, mask, drop,
                            recorder), []

    def loss_count(self, batch: dict) -> int:
        return int((batch["labels"] != IGNORE_INDEX).sum())

    def loss_sum(self, batch: dict, drop=None, recorder=None,
                 label_smoothing: float = 0.0):
        logits, stats = self.logits(batch, drop, recorder)
        return cross_entropy_sum(logits, batch["labels"].long(),
                                 label_smoothing, IGNORE_INDEX), stats
