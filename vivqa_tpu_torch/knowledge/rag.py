"""RAG modules: batched context attention + retrieval-augmented fusion
(counterpart of vivqa_tpu/knowledge/rag.py).

Counterpart of src/modeling/knowledge_base/rag_module.py:35-730 in the
reference: ContextAttention (multi-head attention of a query vector over
the K retrieved context embeddings), RAGFusion (attention / add / concat
/ gated), RAGModule (host-side retrieve + encode with a static K) and
RAGLoss. As in the JAX package the two modules compute in bf16 whatever
the model's dtype (``_DTYPE``, read when a module is built); their
attention goes through ``ops/flash_attention.py``: one query over K keys
under the context mask, a context with no retrieved document being the
mean of its values (flax's rule for a fully masked row).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from vivqa_tpu_torch.knowledge.retrievers import BaseRetriever
from vivqa_tpu_torch.models.layers import (Dense, DropoutRNG, LayerNorm,
                                           MultiHeadDotProductAttention,
                                           make_attention_mask)

_DTYPE = torch.bfloat16


class ContextAttention(nn.Module):
    """Query vector attends over K retrieved context embeddings
    (reference :80-166): ``k_proj`` of the contexts, ``q_proj`` of the
    query, flax MHDPA (``attn``) and a LayerNorm (``ln``)."""

    def __init__(self, query_dim: int, context_dim: int, hidden_dim: int,
                 num_heads: int = 8):
        super().__init__()
        self.dtype = _DTYPE
        self.k_proj = Dense(context_dim, hidden_dim, dtype=_DTYPE)
        self.q_proj = Dense(query_dim, hidden_dim, dtype=_DTYPE)
        self.attn = MultiHeadDotProductAttention(hidden_dim, num_heads,
                                                 dtype=_DTYPE)
        self.ln = LayerNorm(hidden_dim, _DTYPE)

    def forward(self, query: torch.Tensor, contexts: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        """query (B, D); contexts (B, K, Dk) -> (B, hidden_dim)."""
        k = self.k_proj(contexts.to(self.dtype))
        q = self.q_proj(query.to(self.dtype))[:, None]
        mask = None
        if context_mask is not None:
            mask = make_attention_mask(
                torch.ones((query.shape[0], 1), dtype=torch.int32,
                           device=query.device), context_mask)
        return self.ln(self.attn(q, k, mask, rng)[:, 0])


class RAGFusion(nn.Module):
    """Fuse a feature vector with attended knowledge:
    attention | concat | gated | add (reference RAGModule fuse :169-350).
    ``merge`` (concat) and ``gate`` (gated) exist only for their
    strategy, as in the flax parameter tree."""

    STRATEGIES = ("attention", "add", "concat", "gated")

    def __init__(self, feature_dim: int, context_dim: int, hidden_dim: int,
                 strategy: str = "attention", num_heads: int = 8,
                 residual_weight: float = 0.5):
        super().__init__()
        if strategy not in self.STRATEGIES:
            raise ValueError(f"unknown RAG fusion strategy '{strategy}'")
        self.strategy = strategy
        self.residual_weight = residual_weight
        self.dtype = _DTYPE
        self.context_attn = ContextAttention(feature_dim, context_dim,
                                             hidden_dim, num_heads)
        if strategy == "concat":
            self.merge = Dense(feature_dim + hidden_dim, hidden_dim,
                               dtype=_DTYPE)
        elif strategy == "gated":
            self.gate = Dense(feature_dim + hidden_dim, hidden_dim,
                              dtype=_DTYPE)

    def forward(self, features: torch.Tensor, contexts: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        ctx = self.context_attn(features, contexts, context_mask, rng)
        f = features.to(self.dtype)
        if self.strategy in ("attention", "add"):
            return f + self.residual_weight * ctx
        h = torch.cat([f, ctx], dim=-1)
        if self.strategy == "concat":
            return self.merge(h)
        gate = torch.sigmoid(self.gate(h))
        return gate * f + (1 - gate) * ctx


@dataclasses.dataclass
class RAGModule:
    """Host-side retrieve + encode (reference :169-350); the arrays feed
    the model as ``knowledge_embeddings`` / ``knowledge_mask``.

        rag = RAGModule(retriever, knowledge_encoder, num_retrieved=5)
        ctx, mask, docs = rag.retrieve_batch(questions)     # host, numpy
    """
    retriever: BaseRetriever
    encoder: object                      # TextKnowledgeEncoder-like
    num_retrieved: int = 5

    def retrieve_batch(self, questions: Sequence[str]):
        """-> (embeddings (B, K, D) float32, mask (B, K) int32, doc lists).
        Static K: short retrievals are zero-padded."""
        results = self.retriever.retrieve_batch(list(questions),
                                                self.num_retrieved)
        B, K = len(questions), self.num_retrieved
        dim = self.encoder.dim if hasattr(self.encoder, "dim") else None
        all_texts, spans = [], []
        for res in results:
            texts = [r.document.content if r.document else "" for r in res]
            spans.append(len(texts))
            all_texts.extend(texts)
        if all_texts:
            flat = self.encoder.encode(all_texts)
            dim = flat.shape[-1]
        else:
            flat = np.zeros((0, dim or 256), np.float32)
            dim = flat.shape[-1]
        emb = np.zeros((B, K, dim), np.float32)
        mask = np.zeros((B, K), np.int32)
        pos = 0
        for i, n in enumerate(spans):
            emb[i, :n] = flat[pos:pos + n]
            mask[i, :n] = 1
            pos += n
        return emb, mask, results


def rag_loss(answer_loss: torch.Tensor, retrieval_scores: torch.Tensor,
             relevance: torch.Tensor,
             retrieval_weight: float = 0.5) -> torch.Tensor:
    """Joint answer + retrieval loss (reference RAGLoss :602): a listwise
    softmax CE pushing relevant contexts to score higher."""
    logp = torch.log_softmax(retrieval_scores.float(), dim=-1)
    rel = relevance.float()
    rel = rel / torch.clamp(rel.sum(-1, keepdim=True), min=1e-6)
    retrieval = -(rel * logp).sum(-1).mean()
    return answer_loss + retrieval_weight * retrieval
