"""KnowledgeProvider: the stage that makes RAG reachable end-to-end
(counterpart of vivqa_tpu/knowledge/provider.py).

In the reference, retrieval runs inside ``VietnameseVQAModel.forward``
per sample (src/modeling/meta_arch/vqa_model.py:689-702). As in the JAX
package, retrieval runs on the host data path instead: the provider wraps
a ``BatchLoader``, retrieves and encodes K contexts per question (memoised
per question string), and attaches fixed-shape ``knowledge_embeddings
(B, K, D)`` f32 / ``knowledge_mask (B, K)`` int32 arrays, which
``data/loader.py:device_prefetch`` copies to the device with the rest of
the batch (the mask as int64, by its rule for signed integers) for the
model's batched KnowledgeAttention.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from vivqa_tpu_torch.config.base import ConfigBase
from vivqa_tpu_torch.knowledge.document_store import Document
from vivqa_tpu_torch.knowledge.encoders import HashingTextEncoder
from vivqa_tpu_torch.knowledge.rag import RAGModule
from vivqa_tpu_torch.knowledge.retrievers import (DenseRetriever,
                                                  HybridRetriever,
                                                  SparseRetriever)
from vivqa_tpu_torch.knowledge.vector_store import create_vector_store


@dataclasses.dataclass(frozen=True)
class KnowledgeProviderConfig(ConfigBase):
    """Host-side retrieval config (reference KnowledgeConfig,
    kb_config.py:184-263)."""
    kb_path: str = ""            # JSON docs (utils.import_documents_json)
    retriever: str = "hybrid"    # dense | sparse | hybrid
    vector_store: str = "memory"  # memory | faiss
    num_retrieved: int = 5
    encoder_dim: int = 256       # hashing-encoder dim == knowledge_dim
    # with no kb_path, bootstrap a KB from the training split's QA pairs
    # (question + answers as one fact document per sample)
    build_from_train: bool = True
    cache_size: int = 100_000


class KnowledgeProvider:
    """Retrieve-and-encode stage feeding `knowledge_embeddings` into
    batches. Encoder defaults to the deterministic hashing encoder so the
    provider works offline; pass a trained TextKnowledgeEncoder for
    semantic retrieval quality."""

    def __init__(self, config: KnowledgeProviderConfig,
                 documents: Optional[Sequence[Document]] = None,
                 encoder=None):
        self.config = config
        self.encoder = encoder or HashingTextEncoder(config.encoder_dim)
        self._cache: Dict[str, tuple] = {}

        docs = list(documents) if documents is not None else []
        if not docs and config.kb_path:
            from vivqa_tpu_torch.knowledge.utils import \
                import_documents_json
            docs = import_documents_json(config.kb_path)
        if not docs:
            raise ValueError("KnowledgeProvider needs documents "
                             "(kb_path or explicit list)")
        self.documents = docs
        self.retriever = self._build_retriever(config)
        self.retriever.index(docs)
        self.rag = RAGModule(self.retriever, self.encoder,
                             num_retrieved=config.num_retrieved)

    def _build_retriever(self, cfg: KnowledgeProviderConfig):
        if cfg.retriever == "sparse":
            return SparseRetriever()
        store = create_vector_store(cfg.vector_store, dim=self.dim)
        dense = DenseRetriever(self.encoder, store)
        if cfg.retriever == "dense":
            return dense
        if cfg.retriever == "hybrid":
            return HybridRetriever(dense, SparseRetriever())
        raise ValueError(f"unknown retriever '{cfg.retriever}' "
                         "(choices: dense, sparse, hybrid)")

    @classmethod
    def from_samples(cls, config: KnowledgeProviderConfig, samples,
                     encoder=None) -> "KnowledgeProvider":
        """Bootstrap a KB from OneSample records: each QA pair becomes a
        fact document ('<question> : <answers>')."""
        docs = []
        for s in samples:
            answers = ", ".join(dict.fromkeys(s.answers))
            docs.append(Document(content=f"{s.question} : {answers}",
                                 source="train", category="qa"))
        return cls(config, documents=docs, encoder=encoder)

    @property
    def dim(self) -> int:
        return getattr(self.encoder, "dim", self.config.encoder_dim)

    # -- batch augmentation -------------------------------------------------
    def contexts_for(self, questions: Sequence[str]):
        """-> (embeddings (B, K, D) f32, mask (B, K) i32); per-question
        results memoized so repeat epochs cost zero retrievals."""
        fresh: dict = {}
        missing = [q for q in questions
                   if q not in self._cache and q not in fresh]
        if missing:
            uniq = list(dict.fromkeys(missing))
            emb, mask, _ = self.rag.retrieve_batch(uniq)
            for i, q in enumerate(uniq):
                # always keep this batch's results in `fresh` so a full
                # memo cache never forces a second retrieval of the same
                # question within the batch
                fresh[q] = (emb[i], mask[i])
                if len(self._cache) < self.config.cache_size:
                    self._cache[q] = fresh[q]
        K, D = self.config.num_retrieved, self.dim
        out_e = np.zeros((len(questions), K, D), np.float32)
        out_m = np.zeros((len(questions), K), np.int32)
        for i, q in enumerate(questions):
            hit = self._cache.get(q) or fresh.get(q)
            out_e[i], out_m[i] = hit
        return out_e, out_m

    def augment(self, batch: dict) -> dict:
        emb, mask = self.contexts_for(list(batch["question"]))
        return {**batch, "knowledge_embeddings": emb,
                "knowledge_mask": mask}

    def wrap(self, loader) -> "KnowledgeLoader":
        return KnowledgeLoader(loader, self)


class KnowledgeLoader:
    """BatchLoader wrapper yielding knowledge-augmented batches."""

    def __init__(self, loader, provider: KnowledgeProvider):
        self.loader = loader
        self.provider = provider

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[dict]:
        for batch in self.loader:
            yield self.provider.augment(batch)
