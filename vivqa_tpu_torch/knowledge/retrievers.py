"""Retrievers: dense / sparse BM25 / hybrid / multimodal / reranker (a
copy of vivqa_tpu/knowledge/retrievers.py, which the port does not
import).

Counterpart of src/modeling/knowledge_base/retriever.py:25-876 in the
reference, including its own BM25 implementation (:301-470), reciprocal-
rank and linear fusion for the hybrid retriever (:505,:536), and a
cross-scoring reranker.
"""

from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence

from vivqa_tpu_torch.knowledge.document_store import (Document,
                                                      DocumentStore)
from vivqa_tpu_torch.knowledge.vector_store import BaseVectorStore
from vivqa_tpu_torch.knowledge.vietnamese import (VietnameseTokenizer,
                                                  remove_stopwords)


@dataclasses.dataclass
class RetrievalResult:
    doc_id: str
    score: float
    document: Optional[Document] = None
    rank: int = 0


class BaseRetriever:
    def retrieve(self, query: str, top_k: int = 5) -> List[RetrievalResult]:
        raise NotImplementedError

    def retrieve_batch(self, queries: Sequence[str], top_k: int = 5
                       ) -> List[List[RetrievalResult]]:
        return [self.retrieve(q, top_k) for q in queries]


class DenseRetriever(BaseRetriever):
    """Encoder + vector store (reference :155-255)."""

    def __init__(self, encoder, vector_store: BaseVectorStore,
                 document_store: Optional[DocumentStore] = None):
        self.encoder = encoder
        self.vectors = vector_store
        self.docs = document_store

    def index(self, documents: Sequence[Document]) -> None:
        embeddings = self.encoder.encode([d.content for d in documents])
        self.vectors.add([d.doc_id for d in documents], embeddings)
        if self.docs is not None:
            self.docs.add_many(list(documents))

    def retrieve(self, query: str, top_k: int = 5) -> List[RetrievalResult]:
        return self.retrieve_batch([query], top_k)[0]

    def retrieve_batch(self, queries, top_k=5):
        q = self.encoder.encode(list(queries))
        ids, scores = self.vectors.search(q, top_k)
        out = []
        for row_ids, row_scores in zip(ids, scores):
            res = [RetrievalResult(d, float(s),
                                   self.docs.get(d) if self.docs else None,
                                   rank=r)
                   for r, (d, s) in enumerate(zip(row_ids, row_scores))]
            out.append(res)
        return out


class SparseRetriever(BaseRetriever):
    """Own BM25 (k1/b) over Vietnamese tokens (reference :257-470)."""

    def __init__(self, document_store: Optional[DocumentStore] = None,
                 k1: float = 1.5, b: float = 0.75,
                 drop_stopwords: bool = True):
        self.docs = document_store or DocumentStore()
        self.k1, self.b = k1, b
        self.drop_stopwords = drop_stopwords
        self.tok = VietnameseTokenizer()
        self._tf: Dict[str, Counter] = {}
        self._df: Counter = Counter()
        self._len: Dict[str, int] = {}
        self._avg_len = 0.0

    def _tokens(self, text: str) -> List[str]:
        toks = self.tok.tokenize(text)
        return remove_stopwords(toks) if self.drop_stopwords else toks

    def index(self, documents: Sequence[Document]) -> None:
        for d in documents:
            if d.doc_id not in self.docs:
                self.docs.add(d)
            toks = self._tokens(d.content)
            tf = Counter(toks)
            self._tf[d.doc_id] = tf
            self._len[d.doc_id] = len(toks)
            for term in tf:
                self._df[term] += 1
        total = sum(self._len.values())
        self._avg_len = total / max(len(self._len), 1)

    def _bm25(self, query_tokens: List[str], doc_id: str) -> float:
        tf = self._tf.get(doc_id)
        if not tf:
            return 0.0
        N = len(self._tf)
        dl = self._len[doc_id]
        score = 0.0
        for term in query_tokens:
            f = tf.get(term, 0)
            if not f:
                continue
            idf = math.log(1 + (N - self._df[term] + 0.5) /
                           (self._df[term] + 0.5))
            denom = f + self.k1 * (1 - self.b + self.b * dl / self._avg_len)
            score += idf * f * (self.k1 + 1) / denom
        return score

    def retrieve(self, query: str, top_k: int = 5) -> List[RetrievalResult]:
        q = self._tokens(query)
        # only score docs containing at least one query term
        candidates = set()
        for term in q:
            for doc_id, tf in self._tf.items():
                if term in tf:
                    candidates.add(doc_id)
        scored = sorted(((self._bm25(q, d), d) for d in candidates),
                        reverse=True)[:top_k]
        return [RetrievalResult(d, s, self.docs.get(d), rank=r)
                for r, (s, d) in enumerate(scored)]


class HybridRetriever(BaseRetriever):
    """Dense + sparse with RRF or linear fusion (reference :472-644)."""

    def __init__(self, dense: DenseRetriever, sparse: SparseRetriever,
                 fusion: str = "rrf", alpha: float = 0.5, rrf_k: int = 60):
        if fusion not in ("rrf", "linear"):
            raise ValueError(f"unknown fusion '{fusion}' "
                             "(choices: rrf, linear)")
        self.dense = dense
        self.sparse = sparse
        self.fusion = fusion
        self.alpha = alpha
        self.rrf_k = rrf_k

    def index(self, documents: Sequence[Document]) -> None:
        self.dense.index(documents)
        self.sparse.index(documents)

    def retrieve(self, query: str, top_k: int = 5) -> List[RetrievalResult]:
        d_res = self.dense.retrieve(query, 2 * top_k)
        s_res = self.sparse.retrieve(query, 2 * top_k)
        scores: Dict[str, float] = defaultdict(float)
        docs: Dict[str, Optional[Document]] = {}
        if self.fusion == "rrf":
            for res in (d_res, s_res):
                for r in res:
                    scores[r.doc_id] += 1.0 / (self.rrf_k + r.rank + 1)
                    docs[r.doc_id] = r.document or docs.get(r.doc_id)
        else:
            def norm(res):
                if not res:
                    return {}
                vals = [r.score for r in res]
                lo, hi = min(vals), max(vals)
                rng = (hi - lo) or 1.0
                return {r.doc_id: (r.score - lo) / rng for r in res}
            dn, sn = norm(d_res), norm(s_res)
            for r in d_res + s_res:
                docs[r.doc_id] = r.document or docs.get(r.doc_id)
            for doc_id in set(dn) | set(sn):
                scores[doc_id] = (self.alpha * dn.get(doc_id, 0.0)
                                  + (1 - self.alpha) * sn.get(doc_id, 0.0))
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[:top_k]
        return [RetrievalResult(d, s, docs.get(d), rank=r)
                for r, (d, s) in enumerate(ranked)]


class MultimodalRetriever(BaseRetriever):
    """Query = text (+ optional image); uses a multimodal encoder
    (reference :646-741)."""

    def __init__(self, encoder, vector_store: BaseVectorStore,
                 document_store: Optional[DocumentStore] = None):
        self.encoder = encoder
        self.vectors = vector_store
        self.docs = document_store

    def index(self, documents: Sequence[Document],
              images: Optional[Sequence] = None) -> None:
        emb = self.encoder.encode([d.content for d in documents], images)
        self.vectors.add([d.doc_id for d in documents], emb)
        if self.docs is not None:
            self.docs.add_many(list(documents))

    def retrieve(self, query: str, top_k: int = 5, image=None):
        q = self.encoder.encode([query], [image] if image is not None else None)
        ids, scores = self.vectors.search(q, top_k)
        return [RetrievalResult(d, float(s),
                                self.docs.get(d) if self.docs else None,
                                rank=r)
                for r, (d, s) in enumerate(zip(ids[0], scores[0]))]


class RerankerRetriever(BaseRetriever):
    """Two-stage: base retriever then rescoring of candidates
    (reference :743-834). The reranker scores (query, doc) pairs with a
    provided callable; default = token-overlap F1 (cross-encoder-free)."""

    def __init__(self, base: BaseRetriever, rerank_fn=None,
                 candidates: int = 20):
        self.base = base
        self.candidates = candidates
        self.rerank_fn = rerank_fn or self._overlap_score

    @staticmethod
    def _overlap_score(query: str, content: str) -> float:
        tok = VietnameseTokenizer()
        q = Counter(tok.tokenize(query))
        d = Counter(tok.tokenize(content))
        common = sum((q & d).values())
        if not common:
            return 0.0
        p = common / max(sum(q.values()), 1)
        r = common / max(sum(d.values()), 1)
        return 2 * p * r / (p + r)

    def retrieve(self, query: str, top_k: int = 5) -> List[RetrievalResult]:
        cands = self.base.retrieve(query, self.candidates)
        rescored = []
        for c in cands:
            content = c.document.content if c.document else ""
            rescored.append((self.rerank_fn(query, content), c))
        rescored.sort(key=lambda x: -x[0])
        out = []
        for r, (s, c) in enumerate(rescored[:top_k]):
            out.append(RetrievalResult(c.doc_id, float(s), c.document, r))
        return out


def create_retriever(kind: str, **kwargs) -> BaseRetriever:
    """Factory (reference :836-876)."""
    kinds = {"dense": DenseRetriever, "sparse": SparseRetriever,
             "hybrid": HybridRetriever, "multimodal": MultimodalRetriever,
             "reranker": RerankerRetriever}
    if kind not in kinds:
        raise ValueError(f"unknown retriever '{kind}' (choices: {tuple(kinds)})")
    return kinds[kind](**kwargs)
