"""Vector stores: in-memory brute force, FAISS and Chroma behind import
gates (a copy of vivqa_tpu/knowledge/vector_store.py, which the port does
not import).

Counterpart of src/modeling/knowledge_base/vector_store.py:14-701 in the
reference (InMemory / FAISS / Chroma). The default is a numpy store whose
search is one (Q, D) @ (D, N) product on the host, with the top k by
``argpartition`` then ``argsort`` as in the JAX package. faiss and
chromadb stay optional: their classes raise ImportError without them, and
``create_vector_store("auto")`` falls back to the in-memory store.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


def normalize_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


class BaseVectorStore:
    metric = "cosine"

    def add(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        raise NotImplementedError

    def search(self, queries: np.ndarray, top_k: int = 5
               ) -> Tuple[List[List[str]], np.ndarray]:
        """-> (ids per query, scores (Q, top_k))."""
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def save(self, path: str | Path) -> None:
        raise NotImplementedError


class InMemoryVectorStore(BaseVectorStore):
    """Brute-force cosine (reference :124-277)."""

    def __init__(self, dim: Optional[int] = None, metric: str = "cosine"):
        if metric not in ("cosine", "dot", "l2"):
            raise ValueError(f"unknown metric '{metric}' "
                             "(choices: cosine, dot, l2)")
        self.metric = metric
        self.dim = dim
        self._ids: List[str] = []
        self._vecs: Optional[np.ndarray] = None

    def __len__(self):
        return len(self._ids)

    def add(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        vectors = np.asarray(vectors, np.float32)
        if self.dim is None:
            self.dim = vectors.shape[-1]
        if vectors.shape[-1] != self.dim:
            raise ValueError(f"vectors of dim {vectors.shape[-1]}, the "
                             f"store holds dim {self.dim}")
        self._ids.extend(ids)
        self._vecs = (vectors if self._vecs is None
                      else np.concatenate([self._vecs, vectors], 0))

    def remove(self, ids: Sequence[str]) -> int:
        drop = set(ids)
        keep = [i for i, d in enumerate(self._ids) if d not in drop]
        removed = len(self._ids) - len(keep)
        self._ids = [self._ids[i] for i in keep]
        self._vecs = self._vecs[keep] if self._vecs is not None else None
        return removed

    def search(self, queries: np.ndarray, top_k: int = 5):
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        if self._vecs is None or not len(self._ids):
            return [[] for _ in queries], np.zeros((len(queries), 0))
        k = min(top_k, len(self._ids))
        if self.metric == "cosine":
            sims = normalize_rows(queries) @ normalize_rows(self._vecs).T
        elif self.metric == "dot":
            sims = queries @ self._vecs.T
        else:  # l2 -> negative distance as score
            d2 = ((queries[:, None] - self._vecs[None]) ** 2).sum(-1)
            sims = -d2
        idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        row = np.arange(len(queries))[:, None]
        order = np.argsort(-sims[row, idx], axis=1)
        idx = idx[row, order]
        ids = [[self._ids[j] for j in r] for r in idx]
        return ids, sims[row, idx]

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path.with_suffix(".npz"), vectors=self._vecs)
        path.with_suffix(".json").write_text(json.dumps(
            {"ids": self._ids, "dim": self.dim, "metric": self.metric}))

    @classmethod
    def load(cls, path: str | Path) -> "InMemoryVectorStore":
        path = Path(path)
        meta = json.loads(path.with_suffix(".json").read_text())
        store = cls(dim=meta["dim"], metric=meta["metric"])
        data = np.load(path.with_suffix(".npz"))
        store._ids = meta["ids"]
        store._vecs = data["vectors"] if data["vectors"].ndim else None
        return store


class FAISSVectorStore(BaseVectorStore):
    """FAISS flat/IVF/HNSW (reference :279-518). Requires faiss."""

    def __init__(self, dim: int, index_type: str = "flat",
                 nlist: int = 100, metric: str = "cosine"):
        try:
            import faiss
        except ImportError as e:
            raise ImportError(
                "faiss is not installed; use InMemoryVectorStore "
                "(create_vector_store falls back automatically)") from e
        self.faiss = faiss
        self.dim = dim
        self.metric = metric
        self._ids: List[str] = []
        if index_type == "flat":
            self.index = faiss.IndexFlatIP(dim)
        elif index_type == "ivf":
            quant = faiss.IndexFlatIP(dim)
            self.index = faiss.IndexIVFFlat(quant, dim, nlist,
                                            faiss.METRIC_INNER_PRODUCT)
        elif index_type == "hnsw":
            self.index = faiss.IndexHNSWFlat(dim, 32,
                                             faiss.METRIC_INNER_PRODUCT)
        else:
            raise ValueError(f"unknown index_type '{index_type}'")

    def __len__(self):
        return len(self._ids)

    def train(self, vectors: np.ndarray) -> None:
        v = normalize_rows(np.asarray(vectors, np.float32))
        if not self.index.is_trained:
            self.index.train(v)

    def add(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        v = normalize_rows(np.asarray(vectors, np.float32))
        self.train(v)
        self.index.add(v)
        self._ids.extend(ids)

    def search(self, queries: np.ndarray, top_k: int = 5):
        q = normalize_rows(np.atleast_2d(np.asarray(queries, np.float32)))
        scores, idx = self.index.search(q, min(top_k, len(self._ids)))
        ids = [[self._ids[j] for j in r if j >= 0] for r in idx]
        return ids, scores

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self.faiss.write_index(self.index, str(path.with_suffix(".faiss")))
        path.with_suffix(".json").write_text(json.dumps(
            {"ids": self._ids, "dim": self.dim}))


class ChromaVectorStore(BaseVectorStore):
    """ChromaDB-backed store (reference :520-681). Behind the same
    import gate as FAISS: the class exists for parity wherever chromadb
    is installed; `create_vector_store("auto")` falls back gracefully
    when it is not."""

    def __init__(self, dim: Optional[int] = None,
                 collection_name: str = "vivqa_kb",
                 persist_directory: Optional[str] = None,
                 metric: str = "cosine"):
        try:
            import chromadb
        except ImportError as e:
            raise ImportError(
                "chromadb is not installed; use FAISSVectorStore or "
                "InMemoryVectorStore (create_vector_store falls back "
                "automatically)") from e
        self.dim = dim
        if persist_directory:
            self._client = chromadb.PersistentClient(path=persist_directory)
        else:
            self._client = chromadb.Client()
        space = {"cosine": "cosine", "l2": "l2", "ip": "ip"}[metric]
        self._metric = metric
        self._col = self._client.get_or_create_collection(
            collection_name, metadata={"hnsw:space": space})

    def __len__(self):
        return self._col.count()

    def add(self, ids: Sequence[str], vectors: np.ndarray) -> None:
        v = np.asarray(vectors, np.float32)
        if self.dim is None:
            self.dim = v.shape[-1]
        self._col.add(ids=list(ids), embeddings=v.tolist())

    def remove(self, ids: Sequence[str]) -> int:
        before = len(self)
        self._col.delete(ids=list(ids))
        return before - len(self)

    def search(self, queries: np.ndarray, top_k: int = 5):
        q = np.atleast_2d(np.asarray(queries, np.float32))
        res = self._col.query(query_embeddings=q.tolist(),
                              n_results=min(top_k, max(len(self), 1)))
        ids = res["ids"]
        # chroma returns distances; convert to a similarity per metric:
        # cosine/ip distance d -> 1 - d; l2 (squared) -> 1/(1+d) so the
        # score stays bounded (0, 1] and monotonic (1 - d would go
        # arbitrarily negative and misweight hybrid linear fusion)
        if self._metric == "l2":
            conv = lambda d: 1.0 / (1.0 + d)
        else:
            conv = lambda d: 1.0 - d
        scores = np.asarray([[conv(d) for d in row]
                             for row in res["distances"]], np.float32)
        return ids, scores

    def save(self, path: str | Path) -> None:
        # PersistentClient already writes through; record metadata only
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.with_suffix(".json").write_text(json.dumps(
            {"backend": "chroma", "dim": self.dim}))


def create_vector_store(backend: str = "auto", dim: Optional[int] = None,
                        **kwargs) -> BaseVectorStore:
    """Factory (reference :683). 'auto' prefers FAISS, falls back to
    in-memory when faiss is absent; 'chroma' requires chromadb."""
    if backend == "chroma":
        return ChromaVectorStore(dim=dim, **kwargs)
    if backend in ("auto", "faiss"):
        try:
            return FAISSVectorStore(dim or kwargs.pop("dim", 512), **kwargs)
        except ImportError:
            if backend == "faiss":
                raise
    if backend in ("auto", "memory", "in_memory"):
        return InMemoryVectorStore(dim=dim, **kwargs)
    raise ValueError(f"unknown vector store backend '{backend}'")
