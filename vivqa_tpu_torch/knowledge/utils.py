"""Knowledge-base utilities (a copy of vivqa_tpu/knowledge/utils.py, which
the port does not import).

Counterpart of src/modeling/knowledge_base/kb_utils.py:36-609 in the
reference: chunking, batch encoding, KB save/load, JSON import/export,
embedding statistics, similarity matrix, dedup (exact + near-duplicate),
MMR diverse retrieval, prompt formatting, end-to-end index construction,
retrieval-quality evaluation (recall@k / MRR).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vivqa_tpu_torch.knowledge.document_store import (Document,
                                                      DocumentStore)
from vivqa_tpu_torch.knowledge.vector_store import (BaseVectorStore,
                                                    InMemoryVectorStore,
                                                    normalize_rows)
from vivqa_tpu_torch.knowledge.vietnamese import chunk_text


def chunk_documents(docs: Sequence[Document], chunk_size: int = 200,
                    overlap: int = 50) -> List[Document]:
    """Split long documents into chunk Documents (reference :36)."""
    out = []
    for d in docs:
        chunks = chunk_text(d.content, chunk_size, overlap)
        if len(chunks) <= 1:
            out.append(d)
            continue
        for i, c in enumerate(chunks):
            out.append(Document(content=c, source=d.source,
                                doc_type=d.doc_type, category=d.category,
                                metadata={**d.metadata, "parent": d.doc_id,
                                          "chunk": i}))
    return out


def batch_encode(encoder, texts: Sequence[str],
                 batch_size: int = 64) -> np.ndarray:
    """Chunked encoding (reference :97)."""
    outs = [encoder.encode(list(texts[i:i + batch_size]))
            for i in range(0, len(texts), batch_size)]
    return np.concatenate(outs, 0) if outs else np.zeros((0, 0), np.float32)


def save_knowledge_base(path: str | Path, docs: DocumentStore,
                        vectors: BaseVectorStore) -> None:
    """(reference :136)"""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    docs.save(path / "documents.json")
    vectors.save(path / "vectors")


def load_knowledge_base(path: str | Path
                        ) -> Tuple[DocumentStore, InMemoryVectorStore]:
    """(reference :166)"""
    path = Path(path)
    docs = DocumentStore.load(path / "documents.json")
    vectors = InMemoryVectorStore.load(path / "vectors")
    return docs, vectors


def import_documents_json(path: str | Path) -> List[Document]:
    """JSON list of {content, source?, category?, ...} (reference :190)."""
    data = json.loads(Path(path).read_text())
    return [Document(**{k: v for k, v in rec.items()
                        if k in ("content", "doc_id", "source", "doc_type",
                                 "category", "metadata")})
            for rec in data]


def export_documents_json(docs: Sequence[Document], path: str | Path) -> None:
    import dataclasses
    Path(path).write_text(json.dumps(
        [dataclasses.asdict(d) for d in docs], ensure_ascii=False, indent=2))


def embedding_statistics(embeddings: np.ndarray) -> Dict[str, float]:
    """(reference :253)"""
    e = np.asarray(embeddings, np.float32)
    norms = np.linalg.norm(e, axis=-1)
    return {"count": int(e.shape[0]), "dim": int(e.shape[-1]) if e.ndim > 1 else 0,
            "mean_norm": float(norms.mean()) if e.size else 0.0,
            "std_norm": float(norms.std()) if e.size else 0.0}


def similarity_matrix(a: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """Cosine similarity matrix (reference :277)."""
    a = normalize_rows(np.asarray(a, np.float32))
    b = a if b is None else normalize_rows(np.asarray(b, np.float32))
    return a @ b.T


def deduplicate_documents(docs: Sequence[Document]) -> List[Document]:
    """Exact dedup by content hash (reference :298)."""
    seen, out = set(), []
    for d in docs:
        if d.doc_id not in seen:
            seen.add(d.doc_id)
            out.append(d)
    return out


def deduplicate_by_similarity(docs: Sequence[Document],
                              embeddings: np.ndarray,
                              threshold: float = 0.95) -> List[Document]:
    """Near-duplicate removal (reference :327): greedy keep-first over a
    cosine-sim matrix."""
    if not len(docs):
        return []
    sims = similarity_matrix(embeddings)
    keep = []
    removed = np.zeros(len(docs), bool)
    for i in range(len(docs)):
        if removed[i]:
            continue
        keep.append(docs[i])
        removed |= sims[i] >= threshold
        removed[i] = True
    return keep


def cluster_documents(embeddings: np.ndarray, n_clusters: int = 10,
                      method: str = "kmeans", seed: int = 42,
                      max_iter: int = 100
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster documents by embedding similarity (reference kb_utils.py:
    360-400). Returns (labels, centers).

    The reference delegates to sklearn KMeans / AgglomerativeClustering;
    this is a dependency-free numpy implementation: k-means with
    k-means++ seeding, and bottom-up agglomerative merging with centroid
    linkage for ``method='hierarchical'``.
    """
    e = np.asarray(embeddings, np.float64)
    if e.ndim != 2 or not len(e):
        raise ValueError("embeddings must be a non-empty (N, D) array")
    n = len(e)
    k = min(n_clusters, n)
    rng = np.random.RandomState(seed)

    if method == "kmeans":
        # k-means++ seeding
        centers = [e[rng.randint(n)]]
        for _ in range(1, k):
            d2 = np.min([((e - c) ** 2).sum(-1) for c in centers], axis=0)
            total = d2.sum()
            if total <= 0:                      # all points identical
                centers.append(e[rng.randint(n)])
                continue
            centers.append(e[rng.choice(n, p=d2 / total)])
        centers = np.stack(centers)
        labels = np.zeros(n, np.int64)
        for _ in range(max_iter):
            d = ((e[:, None, :] - centers[None]) ** 2).sum(-1)
            new_labels = d.argmin(-1)
            if (new_labels == labels).all() and _ > 0:
                break
            labels = new_labels
            for i in range(k):
                m = labels == i
                if m.any():
                    centers[i] = e[m].mean(0)
    elif method == "hierarchical":
        # centroid-linkage agglomerative: start singleton, merge the
        # closest centroid pair until k clusters remain
        labels = np.arange(n, dtype=np.int64)
        clusters = {i: [i] for i in range(n)}
        cents = {i: e[i].copy() for i in range(n)}
        while len(clusters) > k:
            ids = list(clusters)
            C = np.stack([cents[i] for i in ids])
            d = ((C[:, None, :] - C[None]) ** 2).sum(-1)
            np.fill_diagonal(d, np.inf)
            a, b = np.unravel_index(d.argmin(), d.shape)
            ia, ib = ids[a], ids[b]
            clusters[ia] += clusters.pop(ib)
            del cents[ib]
            cents[ia] = e[clusters[ia]].mean(0)
        remap = {cid: i for i, cid in enumerate(sorted(clusters))}
        for cid, members in clusters.items():
            labels[members] = remap[cid]
        centers = np.zeros((k, e.shape[1]))
        for cid, members in clusters.items():
            centers[remap[cid]] = e[members].mean(0)
    else:
        raise ValueError(f"Unknown clustering method: {method}")
    return labels.astype(np.int64), centers.astype(np.float32)


def retrieve_diverse(query_emb: np.ndarray, candidate_embs: np.ndarray,
                     top_k: int = 5, lambda_mult: float = 0.5) -> List[int]:
    """MMR selection (reference :402): balance relevance vs novelty."""
    q = normalize_rows(np.atleast_2d(query_emb))[0]
    c = normalize_rows(np.asarray(candidate_embs, np.float32))
    rel = c @ q
    selected: List[int] = []
    remaining = list(range(len(c)))
    while remaining and len(selected) < top_k:
        if not selected:
            best = int(np.argmax(rel[remaining]))
            selected.append(remaining.pop(best))
            continue
        sel_embs = c[selected]
        mmr_scores = []
        for j in remaining:
            redundancy = float((c[j] @ sel_embs.T).max())
            mmr_scores.append(lambda_mult * rel[j]
                              - (1 - lambda_mult) * redundancy)
        best = int(np.argmax(mmr_scores))
        selected.append(remaining.pop(best))
    return selected


def format_knowledge_prompt(question: str, docs: Sequence[Document],
                            max_docs: int = 5) -> str:
    """Context-stuffing prompt (reference :464)."""
    lines = ["Kiến thức liên quan:"]
    for i, d in enumerate(docs[:max_docs], 1):
        lines.append(f"[{i}] {d.content}")
    lines += ["", f"Câu hỏi: {question}", "Trả lời:"]
    return "\n".join(lines)


def create_knowledge_base_index(documents: Sequence[Document], encoder,
                                chunk_size: int = 200,
                                store: Optional[BaseVectorStore] = None
                                ) -> Tuple[DocumentStore, BaseVectorStore]:
    """End-to-end: chunk -> dedup -> encode -> index (reference :504)."""
    docs = deduplicate_documents(chunk_documents(documents, chunk_size))
    doc_store = DocumentStore()
    doc_store.add_many(docs)
    emb = batch_encode(encoder, [d.content for d in docs])
    vec_store = store or InMemoryVectorStore(dim=emb.shape[-1]
                                             if emb.size else None)
    if len(docs):
        vec_store.add([d.doc_id for d in docs], emb)
    return doc_store, vec_store


def evaluate_retrieval(retriever, queries: Sequence[str],
                       relevant_ids: Sequence[set], k: int = 5) -> Dict[str, float]:
    """recall@k + MRR (reference :567)."""
    recalls, rrs = [], []
    for q, rel in zip(queries, relevant_ids):
        results = retriever.retrieve(q, k)
        got = [r.doc_id for r in results]
        hit = len(set(got) & set(rel))
        recalls.append(hit / max(len(rel), 1))
        rr = 0.0
        for rank, doc_id in enumerate(got, 1):
            if doc_id in rel:
                rr = 1.0 / rank
                break
        rrs.append(rr)
    return {f"recall@{k}": float(np.mean(recalls)) if recalls else 0.0,
            "mrr": float(np.mean(rrs)) if rrs else 0.0}
