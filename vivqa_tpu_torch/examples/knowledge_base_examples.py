"""Knowledge base / RAG tutorial on the port (counterpart of
examples/knowledge_base_examples.py).

The retrieval-augmented side of the framework: document stores, vector
stores, five retriever strategies, Vietnamese NLP utilities, the
batched RAG fusion module, the KnowledgeProvider pipeline stage that
wires retrieval into real training runs, and KB maintenance utilities.

Reference surface: src/modeling/knowledge_base/ (document_store.py,
vector_store.py, retriever.py, vietnamese_processor.py, rag_module.py,
kb_utils.py). Design delta vs the reference, kept from the JAX package:
RAG fusion here is a BATCHED context-attention module fed fixed-K
padded tensors in the train step, replacing the reference's per-sample
Python loop inside forward (vqa_model.py:689-702). The host modules are
the JAX package's, byte for byte; Chroma and FAISS stay optional.

Sections
  1. Documents and the document store (secondary indices, persistence)
  2. Vector stores: in-memory / FAISS / Chroma and the factory
  3. Retrievers: dense, BM25, hybrid (RRF + linear), reranker
  4. Vietnamese NLP utilities
  5. Batched RAG: fixed-K tensors for the train step
  6. KnowledgeProvider: RAG inside a real training pipeline
  7. KB maintenance: chunking, dedup, MMR diversity, quality eval
  8. Persistence round-trips

Run (host-side except section 5, which attends on the card, or on the
CPU with --device cpu):
    python3 -m vivqa_tpu_torch.examples.knowledge_base_examples [--device cpu]
"""

import pathlib
import tempfile

import numpy as np
import torch

from vivqa_tpu_torch.examples import banner, parse_args
from vivqa_tpu_torch.knowledge import (
    VIETNAMESE_STOPWORDS, ChromaVectorStore, ContextAttention, DenseRetriever,
    Document, DocumentStore, HashingTextEncoder, HybridRetriever,
    InMemoryVectorStore, KnowledgeProvider, KnowledgeProviderConfig,
    RAGModule, RerankerRetriever, SparseRetriever, chunk_documents,
    create_vector_store, deduplicate_documents, detect_vietnamese,
    evaluate_retrieval, export_documents_json, extract_keywords,
    format_knowledge_prompt, import_documents_json,
    normalize_vietnamese_text, retrieve_diverse, similarity_matrix)
from vivqa_tpu_torch.models.layers import init_weights

CONTENTS = (
    "con mèo là động vật nuôi thích ngủ và bắt chuột",
    "con chó trung thành và thích chạy trong công viên",
    "quả táo màu đỏ chứa nhiều vitamin tốt cho sức khỏe",
    "xe máy là phương tiện giao thông phổ biến ở việt nam",
    "hà nội là thủ đô của việt nam với hồ gươm nổi tiếng",
    "phở là món ăn truyền thống nổi tiếng của việt nam",
    "vịnh hạ long là di sản thiên nhiên thế giới",
)


def section_documents():
    banner("1. Documents and the document store")
    print("""Document IDs are content hashes (reference document_store.py:16-90)
— identical content dedups itself. The store keeps secondary indices
by source / type / category for filtered retrieval:
""")
    store = DocumentStore()
    for i, c in enumerate(CONTENTS):
        store.add(Document(content=c, source="demo",
                           metadata={"category": "animals" if i < 2 else "other"}))
    d = Document(content=CONTENTS[0], source="demo")   # duplicate content
    print(f"  doc_id is a content hash: {d.doc_id[:16]}...")
    print(f"  store size after adding a duplicate: {len(store)} (not {len(CONTENTS) + 1})")
    by_src = store.by_source("demo")
    print(f"  by_source('demo') -> {len(by_src)} docs")
    return store


def section_vector_stores():
    banner("2. Vector stores")
    print("""Three backends behind one BaseVectorStore API (add / search /
remove / save), reference vector_store.py:

  InMemoryVectorStore  brute-force cosine on a numpy matrix — always
                       available, exact, fine to ~100k docs
  FAISSVectorStore     faiss flat/IVF/HNSW indices (import-gated)
  ChromaVectorStore    chromadb client (import-gated; absent from this
                       image, so the class raises a clear ImportError)

create_vector_store("auto") picks the best available backend:
""")
    rng = np.random.RandomState(0)
    vecs = rng.rand(len(CONTENTS), 32).astype(np.float32)
    for backend in ("auto", "memory"):
        store = create_vector_store(backend, dim=32)
        store.add([f"d{i}" for i in range(len(CONTENTS))], vecs)
        ids, scores = store.search(vecs[:1], top_k=3)
        print(f"  {backend:>6} -> {type(store).__name__}: "
              f"top-3 for doc0's own vector = {ids[0]}")
    try:
        ChromaVectorStore(dim=32)
    except ImportError as e:
        print(f"  chroma -> ImportError (gated): {str(e)[:56]}...")


def build_retrievers(store):
    enc = HashingTextEncoder(dim=128)
    dense = DenseRetriever(enc, InMemoryVectorStore(), DocumentStore())
    sparse = SparseRetriever()
    hybrid = HybridRetriever(dense, sparse, fusion="rrf")
    docs = store.all()
    hybrid.index(docs)
    return enc, dense, sparse, hybrid, docs


def section_retrievers(store):
    banner("3. Retrievers")
    print("""Five strategies behind one retrieve(query, top_k) API
(reference retriever.py:155-876):

  dense    encoder + vector store (semantic similarity)
  sparse   own BM25 (k1/b parameters, Vietnamese-tokenized)
  hybrid   reciprocal-rank fusion or weighted linear fusion of both
  reranker cross-scoring of a candidate pool from a base retriever
  multimodal  image+text queries through a multimodal encoder

The demo encoder is the deterministic feature-hashing one (offline,
no weights); swap in TextKnowledgeEncoder(PhoBERT) for semantic
quality in a real deployment:
""")
    enc, dense, sparse, hybrid, docs = build_retrievers(store)
    queries = ("thủ đô việt nam ở đâu?", "con gì thích bắt chuột?",
               "món ăn nổi tiếng việt nam?")
    for q in queries:
        print(f"  Q: {q}")
        for name, r in (("bm25", sparse), ("hybrid", hybrid)):
            res = r.retrieve(q, top_k=1)[0]
            print(f"    {name:>6}: [{res.score:.3f}] {res.document.content[:46]}")
    rr = RerankerRetriever(hybrid, candidates=5)   # default token-F1 reranker
    res = rr.retrieve(queries[0], top_k=2)
    print(f"  reranker on '{queries[0]}':")
    for r in res:
        print(f"    [{r.score:.3f}] {r.document.content[:46]}")
    return enc, hybrid, docs


def section_vietnamese():
    banner("4. Vietnamese NLP utilities")
    print("""underthesea/pyvi word segmentation when installed, whitespace
fallback otherwise (reference vietnamese_processor.py:107-202):
""")
    s = "  Hà   NỘI là Thủ Đô của Việt Nam  "
    print(f"  normalize: '{s}' -> '{normalize_vietnamese_text(s)}'")
    print(f"  keywords('{CONTENTS[0][:30]}...') -> "
          f"{extract_keywords(CONTENTS[0])}")
    print(f"  detect_vietnamese('xin chào các bạn') = "
          f"{detect_vietnamese('xin chào các bạn')}   "
          f"detect('hello world') = {detect_vietnamese('hello world')}")
    print(f"  stopword table: {len(VIETNAMESE_STOPWORDS)} entries "
          f"(e.g. {sorted(VIETNAMESE_STOPWORDS)[:6]})")


def section_rag(enc, hybrid, docs, device):
    banner("5. Batched RAG — fixed-K tensors for the jitted step")
    print("""The reference retrieves per-sample inside model.forward (a Python
loop, device-synchronous). Here retrieval happens on HOST at batch
time; the model receives a FIXED-K padded tensor + mask, and fuses
it with one batched context-attention layer + 0.5-weighted residual
(matching reference semantics at vqa_model.py:689-702). The JAX
package jits that step; the port runs it eagerly, the attention through
its CUDA kernel on the card:
""")
    rag = RAGModule(hybrid, enc, num_retrieved=3)
    emb, mask, results = rag.retrieve_batch(
        ["con mèo thích gì?", "thủ đô việt nam?"])
    print(f"  knowledge_embeddings: {emb.shape}  (B, K, D) — static shape")
    print(f"  knowledge_mask:       {mask.shape}  {mask.tolist()}")
    print(f"  top doc for q0: {results[0][0].document.content[:46]}")
    attn = ContextAttention(query_dim=emb.shape[-1], context_dim=emb.shape[-1],
                            hidden_dim=32, num_heads=1)
    init_weights(attn, torch.Generator().manual_seed(0))
    attn = attn.to(device).eval()
    ctx = torch.from_numpy(np.asarray(emb, np.float32)).to(device)
    with torch.no_grad():
        fused = attn(ctx.mean(dim=1), ctx,
                     torch.from_numpy(np.asarray(mask)).to(device))
    print(f"  one query attending over its K contexts on {device}: "
          f"{tuple(fused.shape)}")
    print("\n  The tensors ride the normal batch dict; no retrieval code\n"
          "  runs in the step. See VietnameseVQAModel(knowledge_embeddings=...).")
    print("\n  prompt formatting for generative RAG:")
    print("  " + format_knowledge_prompt("con mèo thích gì?",
                                         docs[:2]).replace("\n", "\n  "))


def section_provider(docs):
    banner("6. KnowledgeProvider — RAG in a real training pipeline")
    print("""The piece round 1 lacked: a pipeline stage that owns the
retriever+encoder and decorates every batch with
knowledge_embeddings/mask, so `use_knowledge=True` trains for real
(vivqa_tpu_torch/knowledge/provider.py; exercised end-to-end in
tests/test_torch_rag_pipelines.py with a RAG-on training run):
""")
    cfg = KnowledgeProviderConfig(num_retrieved=2, encoder_dim=64,
                                  retriever="hybrid")
    provider = KnowledgeProvider(cfg, documents=docs)
    batch = {"question": ["con mèo thích gì?", "thủ đô ở đâu?"]}
    batch = provider.augment(batch)
    print(f"  batch keys after provider: {sorted(batch.keys())}")
    print(f"  knowledge_embeddings {batch['knowledge_embeddings'].shape}, "
          f"mask {batch['knowledge_mask'].shape}")
    print("\n  YAML wiring:  knowledge: {use_knowledge: true, kb_path: kb.json}")


def section_maintenance(enc, hybrid, docs):
    banner("7. KB maintenance utilities")
    print("(reference kb_utils.py — chunk, dedup, MMR, quality eval)\n")
    long_doc = Document(content=" ".join(CONTENTS))
    chunks = chunk_documents([long_doc], chunk_size=12, overlap=4)
    print(f"  chunk_documents(1 long doc, size=12, overlap=4) -> {len(chunks)} chunks")
    dup_docs = [Document(content=c) for c in CONTENTS] + [
        Document(content=CONTENTS[0])]       # exact duplicate -> same hash id
    uniq = deduplicate_documents(dup_docs)
    print(f"  deduplicate_documents({len(dup_docs)}) -> {len(uniq)} unique "
          "(near-duplicates: use deduplicate_by_similarity)")
    vecs = enc.encode([d.content for d in docs])
    sims = similarity_matrix(vecs)
    print(f"  similarity_matrix: {sims.shape}, diag==1: "
          f"{bool(np.allclose(np.diag(sims), 1.0, atol=1e-5))}")
    q_emb = enc.encode(["việt nam nổi tiếng"])[0]
    picks = retrieve_diverse(q_emb, vecs, top_k=3, lambda_mult=0.5)
    print("  MMR-diverse selection for 'việt nam nổi tiếng':")
    for i in picks:
        print(f"    [{i}] {docs[i].content[:46]}")
    gold = [{docs[0].doc_id}]
    quality = evaluate_retrieval(hybrid, ["con mèo thích gì?"], gold, k=3)
    print(f"  retrieval quality (recall@3 / MRR): {quality}")


def section_persistence(docs):
    banner("8. Persistence round-trips")
    with tempfile.TemporaryDirectory() as td:
        path = pathlib.Path(td) / "kb.json"
        export_documents_json(docs, path)
        back = import_documents_json(path)
        print(f"  export -> {path.name} ({path.stat().st_size} bytes), "
              f"import -> {len(back)} docs, ids preserved: "
              f"{back[0].doc_id == docs[0].doc_id}")
    print("  Vector stores save alongside (FAISS index file + ids JSON);\n"
          "  the document store persists itself the same way.")


def main(argv=None):
    device = parse_args(__doc__, argv).device
    store = section_documents()
    section_vector_stores()
    enc, hybrid, docs = section_retrievers(store)
    section_vietnamese()
    section_rag(enc, hybrid, docs, device)
    section_provider(docs)
    section_maintenance(enc, hybrid, docs)
    section_persistence(docs)
    banner("Done")
    print("End-to-end RAG training: set use_knowledge=true + kb_path in the\n"
          "pipeline YAML; the KnowledgeProvider stage does the rest.")


if __name__ == "__main__":
    main()
