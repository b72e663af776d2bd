"""The port's knowledge package against the JAX package's, on the CPU.

Host modules (text processing, document and vector stores, the hashing
encoder, the retrievers, the RAG module's retrieval, the provider and the
knowledge-base helpers) are copies and must give the JAX package's
results byte for byte on ``tests/test_knowledge.py``'s documents and on
seeded random inputs. ``ContextAttention`` and ``RAGFusion`` are held in
bf16 (``assert_close_bf16``: flax takes their softmax in bf16, the port
in f32) and, with both packages' forced-bf16 modules patched to f32, to
1e-5; ``rag_loss`` to f32 rounding. ``TextKnowledgeEncoder`` and
``VisualKnowledgeEncoder`` run the port's towers on bridged weights
against the JAX encoders on the same weights.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_support import (F32_TOL, assert_close, assert_close_bf16,
                                jax_params, padding_mask, port_with, t)
import vivqa_tpu.knowledge as JK
from vivqa_tpu.knowledge import rag as JRAG
from vivqa_tpu.data.schema import OneSample as JSample
import vivqa_tpu_torch.knowledge as PK
from vivqa_tpu_torch.data.schema import OneSample as PSample
from vivqa_tpu_torch.knowledge import rag as PRAG

torch.set_num_threads(1)

TEXTS = ["con mèo là động vật nuôi phổ biến",
         "con chó trung thành với con người",
         "quả táo chứa nhiều vitamin",
         "xe máy là phương tiện giao thông ở việt nam",
         "Con MÈO đen đang ngủ trên ghế. Nó ngủ rất say!",
         "bao nhiêu người đang đứng trong bức ảnh?",
         "the black cat sleeps", ""]
CATEGORIES = ["animal", "animal", "food", "vehicle"]
QUERIES = ["con mèo ngủ", "vitamin trong quả táo", "con chó trung thành",
           "xe máy ở việt nam", "zzzz", "con mèo động vật nuôi"]


def _docs(mod):
    return [mod.Document(content=c, category=k)
            for c, k in zip(TEXTS[:4], CATEGORIES)]


def _records(results):
    """Retrieval results as plain tuples (doc id, score, rank, content)."""
    return [(r.doc_id, r.score, r.rank,
             r.document.content if r.document else None) for r in results]


# -- Vietnamese text processing ----------------------------------------------

TEXT_FUNCS = ["normalize_vietnamese_text", "ascii_fold", "split_sentences",
              "extract_keywords", "detect_vietnamese", "tokenize",
              "remove_stopwords", "chunk_text", "process"]


@pytest.mark.parametrize("fn", TEXT_FUNCS)
def test_vietnamese_text_functions_match_jax(fn):
    long = " ".join(TEXTS * 20)
    got, want = [], []
    for mod, into in ((PK, got), (JK, want)):
        for text in TEXTS + [long]:
            if fn == "tokenize":
                into.append(mod.VietnameseTokenizer().tokenize(text))
            elif fn == "remove_stopwords":
                into.append(mod.remove_stopwords(text.split()))
            elif fn == "chunk_text":
                into.append(mod.chunk_text(text, 7, 3))
            elif fn == "process":
                into.append(mod.VietnameseTextProcessor().process(text))
            else:
                into.append(getattr(mod, fn)(text))
    assert got == want
    assert PK.VIETNAMESE_STOPWORDS == JK.VIETNAMESE_STOPWORDS


# -- stores ---------------------------------------------------------------------

def test_document_ids_and_store_round_trip_match_jax(tmp_path):
    """Content hashes, the indices and the JSON file are the JAX
    package's; each package loads the other's file."""
    for mod, name in ((PK, "port.json"), (JK, "jax.json")):
        store = mod.DocumentStore()
        store.add_many(_docs(mod) + [
            mod.KnowledgeEntry(content="mèo là động vật", subject="mèo",
                               relation="là", object="động vật"),
            mod.VisualKnowledgeEntry(content="một con mèo", image_path="a",
                                     bbox=(1, 2, 3, 4))])
        store.save(tmp_path / name)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    p = PK.DocumentStore.load(tmp_path / "jax.json")
    j = JK.DocumentStore.load(tmp_path / "port.json")
    assert [dataclasses.asdict(d) for d in p.all()] == \
        [dataclasses.asdict(d) for d in j.all()]
    assert [type(d).__name__ for d in p.all()] == \
        [type(d).__name__ for d in j.all()]
    for key in ("animal", "food"):
        assert sorted(d.doc_id for d in p.by_category(key)) == \
            sorted(d.doc_id for d in j.by_category(key))
    doc_id = _docs(PK)[0].doc_id
    assert p.remove(doc_id) and j.remove(doc_id)
    assert len(p) == len(j) == 5


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_vector_store_topk_matches_jax(metric, tmp_path):
    rs = np.random.RandomState(0)
    vecs = rs.standard_normal((40, 16)).astype(np.float32)
    queries = rs.standard_normal((5, 16)).astype(np.float32)
    ids = [f"d{i}" for i in range(40)]
    out = {}
    for mod in (PK, JK):
        store = mod.InMemoryVectorStore(metric=metric)
        store.add(ids[:25], vecs[:25])
        store.add(ids[25:], vecs[25:])
        store.remove(["d3", "d30"])
        store.save(tmp_path / mod.__name__ / "vec")
        loaded = mod.InMemoryVectorStore.load(tmp_path / mod.__name__ / "vec")
        out[mod] = [store.search(queries, 7), loaded.search(queries[0], 50),
                    len(store)]
    for (pi, ps), (ji, js) in zip(out[PK][:2], out[JK][:2]):
        assert pi == ji
        np.testing.assert_array_equal(ps, js)
    assert out[PK][2] == out[JK][2] == 38


def test_vector_store_factory_and_gates_match_jax():
    for mod in (PK, JK):
        assert isinstance(mod.create_vector_store("auto", dim=8),
                          mod.InMemoryVectorStore)
        assert isinstance(mod.create_vector_store("memory", dim=8),
                          mod.InMemoryVectorStore)
        with pytest.raises(ImportError):
            mod.create_vector_store("faiss", dim=8)
        with pytest.raises(ImportError):
            mod.ChromaVectorStore(dim=8)
        with pytest.raises(ValueError):
            mod.create_vector_store("nope", dim=8)
        empty = mod.InMemoryVectorStore()
        ids, scores = empty.search(np.ones((2, 4), np.float32), 3)
        assert ids == [[], []] and scores.shape == (2, 0)


# -- encoders and retrievers --------------------------------------------------

@pytest.mark.parametrize("dim,ngrams", [(64, 2), (256, 1), (32, 3)])
def test_hashing_encoder_is_byte_equal(dim, ngrams):
    got = PK.HashingTextEncoder(dim, ngrams).encode(TEXTS)
    want = JK.HashingTextEncoder(dim, ngrams).encode(TEXTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _dense(mod, dim=64):
    r = mod.DenseRetriever(mod.HashingTextEncoder(dim),
                           mod.InMemoryVectorStore(), mod.DocumentStore())
    r.index(_docs(mod))
    return r


def _sparse(mod):
    r = mod.SparseRetriever()
    r.index(_docs(mod))
    return r


def _retriever(mod, kind):
    if kind == "dense":
        return _dense(mod)
    if kind == "sparse":
        return _sparse(mod)
    if kind.startswith("hybrid"):
        return mod.HybridRetriever(_dense(mod), _sparse(mod),
                                   fusion=kind.split("_")[1])
    if kind == "reranker":
        return mod.RerankerRetriever(_dense(mod), candidates=4)
    enc = mod.MultimodalKnowledgeEncoder(mod.TextKnowledgeEncoder(dim=64))
    r = mod.MultimodalRetriever(enc, mod.InMemoryVectorStore(),
                                mod.DocumentStore())
    r.index(_docs(mod))
    return r


RETRIEVERS = ["dense", "sparse", "hybrid_rrf", "hybrid_linear", "reranker",
              "multimodal"]


@pytest.mark.parametrize("kind", RETRIEVERS)
def test_retrievers_match_jax(kind):
    p, j = _retriever(PK, kind), _retriever(JK, kind)
    for q in QUERIES:
        for k in (1, 2, 5):
            assert _records(p.retrieve(q, k)) == _records(j.retrieve(q, k))
    assert [_records(r) for r in p.retrieve_batch(QUERIES, 3)] == \
        [_records(r) for r in j.retrieve_batch(QUERIES, 3)]


def test_create_retriever_matches_jax():
    for mod in (PK, JK):
        r = mod.create_retriever("sparse")
        assert isinstance(r, mod.SparseRetriever)
        with pytest.raises(ValueError, match="unknown retriever"):
            mod.create_retriever("nope")
    with pytest.raises(ValueError):
        PK.HybridRetriever(_dense(PK), _sparse(PK), fusion="nope")


# -- RAG retrieval and the provider ---------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "sparse", "hybrid_rrf"])
def test_rag_module_retrieve_batch_matches_jax(kind):
    """Static K with zero padding: a query no document matches gets an
    all-zero mask row."""
    out = {}
    for mod in (PK, JK):
        rag = mod.RAGModule(_retriever(mod, kind), mod.HashingTextEncoder(64),
                            num_retrieved=3)
        out[mod] = rag.retrieve_batch(QUERIES)
    (pe, pm, pr), (je, jm, jr) = out[PK], out[JK]
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(pm, jm)
    assert pm.dtype == jm.dtype == np.int32 and pe.dtype == np.float32
    assert [_records(r) for r in pr] == [_records(r) for r in jr]
    if kind == "sparse":
        assert pm[QUERIES.index("zzzz")].sum() == 0


def _samples(mod):
    return [mod(image_path=f"{i}.jpg", question=q, answers=[a, a, "x"])
            for i, (q, a) in enumerate(
                [("con mèo màu gì", "đen"), ("có bao nhiêu con chó", "hai"),
                 ("quả táo màu gì", "đỏ"), ("ai đang đi xe máy", "người"),
                 ("con mèo ở đâu", "trên ghế")])]


@pytest.mark.parametrize("retriever,cache_size",
                         [("hybrid", 100_000), ("sparse", 2), ("dense", 0)])
def test_provider_batches_match_jax_cold_and_cached(retriever, cache_size):
    """``contexts_for`` and ``augment`` over three batches, the second a
    repeat of the first (answered from the memo cache), with a duplicate
    question inside a batch and a cache smaller than the questions."""
    batches = [["con mèo màu gì", "quả táo màu gì", "con mèo màu gì"],
               ["con mèo màu gì", "quả táo màu gì", "con mèo màu gì"],
               ["ai đang đi xe máy", "zzzz", "có bao nhiêu con chó"]]
    out = {}
    for mod, sample in ((PK, PSample), (JK, JSample)):
        prov = mod.KnowledgeProvider.from_samples(
            mod.KnowledgeProviderConfig(retriever=retriever, num_retrieved=3,
                                        encoder_dim=32,
                                        cache_size=cache_size),
            _samples(sample))
        rows = [prov.contexts_for(b) for b in batches]
        aug = prov.augment({"question": np.array(batches[2]),
                            "labels": np.arange(3)})
        loader = prov.wrap([{"question": b} for b in batches])
        out[mod] = (rows, aug, [b["knowledge_mask"] for b in loader],
                    len(loader), len(prov._cache),
                    [d.content for d in prov.documents], prov.dim)
    p, j = out[PK], out[JK]
    for (pe, pm), (je, jm) in zip(p[0], j[0]):
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(p[0][0][0], p[0][1][0])
    assert sorted(p[1]) == sorted(j[1])
    for key in ("knowledge_embeddings", "knowledge_mask", "labels"):
        np.testing.assert_array_equal(p[1][key], j[1][key])
    for a, b in zip(p[2], j[2]):
        np.testing.assert_array_equal(a, b)
    assert p[3:] == j[3:]


def test_provider_from_kb_path_and_errors_match_jax(tmp_path):
    docs = [{"content": c, "category": k} for c, k in
            zip(TEXTS[:4], CATEGORIES)]
    path = tmp_path / "kb.json"
    path.write_text(json.dumps(docs, ensure_ascii=False))
    out = {}
    for mod in (PK, JK):
        prov = mod.KnowledgeProvider(mod.KnowledgeProviderConfig(
            kb_path=str(path), num_retrieved=2, encoder_dim=16))
        out[mod] = prov.contexts_for(QUERIES)
        with pytest.raises(ValueError, match="needs documents"):
            mod.KnowledgeProvider(mod.KnowledgeProviderConfig())
        with pytest.raises(ValueError, match="unknown retriever"):
            mod.KnowledgeProvider(mod.KnowledgeProviderConfig(
                retriever="nope"), documents=_docs(mod))
    for a, b in zip(out[PK], out[JK]):
        np.testing.assert_array_equal(a, b)
    assert PK.KnowledgeProviderConfig().to_dict() == \
        JK.KnowledgeProviderConfig().to_dict()


# -- knowledge-base helpers -------------------------------------------------------

def test_dedup_mmr_and_diverse_retrieval_match_jax():
    rs = np.random.RandomState(2)
    emb = rs.standard_normal((12, 8)).astype(np.float32)
    emb[5] = emb[2] + 1e-3
    emb[9] = emb[2] * 2
    got, want = [], []
    for mod, into in ((PK, got), (JK, want)):
        docs = [mod.Document(content=f"d{i}") for i in range(12)]
        into.append([d.doc_id for d in
                     mod.deduplicate_by_similarity(docs, emb, 0.95)])
        into.append([d.doc_id for d in mod.deduplicate_documents(
            docs + docs[:3])])
        into.append(mod.deduplicate_by_similarity([], emb))
        for lam in (0.0, 0.5, 1.0):
            into.append(mod.retrieve_diverse(emb[0], emb, top_k=6,
                                             lambda_mult=lam))
    assert got == want


@pytest.mark.parametrize("method", ["kmeans", "hierarchical"])
def test_cluster_documents_matches_jax(method):
    rs = np.random.RandomState(3)
    emb = np.concatenate([rs.randn(9, 5) * 0.3 + c for c in
                          (np.eye(5)[0] * 4, np.eye(5)[1] * 4, np.zeros(5),
                           np.eye(5)[3] * -3)]).astype(np.float32)
    for k, seed in ((4, 42), (3, 7), (40, 0)):
        pl, pc = PK.cluster_documents(emb, k, method=method, seed=seed)
        jl, jc = JK.cluster_documents(emb, k, method=method, seed=seed)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_array_equal(pc, jc)
    with pytest.raises(ValueError):
        PK.cluster_documents(emb, 3, method="dbscan")
    with pytest.raises(ValueError):
        PK.cluster_documents(np.zeros((0, 3)), 3)


def test_evaluate_retrieval_and_prompt_match_jax():
    got, want = [], []
    for mod, into in ((PK, got), (JK, want)):
        docs = _docs(mod)
        rel = [{docs[0].doc_id}, {docs[2].doc_id, docs[1].doc_id}, set(),
               {docs[3].doc_id}, {docs[1].doc_id}, {docs[0].doc_id}]
        for kind in ("dense", "sparse", "hybrid_linear"):
            for k in (1, 3):
                into.append(mod.evaluate_retrieval(_retriever(mod, kind),
                                                   QUERIES, rel, k))
        into.append(mod.evaluate_retrieval(_dense(mod), [], [], 2))
        into.append(mod.format_knowledge_prompt("mèo là gì?", docs))
        into.append(mod.format_knowledge_prompt("xe?", docs, max_docs=2))
    assert got == want


def test_index_chunks_io_and_statistics_match_jax(tmp_path):
    long = PK.Document(content=" ".join(TEXTS * 30), source="s",
                       category="c", metadata={"a": 1})
    got, want = [], []
    for mod, into in ((PK, got), (JK, want)):
        docs = _docs(mod) + [mod.Document(**dataclasses.asdict(long))]
        chunks = mod.chunk_documents(docs, chunk_size=40, overlap=10)
        into.append([dataclasses.asdict(d) for d in chunks])
        enc = mod.HashingTextEncoder(32)
        emb = mod.batch_encode(enc, [d.content for d in chunks], 4)
        into.append(emb.tobytes())
        into.append(mod.batch_encode(enc, []).shape)
        into.append(mod.embedding_statistics(emb))
        into.append(mod.similarity_matrix(emb[:5], emb[3:9]).tobytes())
        d, v = mod.create_knowledge_base_index(docs, enc, chunk_size=40)
        kb = tmp_path / mod.__name__
        mod.save_knowledge_base(kb, d, v)
        d2, v2 = mod.load_knowledge_base(kb)
        into.append(((kb / "documents.json").read_bytes(),
                     (kb / "vectors.json").read_bytes(), len(d2), len(v2)))
        into.append(_records(mod.DenseRetriever(enc, v2, d2).retrieve(
            "quả táo chứa vitamin", 3)))
        mod.export_documents_json(chunks, kb / "export.json")
        into.append((kb / "export.json").read_bytes())
        into.append([dataclasses.asdict(x) for x in
                     mod.import_documents_json(kb / "export.json")])
    assert got == want


# -- RAG modules -----------------------------------------------------------------

B, K, DF, DK, H = 4, 5, 32, 24, 32
# the third sample retrieved two documents, the fourth none
CONTEXT_MASK = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [1, 1, 0, 0, 0],
                         [0, 0, 0, 0, 0]], np.int32)


def _rag_inputs(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, DF)).astype(np.float32),
            rs.standard_normal((B, K, DK)).astype(np.float32), CONTEXT_MASK)


@contextlib.contextmanager
def _rag_f32():
    """Both packages' forced-bf16 RAG modules computing in f32."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JRAG.ContextAttention, "dtype", jnp.float32)
        mp.setattr(JRAG.RAGFusion, "dtype", jnp.float32)
        mp.setattr(PRAG, "_DTYPE", torch.float32)
        yield


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("strategy",
                         ["context", "attention", "add", "concat", "gated"])
def test_rag_modules_match_jax(strategy, precision):
    """``ContextAttention`` alone and ``RAGFusion`` under each strategy,
    with a padded and an all-zero context mask (that sample's context is
    the mean of its values, flax's rule), in f32 (both packages patched)
    and in bf16; with and without a mask."""
    feats, ctx, mask = _rag_inputs()
    patch = _rag_f32() if precision == "f32" else contextlib.nullcontext()
    with patch:
        if strategy == "context":
            jm = JRAG.ContextAttention(hidden_dim=H, num_heads=4)
            port_mod = PRAG.ContextAttention(DF, DK, H, num_heads=4)
        else:
            jm = JRAG.RAGFusion(hidden_dim=H, strategy=strategy, num_heads=4)
            port_mod = PRAG.RAGFusion(DF, DK, H, strategy=strategy,
                                      num_heads=4)
        params = jax_params(jm, feats, ctx, mask)
        port = port_with(port_mod, params)
        for m in (mask, None):
            want = jm.apply({"params": params}, feats, ctx, m)
            got = port(t(feats), t(ctx), None if m is None else t(m))
            assert got.dtype == (torch.float32 if precision == "f32"
                                 else torch.bfloat16)
            if precision == "f32":
                assert_close(got, want, **F32_TOL, msg=strategy)
            else:
                assert_close_bf16(got, want, msg=strategy)


def test_rag_fusion_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown RAG fusion strategy"):
        PRAG.RAGFusion(DF, DK, H, strategy="nope")


def test_rag_loss_matches_jax():
    rs = np.random.RandomState(4)
    scores = rs.standard_normal((6, 5)).astype(np.float32)
    rel = (rs.rand(6, 5) > 0.5).astype(np.float32)
    rel[2] = 0                                    # no relevant context
    for w in (0.5, 0.0, 2.0):
        got = PRAG.rag_loss(torch.tensor(1.25), t(scores), t(rel), w)
        want = JRAG.rag_loss(jnp.float32(1.25), scores, rel, w)
        assert_close(got, want, **F32_TOL)
    got = PRAG.rag_loss(torch.tensor(0.0), t(scores).bfloat16(),
                        t(rel.astype(np.int32)))
    want = JRAG.rag_loss(0.0, jnp.asarray(scores, jnp.bfloat16),
                         rel.astype(np.int32))
    assert_close(got, want, **F32_TOL)


# -- dense knowledge encoders over the port's towers --------------------------

def _towers(dtype):
    from vivqa_tpu.models import config as JC
    from vivqa_tpu.models.encoders import create_text_encoder as j_text
    from vivqa_tpu.models.encoders import create_visual_encoder as j_vis
    from vivqa_tpu_torch.models import config as PC
    from vivqa_tpu_torch.models.encoders import (create_text_encoder,
                                                 create_visual_encoder)
    tkw = dict(vocab_size=60, hidden_dim=32, num_layers=2, num_heads=2,
               max_length=10, dtype=dtype)
    vkw = dict(image_size=32, patch_size=8, hidden_dim=32, num_layers=1,
               num_heads=2, dtype=dtype)
    jt, jv = j_text(JC.TextEncoderConfig(**tkw)), \
        j_vis(JC.VisualEncoderConfig(**vkw))
    ids = np.ones((2, 10), np.int32)
    tp = jax_params(jt, ids, padding_mask([10, 4], 10))
    vp = jax_params(jv, np.zeros((2, 32, 32, 3), np.float32), seed=3)
    return (jt, tp, port_with(create_text_encoder(
                PC.TextEncoderConfig(**tkw)), tp),
            jv, vp, port_with(create_visual_encoder(
                PC.VisualEncoderConfig(**vkw)), vp))


def _tokenizers():
    from vivqa_tpu.data.tokenizer import WhitespaceTokenizer as JTok
    from vivqa_tpu_torch.data.tokenizer import WhitespaceTokenizer as PTok
    p, j = PTok(max_length=10), JTok(max_length=10)
    p.build_vocab(TEXTS)
    j.build_vocab(TEXTS)
    assert p.vocab == j.vocab
    return p, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knowledge_encoders_match_jax(dtype):
    """Text (a 3-row last chunk padded to 5) and visual (images as uint8
    arrays through the eval transform) embeddings, the multimodal fusions
    and a dense retriever over the port's text tower."""
    jt, tp, pt, jv, vp, pv = _towers(dtype)
    ptok, jtok = _tokenizers()
    ptxt = PK.TextKnowledgeEncoder(pt, ptok, batch_size=5)
    jtxt = JK.TextKnowledgeEncoder(jt, tp, jtok, batch_size=5)
    assert ptxt.dim == jtxt.dim == 32
    got, want = ptxt.encode(TEXTS), jtxt.encode(TEXTS)
    assert got.shape == want.shape == (len(TEXTS), 32)
    rs = np.random.RandomState(5)
    images = [rs.randint(0, 256, (40, 48, 3)).astype(np.uint8)
              for _ in range(3)]
    pvis = PK.VisualKnowledgeEncoder(pv, image_size=32, batch_size=2)
    jvis = JK.VisualKnowledgeEncoder(jv, vp, image_size=32, batch_size=2)
    vgot, vwant = pvis.encode(images), jvis.encode(images)
    check = (lambda a, b: assert_close(a, b, **F32_TOL)) \
        if dtype == "float32" else assert_close_bf16
    check(got, want)
    check(vgot, vwant)
    for fuse in ("concat", "add", "mean"):
        p = PK.MultimodalKnowledgeEncoder(ptxt, pvis, fuse).encode(
            TEXTS[:3], images)
        j = JK.MultimodalKnowledgeEncoder(jtxt, jvis, fuse).encode(
            TEXTS[:3], images)
        check(p, j)
    with pytest.raises(ValueError):
        PK.MultimodalKnowledgeEncoder(ptxt, pvis, "nope")
    if dtype == "float32":
        p = PK.DenseRetriever(ptxt, PK.InMemoryVectorStore(),
                              PK.DocumentStore())
        j = JK.DenseRetriever(jtxt, JK.InMemoryVectorStore(),
                              JK.DocumentStore())
        p.index(_docs(PK))
        j.index(_docs(JK))
        for q in QUERIES:
            assert [r.doc_id for r in p.retrieve(q, 4)] == \
                [r.doc_id for r in j.retrieve(q, 4)]


def test_text_knowledge_encoder_falls_back_to_hashing():
    enc = PK.TextKnowledgeEncoder(dim=48)
    assert enc.dim == 48
    np.testing.assert_array_equal(enc.encode(TEXTS),
                                  JK.HashingTextEncoder(48).encode(TEXTS))
