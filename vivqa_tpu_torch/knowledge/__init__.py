"""Knowledge base and retrieval-augmented generation (counterpart of
vivqa_tpu/knowledge/): Vietnamese text processing, document and vector
stores, text / visual / multimodal encoders, dense / BM25 / hybrid /
multimodal / reranking retrievers, the RAG modules, the host-side
``KnowledgeProvider`` stage and the knowledge-base helpers. The host
modules are copies of the JAX package's, which the port does not import.
"""

from vivqa_tpu_torch.knowledge.document_store import (
    Document, DocumentStore, KnowledgeEntry, VisualKnowledgeEntry)
from vivqa_tpu_torch.knowledge.encoders import (
    HashingTextEncoder, MultimodalKnowledgeEncoder, TextKnowledgeEncoder,
    VisualKnowledgeEncoder)
from vivqa_tpu_torch.knowledge.provider import (
    KnowledgeLoader, KnowledgeProvider, KnowledgeProviderConfig)
from vivqa_tpu_torch.knowledge.rag import (ContextAttention, RAGFusion,
                                           RAGModule, rag_loss)
from vivqa_tpu_torch.knowledge.retrievers import (
    BaseRetriever, DenseRetriever, HybridRetriever, MultimodalRetriever,
    RerankerRetriever, RetrievalResult, SparseRetriever, create_retriever)
from vivqa_tpu_torch.knowledge.utils import (
    batch_encode, chunk_documents, cluster_documents,
    create_knowledge_base_index, deduplicate_by_similarity,
    deduplicate_documents, embedding_statistics, evaluate_retrieval,
    export_documents_json, format_knowledge_prompt, import_documents_json,
    load_knowledge_base, retrieve_diverse, save_knowledge_base,
    similarity_matrix)
from vivqa_tpu_torch.knowledge.vector_store import (
    BaseVectorStore, ChromaVectorStore, FAISSVectorStore,
    InMemoryVectorStore, create_vector_store)
from vivqa_tpu_torch.knowledge.vietnamese import (
    VIETNAMESE_STOPWORDS, VietnameseTextProcessor, VietnameseTokenizer,
    ascii_fold, chunk_text, detect_vietnamese, extract_keywords,
    normalize_vietnamese_text, remove_stopwords, split_sentences)

__all__ = [
    "Document", "KnowledgeEntry", "VisualKnowledgeEntry", "DocumentStore",
    "BaseVectorStore", "ChromaVectorStore", "InMemoryVectorStore", "FAISSVectorStore",
    "create_vector_store",
    "HashingTextEncoder", "TextKnowledgeEncoder", "VisualKnowledgeEncoder",
    "MultimodalKnowledgeEncoder",
    "BaseRetriever", "DenseRetriever", "SparseRetriever", "HybridRetriever",
    "MultimodalRetriever", "RerankerRetriever", "RetrievalResult",
    "create_retriever",
    "ContextAttention", "RAGFusion", "RAGModule", "rag_loss",
    "KnowledgeLoader", "KnowledgeProvider", "KnowledgeProviderConfig",
    "VietnameseTokenizer", "VietnameseTextProcessor",
    "normalize_vietnamese_text", "split_sentences", "remove_stopwords",
    "extract_keywords", "chunk_text", "detect_vietnamese", "ascii_fold",
    "VIETNAMESE_STOPWORDS",
    "chunk_documents", "batch_encode", "save_knowledge_base",
    "load_knowledge_base", "import_documents_json", "export_documents_json",
    "embedding_statistics", "similarity_matrix", "deduplicate_documents",
    "deduplicate_by_similarity", "retrieve_diverse", "cluster_documents",
    "format_knowledge_prompt", "create_knowledge_base_index",
    "evaluate_retrieval",
]
