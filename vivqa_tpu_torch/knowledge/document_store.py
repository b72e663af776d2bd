"""Document store with content-hash ids and secondary indices (a copy of
vivqa_tpu/knowledge/document_store.py, which the port does not import;
the ids are the same SHA-1 prefixes).

Counterpart of src/modeling/knowledge_base/document_store.py:16-457 in
the reference: Document / KnowledgeEntry / VisualKnowledgeEntry
dataclasses, a DocumentStore with source/type/category indices, and JSON
persistence.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional


def _content_hash(content: str) -> str:
    return hashlib.sha1(content.encode("utf-8")).hexdigest()[:16]


@dataclasses.dataclass
class Document:
    content: str
    doc_id: str = ""
    source: str = ""
    doc_type: str = "text"
    category: str = ""
    metadata: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.doc_id:
            self.doc_id = _content_hash(self.content)


@dataclasses.dataclass
class KnowledgeEntry(Document):
    """A fact with subject/relation structure (reference :93)."""
    subject: str = ""
    relation: str = ""
    object: str = ""


@dataclasses.dataclass
class VisualKnowledgeEntry(Document):
    """Knowledge tied to an image region (reference :141)."""
    image_path: str = ""
    bbox: Optional[tuple] = None


class DocumentStore:
    def __init__(self):
        self._docs: Dict[str, Document] = {}
        self._by_source = defaultdict(set)
        self._by_type = defaultdict(set)
        self._by_category = defaultdict(set)

    def __len__(self):
        return len(self._docs)

    def __contains__(self, doc_id: str):
        return doc_id in self._docs

    def add(self, doc: Document) -> str:
        self._docs[doc.doc_id] = doc
        if doc.source:
            self._by_source[doc.source].add(doc.doc_id)
        if doc.doc_type:
            self._by_type[doc.doc_type].add(doc.doc_id)
        if doc.category:
            self._by_category[doc.category].add(doc.doc_id)
        return doc.doc_id

    def add_many(self, docs: List[Document]) -> List[str]:
        return [self.add(d) for d in docs]

    def get(self, doc_id: str) -> Optional[Document]:
        return self._docs.get(doc_id)

    def remove(self, doc_id: str) -> bool:
        doc = self._docs.pop(doc_id, None)
        if doc is None:
            return False
        self._by_source[doc.source].discard(doc_id)
        self._by_type[doc.doc_type].discard(doc_id)
        self._by_category[doc.category].discard(doc_id)
        return True

    def all(self) -> List[Document]:
        return list(self._docs.values())

    def by_source(self, source: str) -> List[Document]:
        return [self._docs[i] for i in self._by_source.get(source, ())]

    def by_type(self, doc_type: str) -> List[Document]:
        return [self._docs[i] for i in self._by_type.get(doc_type, ())]

    def by_category(self, category: str) -> List[Document]:
        return [self._docs[i] for i in self._by_category.get(category, ())]

    # -- persistence ------------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = []
        for d in self._docs.values():
            rec = dataclasses.asdict(d)
            rec["_cls"] = type(d).__name__
            payload.append(rec)
        path.write_text(json.dumps(payload, ensure_ascii=False, indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "DocumentStore":
        store = cls()
        classes = {"Document": Document, "KnowledgeEntry": KnowledgeEntry,
                   "VisualKnowledgeEntry": VisualKnowledgeEntry}
        for rec in json.loads(Path(path).read_text()):
            klass = classes.get(rec.pop("_cls", "Document"), Document)
            if rec.get("bbox") is not None:
                rec["bbox"] = tuple(rec["bbox"])
            store.add(klass(**rec))
        return store
