"""Vietnamese NLP utilities (a copy of vivqa_tpu/knowledge/vietnamese.py,
which the port does not import).

Counterpart of src/modeling/knowledge_base/vietnamese_processor.py in the
reference: text normalization, tokenization (underthesea/pyvi when
installed, a whitespace fallback otherwise, as the reference degrades),
sentence splitting, stopword filtering, keyword extraction, chunking,
diacritic-based language detection, ASCII folding.
"""

from __future__ import annotations

import re
import unicodedata
from collections import Counter
from typing import List

# Core Vietnamese stopword list (reference VIETNAMESE_STOPWORDS)
VIETNAMESE_STOPWORDS = frozenset("""
và của là có được cho trong với để không này đó các một những người khi
thì mà ra nếu vì từ theo trên dưới về đã sẽ đang bị bởi cũng như nhưng
lại còn nên tại do đến nơi ở hay hoặc rằng thế nào ai gì đâu sao vậy
nữa rồi chỉ vẫn phải
""".split())

_VIETNAMESE_DIACRITIC_CHARS = set(
    "àáạảãâầấậẩẫăằắặẳẵèéẹẻẽêềếệểễìíịỉĩòóọỏõôồốộổỗơờớợởỡ"
    "ùúụủũưừứựửữỳýỵỷỹđ")


def normalize_vietnamese_text(text: str, lowercase: bool = True) -> str:
    """NFC normalize, collapse whitespace, optional lowercase
    (reference :55)."""
    text = unicodedata.normalize("NFC", str(text))
    if lowercase:
        text = text.lower()
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class VietnameseTokenizer:
    """Word segmentation: underthesea -> pyvi -> whitespace fallback
    (reference :107-202)."""

    def __init__(self, backend: str = "auto"):
        self.backend = "whitespace"
        if backend in ("auto", "underthesea"):
            try:
                from underthesea import word_tokenize  # noqa: F401
                self.backend = "underthesea"
            except ImportError:
                pass
        if self.backend == "whitespace" and backend in ("auto", "pyvi"):
            try:
                from pyvi import ViTokenizer  # noqa: F401
                self.backend = "pyvi"
            except ImportError:
                pass

    def tokenize(self, text: str) -> List[str]:
        text = normalize_vietnamese_text(text)
        if self.backend == "underthesea":
            from underthesea import word_tokenize
            return word_tokenize(text)
        if self.backend == "pyvi":
            from pyvi import ViTokenizer
            return ViTokenizer.tokenize(text).split()
        return re.findall(r"\w+", text, flags=re.UNICODE)


def split_sentences(text: str) -> List[str]:
    """Sentence splitter on terminal punctuation (reference :204)."""
    parts = re.split(r"(?<=[.!?…])\s+", text.strip())
    return [p.strip() for p in parts if p.strip()]


def remove_stopwords(tokens: List[str]) -> List[str]:
    return [t for t in tokens if t.lower() not in VIETNAMESE_STOPWORDS]


def extract_keywords(text: str, top_k: int = 10,
                     tokenizer: VietnameseTokenizer | None = None) -> List[str]:
    """Frequency-based keywords after stopword removal (reference :264+)."""
    tok = tokenizer or VietnameseTokenizer()
    tokens = remove_stopwords(tok.tokenize(text))
    tokens = [t for t in tokens if len(t) > 1 and not t.isdigit()]
    return [w for w, _ in Counter(tokens).most_common(top_k)]


def chunk_text(text: str, chunk_size: int = 200, overlap: int = 50) -> List[str]:
    """Token-count chunking with overlap (reference kb_utils chunking)."""
    words = text.split()
    if not words:
        return []
    chunks = []
    step = max(1, chunk_size - overlap)
    for start in range(0, len(words), step):
        chunk = words[start:start + chunk_size]
        chunks.append(" ".join(chunk))
        if start + chunk_size >= len(words):
            break
    return chunks


def detect_vietnamese(text: str, threshold: float = 0.02) -> bool:
    """Diacritic-frequency heuristic (reference :440)."""
    letters = [c for c in text.lower() if c.isalpha()]
    if not letters:
        return False
    diacritics = sum(1 for c in letters if c in _VIETNAMESE_DIACRITIC_CHARS)
    return diacritics / len(letters) >= threshold


def ascii_fold(text: str) -> str:
    """Strip diacritics: 'mèo đen' -> 'meo den' (reference :475)."""
    text = text.replace("đ", "d").replace("Đ", "D")
    nfkd = unicodedata.normalize("NFD", text)
    return "".join(c for c in nfkd if not unicodedata.combining(c))


class VietnameseTextProcessor:
    """Facade bundling the above (reference :264-437)."""

    def __init__(self, backend: str = "auto"):
        self.tokenizer = VietnameseTokenizer(backend)

    def process(self, text: str) -> dict:
        norm = normalize_vietnamese_text(text)
        tokens = self.tokenizer.tokenize(norm)
        return {
            "normalized": norm,
            "tokens": tokens,
            "content_tokens": remove_stopwords(tokens),
            "keywords": extract_keywords(norm, tokenizer=self.tokenizer),
            "sentences": split_sentences(text),
            "is_vietnamese": detect_vietnamese(text),
        }
