"""Data schema: a copy of vivqa_tpu/data/schema.py (reference: OneSample
pydantic model, src/schema/data_schema.py:5-12) — a plain dataclass
here; validation is explicit in the loading step."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class OneSample:
    image_path: str
    question: str
    answers: List[str]
    metadata: Optional[Dict[str, Any]] = None

    def validate(self) -> List[str]:
        problems = []
        if not self.image_path:
            problems.append("empty image_path")
        if not self.question or not self.question.strip():
            problems.append("empty question")
        if not self.answers:
            problems.append("no answers")
        return problems
