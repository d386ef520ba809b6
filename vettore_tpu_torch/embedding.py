"""Record and result types.

Mirrors ``%Vettore.Embedding{}`` (reference lib/vettore_embedding.ex:15-24)
and ``%Vettore.Result{}`` (reference lib/vettore/result.ex:6-16).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Embedding:
    """One stored record.

    ``vector`` is the primary dense vector (normalized at insert according to
    the collection config). ``vectors`` optionally holds multi-vector
    (ColBERT-style token/page) representations. ``binary_vector`` is the packed
    sign-bit representation (list of u64 words) generated automatically at
    insert for quantized candidate search.
    """

    id: Optional[str] = None
    value: Any = None
    vector: Optional[list] = None
    vectors: Optional[list] = None
    binary_vector: Optional[list] = None
    metadata: Any = None

    @classmethod
    def from_input(cls, item) -> "Embedding":
        """Accepts an Embedding or a dict with equivalent keys.

        Mirrors ``Collection.to_embedding/1``
        (reference lib/vettore/collection.ex:1019-1067): a dict must
        provide (id or value) together with (vector or vectors).
        """
        from .errors import InvalidEmbedding

        if isinstance(item, Embedding):
            return cls(
                id=item.id,
                value=item.value,
                vector=item.vector,
                vectors=item.vectors,
                binary_vector=item.binary_vector,
                metadata=item.metadata,
            )
        if isinstance(item, dict):
            has_id = "id" in item
            has_value = "value" in item
            has_vector = "vector" in item
            has_vectors = "vectors" in item
            if has_id and (has_vector or has_vectors):
                return cls(
                    id=item["id"],
                    value=item.get("value", item["id"]),
                    vector=item.get("vector"),
                    vectors=item.get("vectors"),
                    metadata=item.get("metadata"),
                )
            if has_value and (has_vector or has_vectors):
                return cls(
                    id=None,
                    value=item["value"],
                    vector=item.get("vector"),
                    vectors=item.get("vectors"),
                    metadata=item.get("metadata"),
                )
        raise InvalidEmbedding("invalid embedding input")


@dataclass
class Result:
    """One search hit with explicit score/distance semantics.

    ``score`` is always higher-is-better; ``distance`` is lower-is-better and
    may be ``None`` for scorers without a distance form (e.g. MaxSim).
    """

    id: str
    score: float
    metric: str
    value: Any = None
    distance: Optional[float] = None
    metadata: Any = field(default=None)
