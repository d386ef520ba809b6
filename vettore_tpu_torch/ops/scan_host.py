"""Host (float64) batched top-k scans with reference semantics.

These are the library-level equivalents of the reference's batched NIF helpers
``vector_top_k`` / ``binary_top_k`` (reference native/vettore/src/
search.rs:38-110): prefix-aware scoring for Matryoshka funnel stages, stable
(rank, id) ordering, and full input validation. They serve as the public
standalone API, the correctness oracle for the fused device pipelines, and the
float64 fallback when an f32 device scan overflows.
"""

from __future__ import annotations

import numpy as np

from ..errors import DimensionMismatch, InvalidVector
from ..metrics import rank_value, validate_metric
from .distance import _check_f32, _raw_f64, validate_vector
from .packing import _masked_words, _validate_packed_pair, words_for


def vector_top_k(vectors, query, metric, dimensions: int, limit: int) -> list:
    """Scores ``[(id, vector)]`` pairs against ``query[:dimensions]`` and
    returns the best ``limit`` as ``[(id, raw)]``.

    Prefix-aware: only the first ``dimensions`` coordinates are read
    (search.rs:38-73), enabling funnel staging. For the cosine metric the raw
    value is the true (renormalized) cosine of the prefixes (search.rs:56-58).

    >>> vector_top_k([("a", [1.0, 0.0]), ("b", [0.0, 1.0])],
    ...              [1.0, 0.1], "cosine", 2, 1)
    [('a', 0.9950371980667114)]
    >>> vector_top_k([("a", [1.0, 9.9]), ("b", [0.0, 9.9])],
    ...              [1.0, 0.0], "l2", 1, 2)  # prefix: only dim 0 scored
    [('a', 0.0), ('b', 1.0)]
    """
    if not isinstance(dimensions, int) or isinstance(dimensions, bool):
        raise InvalidVector("invalid prefix dimensions")
    if dimensions == 0 or dimensions > len(query):
        raise InvalidVector("invalid prefix dimensions")
    q_prefix = list(query[:dimensions])
    validate_vector(q_prefix)
    metric = validate_metric(metric)
    q = np.asarray(q_prefix, dtype=np.float64)

    hits = []
    for id, vector in vectors:
        if dimensions > len(vector):
            raise DimensionMismatch("dimension mismatch")
        v_prefix = list(vector[:dimensions])
        validate_vector(v_prefix)
        v = np.asarray(v_prefix, dtype=np.float64)
        raw = _cosine_or_raw(metric, q, v)
        hits.append((rank_value(metric, raw), str(id), raw))
    hits.sort(key=lambda h: (h[0], h[1]))
    return [(id, raw) for _, id, raw in hits[:limit]]


def _cosine_or_raw(metric: str, q: np.ndarray, v: np.ndarray) -> float:
    import math

    if metric == "cosine":
        nq = math.sqrt(float(np.dot(q, q)))
        nv = math.sqrt(float(np.dot(v, v)))
        if nq == 0.0 or nv == 0.0:
            return 0.0
        sim = float(np.dot(q, v)) / (nq * nv)
        return float(np.float32(min(1.0, max(-1.0, sim))))
    raw = _raw_f64(metric, q, v)
    if metric in ("hamming", "jaccard"):
        return float(np.float32(raw))
    return _check_f32(raw)


def binary_top_k(vectors, query_words, dimensions: int, limit: int) -> list:
    """Packed-Hamming scan over ``[(id, u64_words)]``; validates the query even
    for an empty batch (search.rs:76-92).

    >>> binary_top_k([("a", [0b1100]), ("b", [0b1010])], [0b1000], 4, 2)
    [('a', 1.0), ('b', 1.0)]
    >>> binary_top_k([], [0b1000], 4, 5)
    []
    """
    _validate_packed_pair(query_words, query_words, dimensions)
    q = _masked_words(query_words, dimensions)
    expected = words_for(dimensions)

    hits = []
    for id, words in vectors:
        if not isinstance(words, (list, tuple)) or len(words) != expected:
            raise InvalidVector("dimension mismatch")
        _validate_packed_pair(words, words, dimensions)
        w = _masked_words(words, dimensions)
        raw = float(sum(int(x).bit_count() for x in np.bitwise_xor(q, w)))
        hits.append((raw, str(id), raw))
    hits.sort(key=lambda h: (h[0], h[1]))
    return [(id, raw) for _, id, raw in hits[:limit]]
