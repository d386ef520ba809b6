"""Distance, similarity, and normalization kernels.

Two tiers, mirroring the reference's split between per-pair NIF helpers and
batched scans (reference native/vettore/src/distances.rs):

* **Host pairwise API** (`l2`, `cosine`, …): validates inputs like the
  reference's NIF boundary, computes in float64, and applies the reference's
  "representable in f32" overflow posture (distances.rs:42-98). These are the
  equivalents of `Vettore.Distance.*` (reference lib/vettore_distance.ex).

* **Batched scoring** (`batched_raw_scores`): plain PyTorch functions that
  score a whole `[N, d]` block against a batch of queries in f32 with one
  matmul, on whichever device the tensors live. This replaces the
  reference's per-row SIMD loop (distances.rs:197-308). f32 intermediates
  that overflow are recovered on host in float64 (`recover_overflow`),
  matching distances.rs:70-98.
"""

from __future__ import annotations

import math
from numbers import Real

import numpy as np
import torch

from ..errors import DimensionMismatch, InvalidVector, MetricOverflow, UnknownNormalization
from ..metrics import F32_MAX, validate_metric

NORMALIZATIONS = ("none", "l2", "zscore", "minmax")

# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def _finite_f32(value) -> bool:
    """True for ints/floats within the finite f32 range
    (mirrors reference lib/vettore_distance.ex:407-414)."""
    if isinstance(value, bool) or not isinstance(value, Real):
        return False
    try:
        v = float(value)
    except (TypeError, OverflowError):
        return False
    return -F32_MAX <= v <= F32_MAX and not math.isnan(v)


def validate_vector(vector):
    """Raises InvalidVector unless every element is a finite f32-range number."""
    if isinstance(vector, np.ndarray):
        if vector.ndim != 1:
            raise InvalidVector("vector must be one-dimensional")
        if not np.issubdtype(vector.dtype, np.number):
            raise InvalidVector("vector must be numeric")
        with np.errstate(invalid="ignore"):
            finite = np.isfinite(vector).all() and (np.abs(vector.astype(np.float64)) <= F32_MAX).all()
        if not finite:
            raise InvalidVector("vector contains a non-finite value")
        return
    if not isinstance(vector, (list, tuple)):
        raise InvalidVector("vector must be a list")
    for value in vector:
        if not _finite_f32(value):
            raise InvalidVector("vector contains a non-finite value")


def validate_pair(left, right):
    validate_vector(left)
    validate_vector(right)
    if len(left) != len(right):
        raise DimensionMismatch("dimension mismatch")


def _as_f64(vector) -> np.ndarray:
    return np.asarray(vector, dtype=np.float64)


def _check_f32(value: float) -> float:
    """The reference's f64→f32 recovery check (distances.rs:92-98)."""
    if not math.isfinite(value) or value < -F32_MAX or value > F32_MAX:
        raise MetricOverflow("metric overflow")
    return float(np.float32(value))


# ---------------------------------------------------------------------------
# Host pairwise metrics (float64 compute, f32-representable results)
# ---------------------------------------------------------------------------


def _raw_f64(metric: str, a: np.ndarray, b: np.ndarray) -> float:
    if metric == "l2":
        return math.sqrt(float(np.sum((a - b) ** 2)))
    if metric == "l2_squared":
        return float(np.sum((a - b) ** 2))
    if metric in ("cosine", "inner_product"):
        return float(np.dot(a, b))
    if metric == "negative_inner_product":
        return -float(np.dot(a, b))
    if metric == "manhattan":
        return float(np.sum(np.abs(a - b)))
    if metric == "chebyshev":
        return float(np.max(np.abs(a - b))) if a.size else 0.0
    if metric == "hamming":
        return float(np.sum((a != 0.0) != (b != 0.0)))
    if metric == "jaccard":
        lt, rt = a != 0.0, b != 0.0
        union = int(np.sum(lt | rt))
        if union == 0:
            return 0.0
        return 1.0 - float(np.sum(lt & rt)) / union
    raise AssertionError(metric)


def compute(metric, left, right) -> float:
    """Raw metric value for one pair; validates and applies overflow recovery.

    Equivalent of ``distances::compute_checked`` (distances.rs:100-105). Note
    that for ``cosine`` this returns the plain inner product — the collection
    pipeline stores L2-normalized vectors, so dot *is* cosine there
    (distances.rs:51).

    >>> compute("l2", [0.0, 0.0], [3.0, 4.0])
    5.0
    >>> compute("euclidean", [0.0, 0.0], [3.0, 4.0])  # metric aliases work
    5.0
    >>> compute("cosine", [1.0, 2.0], [3.0, 4.0])  # plain dot (see above)
    11.0
    """
    metric = validate_metric(metric)
    validate_pair(left, right)
    raw = _raw_f64(metric, _as_f64(left), _as_f64(right))
    if metric in ("hamming", "jaccard"):
        return float(np.float32(raw))
    return _check_f32(raw)


def l2(left, right) -> float:
    """Euclidean distance.

    >>> l2([0.0, 0.0], [3.0, 4.0])
    5.0
    """
    return compute("l2", left, right)


def l2_squared(left, right) -> float:
    """Squared Euclidean distance (monotonic in :func:`l2`, cheaper).

    >>> l2_squared([0.0, 0.0], [3.0, 4.0])
    25.0
    """
    return compute("l2_squared", left, right)


def inner_product(left, right) -> float:
    """Plain dot product (higher is better).

    >>> inner_product([1.0, 2.0], [3.0, 4.0])
    11.0
    """
    return compute("inner_product", left, right)


def negative_inner_product(left, right) -> float:
    """Negated dot product (lower is better — a distance-style IP).

    >>> negative_inner_product([1.0, 2.0], [3.0, 4.0])
    -11.0
    """
    return compute("negative_inner_product", left, right)


def manhattan(left, right) -> float:
    """L1 distance.

    >>> manhattan([0.0, 0.0], [3.0, -4.0])
    7.0
    """
    return compute("manhattan", left, right)


def chebyshev(left, right) -> float:
    """L-infinity distance.

    >>> chebyshev([0.0, 0.0], [3.0, -4.0])
    4.0
    """
    return compute("chebyshev", left, right)


def hamming(left, right) -> float:
    """Elementwise disagreement count over f32 values.

    >>> hamming([1.0, 2.0, 3.0], [1.0, 0.0, 3.0])
    1.0
    """
    return compute("hamming", left, right)


def jaccard(left, right) -> float:
    """Jaccard distance over non-zero supports.

    >>> jaccard([1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 1.0, 0.0])
    0.6666666865348816
    >>> jaccard([0.0], [0.0])
    0.0
    """
    return compute("jaccard", left, right)


def euclidean(left, right) -> float:
    """Alias of :func:`l2` (the reference's ``:euclidean`` metric alias).

    >>> euclidean([0.0, 0.0], [3.0, 4.0])
    5.0
    """
    return l2(left, right)


def dot_product(left, right) -> float:
    """Alias of :func:`inner_product` (the reference's ``:dot`` alias).

    >>> dot_product([1.0, 2.0], [3.0, 4.0])
    11.0
    """
    return inner_product(left, right)


def true_cosine(left, right) -> float:
    """Cosine similarity with internal L2 normalization in float64.

    Equivalent of ``distances::cosine`` (distances.rs:160-177): zero-norm
    inputs yield 0.0 and the result is clamped to [-1, 1].

    >>> true_cosine([1.0, 0.0], [2.0, 0.0])
    1.0
    >>> true_cosine([1.0, 0.0], [0.0, 5.0])
    0.0
    >>> true_cosine([0.0, 0.0], [1.0, 1.0])
    0.0
    """
    validate_pair(left, right)
    a, b = _as_f64(left), _as_f64(right)
    na = math.sqrt(float(np.dot(a, a)))
    nb = math.sqrt(float(np.dot(b, b)))
    if na == 0.0 or nb == 0.0:
        return 0.0
    sim = float(np.dot(a, b)) / (na * nb)
    if not math.isfinite(sim):
        raise MetricOverflow("metric overflow")
    return float(np.float32(min(1.0, max(-1.0, sim))))


def cosine(left, right, normalize: str = "l2") -> float:
    """Public cosine helper (``Vettore.Distance.cosine/3``,
    reference lib/vettore_distance.ex:143-154).

    With ``normalize="l2"`` (default) this is true cosine in [-1, 1]; with
    ``normalize="none"`` it is the plain inner product; other modes normalize
    both sides first and then take the inner product.

    >>> cosine([2.0, 0.0], [1.0, 0.0])
    1.0
    >>> cosine([2.0, 0.0], [1.0, 0.0], normalize="none")
    2.0
    """
    if normalize not in NORMALIZATIONS:
        raise UnknownNormalization(normalize)
    if normalize == "l2":
        return true_cosine(left, right)
    validate_pair(left, right)
    if normalize == "none":
        return compute("cosine", left, right)
    return compute("cosine", normalize_vector(left, normalize), normalize_vector(right, normalize))


# ---------------------------------------------------------------------------
# Normalization (float64 compute, f32-cast outputs; distances.rs:350-410)
# ---------------------------------------------------------------------------


def normalize_vector(vector, method: str) -> list:
    """Normalizes a vector; returns a list of floats (f32-cast values).

    * ``none``: identity (values cast to float)
    * ``l2``: unit norm; zero vectors stay zero
    * ``zscore``: population z-score; constant vectors become zero
    * ``minmax``: rescale to [0, 1]; constant vectors become zero

    >>> normalize_vector([3.0, 4.0], "l2")
    [0.6000000238418579, 0.800000011920929]
    >>> normalize_vector([1.0, 3.0], "minmax")
    [0.0, 1.0]
    >>> normalize_vector([5.0, 5.0], "zscore")
    [0.0, 0.0]
    >>> normalize_vector([1.5, -2.0], "none")
    [1.5, -2.0]
    """
    if method not in NORMALIZATIONS:
        raise UnknownNormalization(method)
    validate_vector(vector)
    v = _as_f64(vector)
    if method == "none":
        return [float(x) for x in v]
    if v.size == 0:
        return []
    if method == "l2":
        norm = math.sqrt(float(np.dot(v, v)))
        out = np.zeros_like(v) if norm == 0.0 else v / norm
    elif method == "zscore":
        mean = float(np.mean(v))
        stddev = math.sqrt(float(np.mean((v - mean) ** 2)))
        out = np.zeros_like(v) if stddev == 0.0 else (v - mean) / stddev
    else:  # minmax
        lo, hi = float(np.min(v)), float(np.max(v))
        out = np.zeros_like(v) if lo == hi else (v - lo) / (hi - lo)
    return [float(x) for x in out.astype(np.float32)]


#: elements processed per normalization chunk — bounds the transient f64
#: working set of million-row ingests to 2**26 elements instead of three
#: full-matrix f64 temporaries
_NORM_CHUNK_ELEMS = 1 << 26


def normalize_rows(matrix: np.ndarray, method: str) -> np.ndarray:
    """Row-wise vectorized normalization with the same semantics as
    :func:`normalize_vector` (float64 math, float32 output). Used by the
    collection insert pipeline for batch ingest. Processes row chunks so the
    f64 intermediates never materialize at full-matrix size; every reduction
    is row-local, so chunking cannot change a single output bit."""
    if method not in NORMALIZATIONS:
        raise UnknownNormalization(method)
    m = np.asarray(matrix)
    if method == "none" or m.size == 0:
        return np.ascontiguousarray(m, dtype=np.float32)
    n, d = m.shape
    out = np.empty((n, d), dtype=np.float32)
    step = max(1, _NORM_CHUNK_ELEMS // max(d, 1))
    for s in range(0, n, step):
        c = np.asarray(m[s : s + step], dtype=np.float64)
        if method == "l2":
            # np.sum keeps the pairwise summation order (einsum is ~1 ulp
            # different); the divide reuses c — one fewer f64-sized temp
            key = np.sqrt(np.sum(c * c, axis=1, keepdims=True))
            r = np.divide(c, np.where(key == 0.0, 1.0, key), out=c)
        elif method == "zscore":
            mean = np.mean(c, axis=1, keepdims=True)
            key = np.sqrt(np.mean((c - mean) ** 2, axis=1, keepdims=True))
            r = (c - mean) / np.where(key == 0.0, 1.0, key)
        else:  # minmax
            lo = np.min(c, axis=1, keepdims=True)
            key = np.max(c, axis=1, keepdims=True) - lo
            r = (c - lo) / np.where(key == 0.0, 1.0, key)
        r[key[:, 0] == 0.0] = 0.0
        out[s : s + step] = r
    return out


# ---------------------------------------------------------------------------
# Batched scoring (plain PyTorch, f32)
# ---------------------------------------------------------------------------


def no_tf32(t: torch.Tensor) -> None:
    """Raises unless an f32 matmul on ``t``'s device runs in full f32.

    The f32 path must stay exact (the counterpart of the JAX package's
    ``Precision.HIGHEST``): TF32 keeps ~10 mantissa bits and shows up as
    ~1e-3 deviations in raw scores."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on; the f32 search path "
            "needs full-f32 matmuls")


def batched_raw_scores(x: torch.Tensor, q: torch.Tensor, *, metric: str) -> torch.Tensor:
    """Scores every row of ``x`` [N, d] against every query of ``q`` [B, d];
    returns raw [B, N] f32. Cosine is the plain dot product (the flat-index
    path over already-normalized vectors, flat.rs:105 → distances.rs:51)."""
    x = x.float()
    q = q.float()
    no_tf32(x)
    if metric in ("cosine", "inner_product", "negative_inner_product"):
        dot = q @ x.T
        return -dot if metric == "negative_inner_product" else dot
    if metric in ("l2", "l2_squared"):
        sq = (x * x).sum(dim=1)[None, :] - 2.0 * (q @ x.T) + (q * q).sum(dim=1)[:, None]
        sq = sq.clamp_min(0.0)
        return sq.sqrt() if metric == "l2" else sq
    if metric in ("hamming", "jaccard"):
        lt = (x != 0.0).float()
        rt = (q != 0.0).float()
        inter = rt @ lt.T
        if metric == "hamming":
            # |a xor b| = |a| + |b| - 2|a and b|, exact in f32 for d < 2**24
            return lt.sum(dim=1)[None, :] + rt.sum(dim=1)[:, None] - 2.0 * inter
        union = lt.sum(dim=1)[None, :] + rt.sum(dim=1)[:, None] - inter
        return torch.where(union > 0.0, 1.0 - inter / union.clamp_min(1.0),
                           torch.zeros_like(union))
    if metric not in ("manhattan", "chebyshev"):
        raise ValueError(f"unknown metric {metric}")
    if x.shape[1] == 0:
        return x.new_zeros((q.shape[0], x.shape[0]))
    p = 1.0 if metric == "manhattan" else float("inf")
    return torch.cdist(q[None], x[None], p=p)[0]


def rank_from_raw(raw: torch.Tensor, *, metric: str) -> torch.Tensor:
    """Vectorized rank conversion (ascending = better); distances.rs:113-119."""
    if metric == "cosine":
        return 1.0 - raw
    if metric == "inner_product":
        return -raw
    return raw


def recover_overflow(metric: str, x_np: np.ndarray, q_np: np.ndarray, raw_np: np.ndarray,
                     *, use_true_cosine: bool = False) -> np.ndarray:
    """Recomputes non-finite f32 scores in float64 on host.

    The batched scan computes in f32; intermediates can overflow even when the
    mathematical result is representable (the reference hits the same with
    SIMD f32 and recovers per-pair in f64, distances.rs:59-98). Raises
    MetricOverflow when a recovered value is genuinely outside f32 range.
    """
    bad = ~np.isfinite(raw_np)
    if not bad.any():
        return raw_np
    if metric in ("hamming", "jaccard"):
        raise MetricOverflow("metric overflow")
    out = raw_np.copy()
    q64 = q_np.astype(np.float64)
    for i in np.nonzero(bad)[0]:
        row = x_np[i].astype(np.float64)
        if metric == "cosine" and use_true_cosine:
            na = math.sqrt(float(np.dot(row, row)))
            nb = math.sqrt(float(np.dot(q64, q64)))
            value = 0.0 if na == 0.0 or nb == 0.0 else min(1.0, max(-1.0, float(np.dot(row, q64)) / (na * nb)))
        else:
            value = _raw_f64(metric, q64, row)
        out[i] = _check_f32(value)
    return out
