"""MUVERA fixed-dimensional encodings (FDE) for multi-vector retrieval.

A copy of ``vettore_tpu/ops/muvera.py`` (host numpy, no JAX), kept
bit-identical to it: the JAX package's module is the reference and this
package imports nothing of it.

Bit-compatible redesign of the reference's native/vettore/src/muvera.rs:
the same splitmix-style ``hash4`` mixer (muvera.rs:219-225), the same
hash-derived SimHash weights (``random_weight``, :203-207) and Rademacher
signs (:210-216), query = sum vs document = running-average accumulation with
f32 slot storage (:164-177), and the optional count-sketch final compression
(:180-200). Hash evaluation is vectorized with uint64 numpy arithmetic
(wrapping mul/add ≡ Rust ``wrapping_*``), so encodings are deterministic,
permutation-invariant (query mode), and seed-sensitive exactly like the
reference.

Config validation mirrors the reference's lib/vettore/encoding/muvera.ex.
"""

from __future__ import annotations

import numpy as np

from ..errors import DimensionMismatch, EncodingOverflow, InvalidMuveraConfig, InvalidVector
from ..metrics import F32_MAX

MAX_OUTPUT_DIMENSIONS = 16_777_216
U64_MAX = (1 << 64) - 1

_GOLDEN = np.uint64(0x9E37_79B9_7F4A_7C15)
_MIX1 = np.uint64(0xBF58_476D_1CE4_E5B9)
_MIX2 = np.uint64(0x94D0_49BB_1331_11EB)
_SKETCH_SIGN = np.uint64(0xD1B5_4A32_D192_ED03)

CONFIG_KEYS = (
    "dimension",
    "num_repetitions",
    "num_simhash_projections",
    "seed",
    "projection_dimension",
    "final_projection_dimension",
)


def _rotl(x, k: int):
    k = np.uint64(k)
    return (x << k) | (x >> (np.uint64(64) - k))


def _hash4(a, b, c, d):
    """Vectorized 4-coordinate mixer, bit-identical to muvera.rs:219-225."""
    a = np.uint64(a) if np.isscalar(a) else np.asarray(a, dtype=np.uint64)
    b = np.uint64(b) if np.isscalar(b) else np.asarray(b, dtype=np.uint64)
    c = np.uint64(c) if np.isscalar(c) else np.asarray(c, dtype=np.uint64)
    d = np.uint64(d) if np.isscalar(d) else np.asarray(d, dtype=np.uint64)
    with np.errstate(over="ignore"):  # uint64 wrapping ≡ Rust wrapping_add/mul
        x = a ^ _rotl(b, 17) ^ _rotl(c, 31) ^ _rotl(d, 47)
        x = x + _GOLDEN
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        return x ^ (x >> np.uint64(31))


import functools


@functools.lru_cache(maxsize=256)
def _random_weights(seed: int, repetition: int, projection: int, dims: int) -> np.ndarray:
    """Deterministic pseudo-random weights in [-1, 1] for one SimHash
    projection row (muvera.rs:203-207): f64 division then f32 cast, then the
    affine map in f32 — matching the reference's cast order. Cached: batch
    encoding calls this with identical arguments for every vector set."""
    h = _hash4(np.uint64(seed), np.uint64(repetition), np.uint64(projection),
               np.arange(dims, dtype=np.uint64))
    unit = (h.astype(np.float64) / float(U64_MAX)).astype(np.float32)
    out = unit * np.float32(2.0) - np.float32(1.0)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=1024)
def _random_signs(seed: int, repetition: int, projection: int, dims: int) -> np.ndarray:
    h = _hash4(np.uint64(seed), np.uint64(repetition), np.uint64(projection),
               np.arange(dims, dtype=np.uint64))
    out = np.where((h & np.uint64(1)) == 0, np.float32(1.0), np.float32(-1.0))
    out.setflags(write=False)
    return out


def _cfg_error(message: str, reason: str):
    err = InvalidMuveraConfig(message)
    err.reason = reason
    return err


def _normalize_config(config: dict, inferred_dim: int) -> dict:
    for key in config:
        if key not in CONFIG_KEYS:
            raise _cfg_error(f"unknown config key: {key!r}", "invalid_config")

    def pos_int(v):
        return isinstance(v, int) and not isinstance(v, bool) and v > 0

    dimension = config.get("dimension", inferred_dim)
    if not isinstance(dimension, int) or isinstance(dimension, bool):
        raise _cfg_error("dimension must be an integer", "invalid_dimension")
    if dimension != inferred_dim:
        raise DimensionMismatch("config dimension does not match vectors")
    reps = config.get("num_repetitions", 1)
    if not pos_int(reps):
        raise _cfg_error("num_repetitions must be positive", "invalid_repetitions")
    simhash = config.get("num_simhash_projections", 0)
    if not isinstance(simhash, int) or isinstance(simhash, bool) or not 0 <= simhash < 31:
        raise _cfg_error("num_simhash_projections must be in 0..30", "invalid_simhash_projections")
    seed = config.get("seed", 1)
    if not isinstance(seed, int) or isinstance(seed, bool) or not 0 <= seed <= U64_MAX:
        raise _cfg_error("seed must be a u64", "invalid_seed")
    proj_dim = config.get("projection_dimension", dimension)
    if not pos_int(proj_dim):
        raise _cfg_error("projection_dimension must be positive", "invalid_projection_dimension")
    final_dim = config.get("final_projection_dimension")
    if final_dim is not None and not pos_int(final_dim):
        raise _cfg_error(
            "final_projection_dimension must be positive", "invalid_final_projection_dimension"
        )
    full = reps * (1 << simhash) * proj_dim
    if max(full, final_dim or full) > MAX_OUTPUT_DIMENSIONS:
        raise _cfg_error("fde dimension exceeds safety limit", "encoding_too_large")
    return {
        "dimension": dimension,
        "num_repetitions": reps,
        "num_simhash_projections": simhash,
        "seed": seed,
        "projection_dimension": proj_dim,
        "final_projection_dimension": final_dim,
    }


def _prepare_vectors(vectors) -> np.ndarray:
    if isinstance(vectors, np.ndarray) and vectors.ndim == 2 and vectors.size:
        # fast path for matrix input (batch encoders hand these through)
        if not np.isfinite(vectors).all() or (np.abs(vectors) > F32_MAX).any():
            raise InvalidVector("invalid vectors")
        return vectors.astype(np.float64)
    if not isinstance(vectors, (list, tuple)):
        raise InvalidVector("invalid vectors")
    if len(vectors) == 0:
        raise _cfg_error("empty vectors", "empty_vectors")
    first = vectors[0]
    if not isinstance(first, (list, tuple, np.ndarray)) or len(first) == 0:
        raise InvalidVector("invalid vectors")
    dim = len(first)
    for v in vectors:
        if len(v) != dim:
            raise DimensionMismatch("dimension mismatch")
    try:
        arr = np.asarray(vectors, dtype=np.float64)
    except (TypeError, ValueError) as exc:
        raise InvalidVector("invalid vectors") from exc
    if not np.isfinite(arr).all() or (np.abs(arr) > F32_MAX).any():
        raise InvalidVector("invalid vectors")
    return arr


def _check_slots(slots: np.ndarray):
    if not np.isfinite(slots).all():
        raise EncodingOverflow("encoding overflow")


def _encode(vectors, config, mode: str) -> list:
    arr = _prepare_vectors(vectors)
    cfg = _normalize_config(dict(config or {}), arr.shape[1])
    dims = cfg["dimension"]
    reps = cfg["num_repetitions"]
    simhash = cfg["num_simhash_projections"]
    seed = cfg["seed"]
    proj_dim = cfg["projection_dimension"]
    partitions = 1 << simhash
    rep_size = partitions * proj_dim

    out = np.zeros(reps * rep_size, dtype=np.float32)

    identity = proj_dim == dims
    sign_seed = (seed + 17) & U64_MAX

    for rep in range(reps):
        if simhash:
            weights = np.stack(
                [_random_weights(seed, rep, p, dims) for p in range(simhash)]
            ).astype(np.float64)  # [simhash, dims]
            dots = arr @ weights.T  # [V, simhash] float64
            bits = (dots >= 0.0).astype(np.int64)
            powers = 1 << np.arange(simhash - 1, -1, -1, dtype=np.int64)
            parts = bits @ powers  # projection 0 is the most significant bit
        else:
            parts = np.zeros(arr.shape[0], dtype=np.int64)
        if identity:
            values_all = arr  # [V, proj_dim]
        else:
            signs = np.stack(
                [_random_signs(sign_seed, rep, p, dims) for p in range(proj_dim)]
            ).astype(np.float64)  # [proj_dim, dims]
            values_all = arr @ signs.T  # [V, proj_dim]

        # Round-based accumulation: vectors grouped by partition (stable, so
        # input order within each partition is preserved), then round j adds
        # the j-th member of EVERY partition at once. Per-step semantics are
        # unchanged from the reference's sequential accumulate
        # (muvera.rs:164-177): f64 add / running-average, f32 slot store,
        # per-step overflow check — only the Python iteration count drops
        # from V to max-members-per-partition.
        order = np.argsort(parts, kind="stable")
        parts_sorted = parts[order]
        first = np.concatenate([[True], parts_sorted[1:] != parts_sorted[:-1]])
        seg_start = np.maximum.accumulate(np.where(first, np.arange(parts_sorted.size), 0))
        within = np.arange(parts_sorted.size) - seg_start  # 0-based rank in partition
        rows = np.arange(proj_dim)
        for j in range(int(within.max()) + 1 if within.size else 0):
            sel = order[within == j]
            p_sel = parts[sel]
            bases = rep * rep_size + p_sel * proj_dim
            gather = bases[:, None] + rows[None, :]
            current = out[gather].astype(np.float64)
            values = values_all[sel]
            if mode == "query":
                nxt = current + values
            else:  # document: running average with count = j + 1
                nxt = current + (values - current) / (j + 1)
            if not np.isfinite(nxt).all() or (np.abs(nxt) > F32_MAX).any():
                raise EncodingOverflow("encoding overflow")
            out[gather] = nxt.astype(np.float32)

    final_dim = cfg["final_projection_dimension"]
    if final_dim is not None:
        out = _count_sketch(out, final_dim, seed)
    return [float(x) for x in out]


def _count_sketch(values: np.ndarray, final_dim: int, seed: int) -> np.ndarray:
    """Signed-hash compression (muvera.rs:180-200). Accumulation happens in
    input-index order into f32 slots; an intermediate f32 overflow sticks (inf
    never cancels), matching the reference's per-add overflow check."""
    idx = np.arange(values.size, dtype=np.uint64)
    slots = (_hash4(np.uint64(seed), _GOLDEN, idx, np.uint64(0)) % np.uint64(final_dim)).astype(
        np.int64
    )
    sign_hash = _hash4(np.uint64(seed), _SKETCH_SIGN, idx, slots.astype(np.uint64))
    signs = np.where((sign_hash & np.uint64(1)) == 0, np.float32(1.0), np.float32(-1.0))
    out = np.zeros(final_dim, dtype=np.float32)
    np.add.at(out, slots, signs * values.astype(np.float32))
    _check_slots(out)
    return out


def encode_query(vectors, config=None) -> list:
    """Query FDE: vectors sum within each partition.

    Deterministic and permutation-invariant — the same token set encodes
    to the same vector regardless of order:

    >>> cfg = {"num_repetitions": 2, "num_simhash_projections": 2, "seed": 7}
    >>> a = encode_query([[1.0, 2.0], [3.0, -1.0]], cfg)
    >>> len(a)  # reps * 2**simhash * dims
    16
    >>> a == encode_query([[3.0, -1.0], [1.0, 2.0]], cfg)
    True
    >>> a == encode_query([[1.0, 2.0], [3.0, -1.0]], {**cfg, "seed": 8})
    False
    """
    return _encode(vectors, config, "query")


def encode_document(vectors, config=None) -> list:
    """Document FDE: vectors average within each partition.

    >>> cfg = {"num_repetitions": 1, "num_simhash_projections": 0, "seed": 7}
    >>> encode_document([[2.0, 4.0], [4.0, 8.0]], cfg)  # one partition: mean
    [3.0, 6.0]
    >>> encode_query([[2.0, 4.0], [4.0, 8.0]], cfg)  # query mode: sum
    [6.0, 12.0]
    """
    return _encode(vectors, config, "document")


def _encode_batch(vector_sets, config, mode: str) -> np.ndarray:
    """Batch encoder: bit-identical to mapping :func:`_encode` over
    ``vector_sets`` (same per-step f64-add / f32-store accumulation order
    within every (set, repetition, partition) group), but with the hashing,
    projections, and partition assignment shared and vectorized across the
    whole batch — per-set Python overhead drops from ~milliseconds to
    microseconds. Raises on the first invalid set, before touching output."""
    if not isinstance(vector_sets, (list, tuple)):
        raise InvalidVector("invalid vectors")
    if len(vector_sets) == 0:
        return np.zeros((0, 0), dtype=np.float32)
    if len(vector_sets) > 2048:
        # bounded working set: scattered accumulation into a multi-GB output
        # block goes cache-hostile; ~2k sets keeps it resident
        return np.concatenate([
            _encode_batch(list(vector_sets[s:s + 2048]), config, mode)
            for s in range(0, len(vector_sets), 2048)
        ])
    arrs = [_prepare_vectors(v) for v in vector_sets]
    dims = arrs[0].shape[1]
    for a in arrs:
        if a.shape[1] != dims:
            raise DimensionMismatch("dimension mismatch")
    cfg = _normalize_config(dict(config or {}), dims)
    reps = cfg["num_repetitions"]
    simhash = cfg["num_simhash_projections"]
    seed = cfg["seed"]
    proj_dim = cfg["projection_dimension"]
    partitions = 1 << simhash
    rep_size = partitions * proj_dim
    identity = proj_dim == dims
    sign_seed = (seed + 17) & U64_MAX

    D = len(arrs)
    lens = np.array([a.shape[0] for a in arrs])
    flat = np.concatenate(arrs, axis=0)  # [sum_T, dims] f64
    set_of = np.repeat(np.arange(D), lens)

    out = np.zeros((D, reps * rep_size), dtype=np.float32)
    rows = np.arange(proj_dim)

    for rep in range(reps):
        if simhash:
            weights = np.stack(
                [_random_weights(seed, rep, p, dims) for p in range(simhash)]
            ).astype(np.float64)
            bits = (flat @ weights.T >= 0.0).astype(np.int64)
            powers = 1 << np.arange(simhash - 1, -1, -1, dtype=np.int64)
            parts = bits @ powers
        else:
            parts = np.zeros(flat.shape[0], dtype=np.int64)
        if identity:
            values_all = flat
        else:
            signs = np.stack(
                [_random_signs(sign_seed, rep, p, dims) for p in range(proj_dim)]
            ).astype(np.float64)
            values_all = flat @ signs.T

        key = set_of * partitions + parts
        order = np.argsort(key, kind="stable")
        key_sorted = key[order]
        first = np.concatenate([[True], key_sorted[1:] != key_sorted[:-1]])
        seg_start = np.maximum.accumulate(
            np.where(first, np.arange(key_sorted.size), 0)
        )
        within = np.arange(key_sorted.size) - seg_start
        base_off = rep * rep_size + parts * proj_dim
        for j in range(int(within.max()) + 1 if within.size else 0):
            sel = order[within == j]
            gather = (set_of[sel][:, None], base_off[sel][:, None] + rows[None, :])
            values = values_all[sel]
            if j == 0:
                # first member of every (set, partition) group lands in
                # untouched zero slots: pure scatter, no gather — this round
                # covers the vast majority of tokens
                if not np.isfinite(values).all() or (np.abs(values) > F32_MAX).any():
                    raise EncodingOverflow("encoding overflow")
                out[gather] = values.astype(np.float32)
                continue
            current = out[gather].astype(np.float64)
            if mode == "query":
                nxt = current + values
            else:
                nxt = current + (values - current) / (j + 1)
            # check the f64 value BEFORE the f32 store (same boundary as the
            # per-set encoder: a value in the half-ULP window above F32_MAX
            # would round down to a finite f32 and escape a post-hoc check)
            if not np.isfinite(nxt).all() or (np.abs(nxt) > F32_MAX).any():
                raise EncodingOverflow("encoding overflow")
            out[gather] = nxt.astype(np.float32)

    final_dim = cfg["final_projection_dimension"]
    if final_dim is not None:
        out = np.stack([_count_sketch(row, final_dim, seed) for row in out])
    return out


def encode_queries(vector_sets, config=None) -> np.ndarray:
    """Batch query FDEs: ``[len(vector_sets), fde_dim]`` float32, row i equal
    to ``encode_query(vector_sets[i], config)``.

    >>> cfg = {"num_repetitions": 1, "num_simhash_projections": 1, "seed": 3}
    >>> batch = encode_queries([[[1.0, 0.0]], [[0.0, 1.0]]], cfg)
    >>> batch.shape
    (2, 4)
    >>> (batch[0] == np.asarray(encode_query([[1.0, 0.0]], cfg),
    ...                         np.float32)).all()
    np.True_
    """
    return _encode_batch(vector_sets, config, "query")


def encode_documents(vector_sets, config=None) -> np.ndarray:
    """Batch document FDEs (running-average accumulation per partition)."""
    return _encode_batch(vector_sets, config, "document")
