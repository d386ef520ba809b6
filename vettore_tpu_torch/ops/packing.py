"""Sign-bit packing and packed Hamming/Jaccard distances (host functions).

Mirrors reference native/vettore/src/distances.rs:413-481: signs pack
into u64 words (bit set when value >= 0.0, including -0.0), and packed
distances mask unused bits of the last word. ``pack_signs_u32`` packs rows
as ``uint32`` words (two per u64 word, low word first), the layout the
sign-bit scans read.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidVector
from .distance import validate_vector

U64_MAX = 18_446_744_073_709_551_615


def words_for(dimensions: int) -> int:
    """Number of u64 words for ``dimensions`` sign bits.

    >>> words_for(64)
    1
    >>> words_for(65)
    2
    """
    return (dimensions + 63) // 64


def compress_sign_bits(vector) -> list:
    """Packs vector signs into u64 words (``compress_sign_bits``,
    distances.rs:413-423). Bit ``i % 64`` of word ``i // 64`` is set when
    ``vector[i] >= 0.0``.

    >>> compress_sign_bits([1.0, -2.0, 0.0, -0.5])
    [5]
    >>> compress_sign_bits([-1.0] * 64)
    [0]
    """
    validate_vector(vector)
    v = np.asarray(vector, dtype=np.float64)
    n = v.size
    words = np.zeros(words_for(n), dtype=np.uint64)
    if n:
        bits = (v >= 0.0).astype(np.uint64)
        idx = np.arange(n)
        np.bitwise_or.at(words, idx // 64, bits << (idx % 64).astype(np.uint64))
    return [int(w) for w in words]


def _validate_packed_pair(left, right, dimensions):
    if not isinstance(dimensions, int) or isinstance(dimensions, bool) or dimensions <= 0:
        raise InvalidVector("dimensions must be positive")
    expected = words_for(dimensions)
    for side in (left, right):
        if not isinstance(side, (list, tuple)) or len(side) != expected:
            raise InvalidVector("dimension mismatch")
        for w in side:
            if not isinstance(w, int) or isinstance(w, bool) or not 0 <= w <= U64_MAX:
                raise InvalidVector("invalid packed word")


def _masked_words(words, dimensions) -> np.ndarray:
    out = np.array([int(w) for w in words], dtype=np.uint64)
    rem = dimensions % 64
    if out.size and rem:
        out[-1] &= np.uint64((1 << rem) - 1)
    return out


def packed_hamming(left, right, dimensions: int) -> float:
    """Hamming distance over packed u64 words (distances.rs:426-437).

    >>> packed_hamming([0b1010], [0b0110], 4)
    2.0
    >>> packed_hamming([0xFF], [0x00], 4)  # bits past `dimensions` ignored
    4.0
    """
    _validate_packed_pair(left, right, dimensions)
    a = _masked_words(left, dimensions)
    b = _masked_words(right, dimensions)
    xor = np.bitwise_xor(a, b)
    return float(sum(int(w).bit_count() for w in xor))


def packed_jaccard(left, right, dimensions: int) -> float:
    """Jaccard distance over packed u64 words (distances.rs:440-457).

    >>> packed_jaccard([0b0011], [0b0110], 4)
    0.6666666865348816
    >>> packed_jaccard([0], [0], 4)
    0.0
    """
    _validate_packed_pair(left, right, dimensions)
    a = _masked_words(left, dimensions)
    b = _masked_words(right, dimensions)
    inter = sum(int(w).bit_count() for w in np.bitwise_and(a, b))
    union = sum(int(w).bit_count() for w in np.bitwise_or(a, b))
    if union == 0:
        return 0.0
    return float(np.float32(1.0 - inter / union))


def u32_width(dimensions: int) -> int:
    """uint32 words per packed row: always two per u64 word so the u64 and
    u32 layouts are bit-compatible (high half of a final partial word is
    zero)."""
    return 2 * words_for(dimensions)


def pack_signs_u32(matrix: np.ndarray) -> np.ndarray:
    """Packs the signs of an ``[N, d]`` float matrix into ``[N, u32_width(d)]``
    uint32 words — the device-resident layout for quantized scans. Bit ``j``
    of each word is element ``32*w + j`` (little-endian bit order, one
    ``packbits`` pass)."""
    n, d = matrix.shape
    width = u32_width(d)
    bits = np.zeros((n, width * 32), dtype=bool)
    bits[:, :d] = matrix >= 0.0
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def pack_signs_u64_rows(matrix: np.ndarray) -> np.ndarray:
    """Packs the signs of an ``[N, d]`` float matrix into ``[N, words_for(d)]``
    uint64 words — the batch form of :func:`compress_sign_bits` used by the
    collection insert pipeline. Signs are dtype-independent, so the input is
    packed as-is (no f64 round-trip)."""
    u32 = pack_signs_u32(matrix)
    lo = u32[:, 0::2].astype(np.uint64)
    hi = u32[:, 1::2].astype(np.uint64)
    return lo | (hi << np.uint64(32))
