"""The least time of one call of the binary-quantized cell on one H100, from
``roofline.PEAKS``.

The least work counts what the search has to do, not how the program lays
it out: the Hamming stage compares ``b`` queries' sign bits with ``n`` rows
of ``d`` bits, ``2 * b * n * d`` operations at the int8 tensor-core peak
(the program's K6 reads ±1 int8 signs, a byte a bit), against the packed
bits, ``n * d / 8`` bytes, read once at the HBM peak. A call adds the
rescore: the ``c`` candidates' float32 rows of each query, ``b * c * d * 4``
bytes read once, and ``2 * b * c * d`` operations at the TF32 peak, the
ceiling of any product accurate to float32. The selections, the hydration
and the host's work add to both, so a share this bounds is an upper bound
of the call's."""

from __future__ import annotations

from benchmark.roofline import PEAKS


def _larger(t_ops: float, t_bytes: float):
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hamming(b: int, n: int, d: int):
    """``(seconds, "operations" | "bytes")``: the Hamming stage's bound."""
    return _larger(2.0 * b * n * d / PEAKS["int8"], n * d / 8 / PEAKS["hbm"])


def least_call(b: int, n: int, d: int, c: int):
    """``(seconds, "operations" | "bytes")``: the larger bound of one call."""
    t_ops = 2.0 * b * n * d / PEAKS["int8"] + 2.0 * b * c * d / PEAKS["tf32"]
    t_bytes = (n * d / 8 + b * c * d * 4) / PEAKS["hbm"]
    return _larger(t_ops, t_bytes)
