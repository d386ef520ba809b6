"""The least time of one call of the ColBERT hybrid cell on one H100, from
``roofline.PEAKS``.

A call reranks at least ``c`` candidates a query (one generator's count: a
union is never smaller), so the least work is the MaxSim of ``b`` query
sets of ``q`` tokens over ``c`` documents of ``t`` tokens of width ``d``:
the candidates' bf16 tokens read once, the quantized generator's sign
block (a bit a value of ``n`` primary rows) read once and the float32
queries (``q`` tokens and a primary row each) read once, at the HBM peak;
``2 * b * c * q * t * d`` operations at the TF32 peak, the ceiling of any
product accurate to float32. The HNSW beam, the union and MMR add to
both, so the share this bounds is an upper bound of the call's."""

from __future__ import annotations

from benchmark.roofline import PEAKS


def least_call(b: int, c: int, q: int, t: int, d: int, n: int, elem_bytes: int = 2):
    """``(seconds, "operations" | "bytes")``: the larger bound of one call."""
    t_ops = 2.0 * b * c * q * t * d / PEAKS["tf32"]
    t_bytes = (b * c * t * d * elem_bytes + n * d / 8 + b * (q + 1) * d * 4) / PEAKS["hbm"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
