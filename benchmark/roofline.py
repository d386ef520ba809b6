"""Published peaks of one NVIDIA H100 and the least time of the exact scan.

Peaks are NVIDIA's data-sheet rates for the H100 SXM5 (80 GB HBM3), dense,
at its full 700 W power limit: a card set to a lower limit runs below them,
so every share is printed beside the card's power limit.
"""

from __future__ import annotations

PEAKS = {
    "f32": 67e12,      # FLOP/s outside the tensor cores
    "tf32": 495e12,    # FLOP/s, tensor cores
    "bf16": 989e12,    # FLOP/s, tensor cores
    "int8": 1979e12,   # OP/s, tensor cores
    "hbm": 3.35e12,    # bytes/s
}


def exact_scan(b: int, n: int, d: int, k: int, elem_bytes: int = 4):
    """The least seconds an exact top-``k`` scan of ``b`` queries over ``n``
    rows of width ``d`` can take on one card, and what bounds it.

    Operations: ``2 * b * n * d`` at the TF32 peak, the ceiling of any
    product accurate to float32 (a split into bf16 or int8 products needs
    three or more of them). Bytes: the rows read once, the queries read
    once, ``k`` (slot, score) pairs of 8 + 4 bytes written per query.
    Returns ``(seconds, "operations" | "bytes")``."""
    t_ops = 2.0 * b * n * d / PEAKS["tf32"]
    t_bytes = (n * d * elem_bytes + b * d * 4 + b * k * 12) / PEAKS["hbm"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
