"""Host-side bf16 rounding, the counterpart of ``vettore_tpu/ops/transport.py``.

Only :func:`round_to_bf16` is carried over: the JAX module's other
functions move arrays over a TPU host link, which a CUDA card does not
need. The rounding is the formula itself in u32 arithmetic, not a cast:
a cast's NaN and overflow behaviour is the library's, the formula's is
fixed (``F32_MAX`` rounds to +inf, a NaN's payload carries into the high
half).
"""

from __future__ import annotations

import numpy as np


def round_to_bf16(mat: np.ndarray) -> np.ndarray:
    """Rounds an f32 array to its nearest-even bf16-representable value
    (for data generators that opt into compact transport)."""
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    bits = mat.view(np.uint32)
    # round-to-nearest-even on the high half
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return rounded.view(np.float32)
