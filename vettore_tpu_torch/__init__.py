"""vettore-tpu on PyTorch and CUDA: vector search on an NVIDIA GPU.

The port of the JAX package ``vettore_tpu`` (which stays the reference) to
PyTorch, with hand-written CUDA kernels for the scans. It has the same public
API for the slices ported so far — ``Collection`` with the exact flat,
HNSW and IVF indexes, f32, bf16 and int8 storage, ``compressed=True`` and
the columnar store, the funnel, quantized, multi-vector (exact and MUVERA)
and hybrid search modes, MMR, snapshots, the compat ``DB`` and ``synth`` —
and returns the same results, including the ``(rank, id)`` tie order. The device is explicit: ``device="cuda"`` (the
default) needs a CUDA device; pass ``device="cpu"`` to run on the CPU.

Quick start::

    import vettore_tpu_torch as vt

    col = vt.Collection(name="docs", dimensions=3, index="flat",
                        metric="cosine", device="cuda")
    col.put_many([
        {"id": "east", "vector": [1.0, 0.0, 0.0], "metadata": {"kind": "axis"}},
        {"id": "north", "vector": [0.0, 1.0, 0.0]},
    ])
    results = col.search([1.0, 0.0, 0.0], limit=2)
    funnel = col.funnel_search([1.0, 0.0, 0.0], stages=[2, 3], limit=1)
"""

from . import distance, errors, multi_vector, muvera, observability
from .collection import Collection, load_snapshot
from .compat import DB
from .embedding import Embedding, Result
from .index.flat import FlatIndex
from .index.hnsw import HnswIndex
from .metrics import METRICS, metric_code, normalize_metric, result_values
from .ops.scan_host import binary_top_k, vector_top_k
from .store.memory import MemoryStore

__version__ = "0.1.0"

__all__ = [
    "Collection",
    "DB",
    "load_snapshot",
    "Embedding",
    "Result",
    "FlatIndex",
    "HnswIndex",
    "MemoryStore",
    "METRICS",
    "metric_code",
    "normalize_metric",
    "result_values",
    "vector_top_k",
    "binary_top_k",
    "distance",
    "multi_vector",
    "muvera",
    "observability",
    "errors",
    "__version__",
]
