"""A falsifiable cost model for the sharded candidate merges.

The port of ``vettore_tpu/parallel/cost.py``. The sharded searches merge
per-shard top-k candidate sets by gathering their planes onto the data
row's first device (``mesh.Mesh.gather``, the counterpart of
``all_gather(..., "shard", tiled=True)``). ``expected_merge_bytes`` states
the bytes one such merge gathers; ``gathered_bytes`` counts what the gather
helper actually gathered during one call, per data row, and the tests hold
the two equal.

Model (``parallel/mesh.py::sharded_search``): each shard emits ``k``
candidates per query as four planes — rank f32, lex rank, global slot, raw
f32 — so one data row's batch of ``b`` queries gathers

    bytes = 4 planes * b * (S * k) * 4 B

The lex and slot planes are int32, as JAX's are: torch's default int64
indices would double those two planes.
"""

from __future__ import annotations


def expected_merge_bytes(n_shards: int, b_local: int, k: int,
                         planes: int = 4, itemsize: int = 4) -> int:
    """Modelled per-chip ICI bytes for one sharded top-k merge."""
    return planes * b_local * n_shards * k * itemsize


def gathered_bytes(mesh, fn, *args, **kwargs) -> int:
    """The bytes ``mesh``'s merges gathered during one call of ``fn``, per
    data row (each row gathers onto its own first device)."""
    before = mesh.gathered_bytes
    fn(*args, **kwargs)
    return (mesh.gathered_bytes - before) // mesh.shape["data"]
