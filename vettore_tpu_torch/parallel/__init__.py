"""Mesh sharding: a collection larger than one card shards across a grid of
devices (``make_mesh``), with query batches split by data row and an exact
(rank, id) merge of the shards' candidates (SURVEY §5.8). The port of
``vettore_tpu.parallel``: one process drives every shard, and each shard's
search runs the hand kernels on its own device."""

from .collection_mesh import MeshFlatIndex, MeshHnswIndex
from .hnsw_mesh import ShardedHnsw
from .mesh import ShardedFlat, make_mesh, sharded_search

__all__ = [
    "MeshFlatIndex",
    "MeshHnswIndex",
    "ShardedFlat",
    "ShardedHnsw",
    "make_mesh",
    "sharded_search",
]
