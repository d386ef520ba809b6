"""Mesh-backed collection indexes: the whole Collection lifecycle on a mesh.

The port of ``vettore_tpu/parallel/collection_mesh.py``. These adapters wrap
:class:`ShardedFlat` / :class:`ShardedHnsw` in the ``Vettore.Index``
behaviour (new/put/put_many/delete/search — lib/vettore/index.ex:12-17), so
a ``Collection(..., mesh=...)`` gets sharded ingest, search,
snapshot/restore (the canonical host store stays the source of truth; the
device shards are always rebuilt from it, README.md:14-16) and mutation:

* ``MeshFlatIndex`` — a host mirror (a :class:`FlatIndex`, which also gives
  the reference's batch-validation semantics) + row-sharded device blocks.
  Deletes flip the shards' validity in place; inserts and replaces reshard
  lazily at the next search.
* ``MeshHnswIndex`` — a host mirror + one graph per shard, mutated in place
  after the first build: puts route to the least-loaded shard and link
  into its graph by one wave, deletes tombstone, and a shard compacts alone
  once its tombstones outgrow ``hnsw_build.REBUILD_FRACTION``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import UnsupportedHnswMetric
from ..index.base import Index
from ..index.flat import FlatIndex
from ..index.hnsw import HNSW_METRICS, validate_options
from ..metrics import normalize_metric, rank_value
from .hnsw_mesh import ShardedHnsw
from .mesh import ShardedFlat


def _host_rows(host: FlatIndex, ids) -> np.ndarray:
    """The mirror's rows of ``ids``, in that order."""
    return host._host_x[np.array([host._slot_of[id] for id in ids], dtype=np.int64)]


class MeshFlatIndex(Index):
    """Flat exact index row-sharded over a mesh."""

    def __init__(self, metric: str, options=None, *, mesh, storage: str = "f32"):
        self._host = FlatIndex(metric, options, device=mesh.first)
        self.metric = self._host.metric
        self.mesh = mesh
        self.device = mesh.first
        self.storage = storage
        self._sharded: ShardedFlat | None = None
        self._built_version = -1
        self._version = 0
        self._mask_dirty: list[str] = []

    def __len__(self):
        return len(self._host)

    @property
    def dimension(self):
        return self._host.dimension

    @property
    def reruns(self) -> int:
        """Shard batches the current shards reran on the plain scan."""
        return self._sharded.reruns if self._sharded is not None else 0

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs) -> None:
        self._host.put_many(pairs)
        self._version += 1
        self._mask_dirty = []  # structural change: full rebuild

    def delete(self, id: str) -> None:
        existed = id in self._host._slot_of
        self._host.delete(id)
        if not existed:
            return
        if self._sharded is not None and self._built_version == self._version:
            # cheap path: flip the validity bits on the devices, no reshard
            self._mask_dirty.append(id)
            self._version += 1
            self._built_version = self._version
        else:
            self._version += 1

    def _sync(self):
        if self._sharded is not None and self._built_version == self._version:
            if self._mask_dirty:
                self._sharded.invalidate_ids(self._mask_dirty)
                self._mask_dirty = []
            return
        host = self._host
        if host._host_x is None or not host._slot_of:
            self._sharded = None
            self._built_version = self._version
            return
        live = sorted(host._slot_of)
        self._sharded = ShardedFlat(self.metric, self.mesh, live, _host_rows(host, live),
                                    storage=self.storage)
        self._built_version = self._version
        self._mask_dirty = []

    def search(self, query, limit: int) -> list:
        return self.search_batch(np.asarray(query, np.float32)[None, :], limit)[0]

    def search_batch(self, queries, limit: int) -> list:
        if limit == 0:
            return [[] for _ in range(len(queries))]
        self._sync()
        if self._sharded is None:
            return [[] for _ in range(len(queries))]
        return self._sharded.search_batch(queries, limit)

    def candidate_slots_device(self, queries_device, count: int):
        """The hybrid's ``search`` generator on the shards (JAX's mesh
        searches query by query on the host): device ``(rows [B, k], ok
        [B, k])``, ``k = min(count, len)``, the exact top ``k`` of each
        query as ``search`` gives them. Rows index ``hybrid_id_vocab``; the
        batch is a multiple of the mesh's ``data``."""
        self._sync()
        if self._sharded is None:
            empty = torch.zeros((queries_device.shape[0], 1), dtype=torch.int32,
                                device=self.device)
            return empty, empty.bool()
        rows, _raws = self._sharded.search_device(queries_device,
                                                  min(count, self._sharded.n))
        return rows.clamp_min(0), rows >= 0

    def hybrid_id_vocab(self) -> list:
        """The id of each row ``candidate_slots_device`` returns (the built
        shards' ids, in id order)."""
        self._sync()
        return self._sharded.ids if self._sharded is not None else []


class MeshHnswIndex(Index):
    """HNSW sharded over a mesh, mutated incrementally in place.

    The first search bulk-builds one graph per shard. Every put or delete
    after that build mutates the owning shard's graph through the
    single-device machinery (``hnsw_build.incremental_put`` /
    ``incremental_delete``, hnsw.rs:152-289 semantics): new records route to
    the least-loaded shard and link through one wave, and only that shard's
    planes are re-sent — there is no full-mesh rebuild on the ingest path.
    Deletes tombstone; a shard compacts alone once its tombstones outgrow
    ``hnsw_build.REBUILD_FRACTION``."""

    def __init__(self, metric: str, options=None, *, mesh):
        metric = normalize_metric(metric)
        if metric not in HNSW_METRICS:
            raise UnsupportedHnswMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        self.device = mesh.first
        self._host = FlatIndex(metric, device=mesh.first)  # mirror + validation
        self._sharded: ShardedHnsw | None = None

    def __len__(self):
        return len(self._host)

    @property
    def dimension(self):
        return self._host.dimension

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs) -> None:
        pairs = [(str(id), v) for id, v in pairs]
        self._host.put_many(pairs)  # batch-validates before any mutation
        if self._sharded is not None:
            ids = [id for id, _ in pairs]
            self._sharded.incremental_put(ids, _host_rows(self._host, ids))

    def delete(self, id: str) -> None:
        self._host.delete(id)
        if self._sharded is not None:
            self._sharded.incremental_delete([str(id)])

    def _ensure_built(self):
        if self._sharded is not None:
            return
        live = sorted(self._host._slot_of)
        if live:
            self._sharded = ShardedHnsw(self.metric, self.mesh, live,
                                        _host_rows(self._host, live), options=self.params)

    def search(self, query, limit: int) -> list:
        return self.search_batch(np.asarray(query, np.float32)[None, :], limit)[0]

    def search_batch(self, queries, limit: int) -> list:
        queries = np.asarray(queries, dtype=np.float32)
        if limit == 0 or not self._host._slot_of:
            return [[] for _ in range(len(queries))]
        self._ensure_built()
        hits = self._sharded.search_batch(queries, limit)
        # the (rank, id) order is already exact across shards; re-rank on
        # the host only to fold in rank_value for the caller
        out = []
        for qi in range(len(queries)):
            merged = sorted((rank_value(self.metric, raw), id, raw) for id, raw in hits[qi])
            out.append([(id, raw) for _, id, raw in merged[:limit]])
        return out
