"""HNSW approximate-nearest-neighbor index.

The port of ``vettore_tpu/index/hnsw.py``. Graph semantics mirror the Rust
reference's ``hnsw.rs``:

* deterministic seedless level assignment from an FNV-1a hash of the external
  id, P(level+1) = 1/4 per step, capped at ``max_level`` (hnsw.rs:473-497);
  :func:`levels_batch` computes the same levels for many ids at once in
  numpy, bit for bit;
* insert: greedy descent on upper layers, ``search_layer`` with an
  ``ef_construction`` beam per layer, neighbor truncation to m/m0 by
  (distance, id), reciprocal edge insertion *after* the node exists followed
  by pruning (the documented ordering bug-fix, hnsw.rs:220-236);
* delete: removes the node and all incoming edges; deterministic entry
  re-election by (layer desc, id asc) (hnsw.rs:263-289);
* search: greedy to layer 1, beam at layer 0 with ``ef = max(ef_search,
  limit)``, results sorted by (distance, external id), raw metric recomputed
  per hit (hnsw.rs:292-333).

The host graph (this file) is the canonical, incrementally-mutable structure
and the correctness oracle. The batched beam search on the index's device
lives in ``hnsw_device.py``; a cold ingest of ``BULK_THRESHOLD`` rows or more
builds the graph on the device (``hnsw_build.py``: the kNN build from
``KNN_BUILD_MIN`` rows, the wave build below it), and a bulk graph then takes
``put`` / ``put_many`` / ``put_matrix`` / ``delete`` on the device
(``hnsw_build.incremental_put`` / ``incremental_delete``, compaction once a
quarter of its slots are tombstones); :meth:`HnswIndex.save_graph` /
:meth:`HnswIndex.load_graph` cache a bulk graph in the JAX package's file
format.
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from ..errors import (
    DimensionMismatch,
    InvalidHnswOptions,
    InvalidVector,
    UnsupportedHnswMetric,
    VettoreError,
)
from ..metrics import normalize_metric
from ..observability import span
from .base import Index
from .flat import resolve_device

DEFAULT_OPTIONS = {
    "m": 16,
    "m0": 32,
    "ef_construction": 100,
    "ef_search": 64,
    "max_level": 12,
    # device extension: beam entries expanded per traversal iteration.
    # Narrower = cheaper steps (W * m0 neighbor gathers), wider = more
    # exploration per step at the same ef (recall can only rise with W at
    # fixed ef).
    "expand_w": 8,
    # device extension: bulk-construction algorithm. "knn" = cluster-blocked
    # kNN assembly (dense matrix products, hnsw_knn_build.py); "wave" =
    # batched insertion waves (hnsw_build.py); "auto" picks knn at scale.
    "build": "auto",
}

BUILD_MODES = ("auto", "knn", "wave")

_MAX_M = 1_024
_MAX_M0 = 2_048
_MAX_EF = 1_000_000
_MAX_LEVEL = 64

HNSW_METRICS = ("l2", "cosine", "inner_product")


#: device extension: traversal precision. "bf16" (default) gathers and
#: scores a bfloat16 copy during beam selection — half the device-memory
#: bytes of the random gathers — while final result ordering is always exact
#: f32 (rank, id). "f32" traverses at full precision.
TRAVERSAL_MODES = ("bf16", "f32")


def validate_options(options: dict | None) -> dict:
    """Validates HNSW parameters (hnsw.rs:25-49, index/hnsw.ex:122-173)."""
    options = dict(options or {})
    traversal = options.pop("traversal", "bf16")
    if traversal not in TRAVERSAL_MODES:
        raise InvalidHnswOptions(f"invalid traversal mode: {traversal!r}")
    for key in options:
        if key not in DEFAULT_OPTIONS:
            raise InvalidHnswOptions(f"unknown hnsw option: {key!r}")
    options["traversal"] = traversal
    merged = {**DEFAULT_OPTIONS, **options}
    m, m0 = merged["m"], merged["m0"]
    efc, efs = merged["ef_construction"], merged["ef_search"]
    max_level = merged["max_level"]

    def pos_int(v):
        return isinstance(v, int) and not isinstance(v, bool) and v > 0

    if not (pos_int(m) and m <= _MAX_M and pos_int(m0) and m <= m0 <= _MAX_M0):
        raise InvalidHnswOptions("invalid hnsw degree")
    if not (pos_int(efc) and m <= efc <= _MAX_EF):
        raise InvalidHnswOptions("invalid ef_construction")
    if not (pos_int(efs) and efs <= _MAX_EF):
        raise InvalidHnswOptions("invalid ef_search")
    if not (pos_int(max_level) and max_level <= _MAX_LEVEL):
        raise InvalidHnswOptions("invalid max_level")
    if not (pos_int(merged["expand_w"]) and merged["expand_w"] <= 256):
        raise InvalidHnswOptions("invalid expand_w")
    if merged["build"] not in BUILD_MODES:
        raise InvalidHnswOptions(f"invalid build mode: {merged['build']!r}")
    return merged


def fnv1a_64(data: bytes) -> int:
    """FNV-1a, bit-identical to hnsw.rs:489-497."""
    h = 0xCBF2_9CE4_8422_2325
    for byte in data:
        h ^= byte
        h = (h * 0x0000_0100_0000_01B3) & 0xFFFF_FFFF_FFFF_FFFF
    return h


def level_for(external_id: str, max_level: int) -> int:
    """Deterministic pseudo-random layer from the id hash (hnsw.rs:473-481)."""
    h = fnv1a_64(external_id.encode("utf-8"))
    level = 0
    while level < max_level and (h & 0b11) == 0:
        level += 1
        h >>= 2
    return level


_FNV_OFFSET = np.uint64(0xCBF2_9CE4_8422_2325)
_FNV_PRIME = np.uint64(0x0000_0100_0000_01B3)


def levels_batch(ids, max_level: int) -> np.ndarray:
    """:func:`level_for` of every id in ``ids``, as int32, in numpy: FNV-1a
    over the ids' UTF-8 bytes one byte position at a time (uint64 products
    wrap modulo 2**64, as the scalar version masks them), then the level
    loop on all hashes together."""
    encoded = [str(i).encode("utf-8") for i in ids]
    n = len(encoded)
    lengths = np.fromiter(map(len, encoded), dtype=np.int64, count=n)
    width = int(lengths.max()) if n else 0
    # null-padded rows of bytes; a row's own length says where it ends
    raw = np.array(encoded, dtype=f"S{max(width, 1)}").view(np.uint8).reshape(n, max(width, 1))
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(width):
            live = lengths > j
            h = np.where(live, (h ^ raw[:, j].astype(np.uint64)) * _FNV_PRIME, h)
    levels = np.zeros(n, dtype=np.int32)
    for _ in range(max_level):
        up = (h & np.uint64(3)) == 0
        if not up.any():
            break
        levels += up
        h = np.where(up, h >> np.uint64(2), h)
    return levels


class HnswIndex(Index):
    """Hierarchical navigable small-world graph over one ranking metric."""

    def __init__(self, metric: str, options: dict | None = None, *, device="cuda"):
        metric = normalize_metric(metric)
        if metric not in HNSW_METRICS:
            raise UnsupportedHnswMetric(metric)
        self.metric = metric
        #: where the device graph lives and the batched beam runs; ``"cuda"``
        #: needs a CUDA device and never switches to the CPU on its own
        self.device = resolve_device(device)
        self.params = validate_options(options)
        self.traversal = self.params["traversal"]
        self._vectors: dict[int, np.ndarray] = {}
        self._external: dict[int, str] = {}
        self._levels: dict[int, int] = {}
        self._connections: dict[int, list] = {}  # internal id -> [layer][neighbor ids]
        self._internal: dict[str, int] = {}
        self._entry: int | None = None
        self._next = 0
        self._dim: int | None = None
        self._device = None  # built lazily by hnsw_device
        self._device_version = -1
        self._version = 0
        self._bulk = None  # BulkGraph when bulk-built on the device

    #: batches at least this large on an empty index are bulk-built on the
    #: device instead of inserted one by one on the host
    BULK_THRESHOLD = 20_000

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        if self._bulk is not None:
            return self._bulk.live
        return len(self._internal)

    @property
    def dimension(self):
        return self._dim

    # -- distances ----------------------------------------------------------

    def _rank(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.metric == "l2":
            return float(np.sqrt(np.sum((a - b) ** 2)))
        dot = float(a @ b)
        return 1.0 - dot if self.metric == "cosine" else -dot

    def _rank_to_neighbors(self, q: np.ndarray, neighbor_ids: list) -> np.ndarray:
        rows = np.stack([self._vectors[i] for i in neighbor_ids])
        if self.metric == "l2":
            return np.sqrt(np.sum((rows - q) ** 2, axis=1))
        dots = rows @ q
        return 1.0 - dots if self.metric == "cosine" else -dots

    def _raw(self, a: np.ndarray, b: np.ndarray) -> float:
        if self.metric == "l2":
            return float(np.float32(math.sqrt(float(np.sum((a - b) ** 2)))))
        return float(np.float32(a @ b))

    # -- validation ---------------------------------------------------------

    def _validate(self, vector) -> np.ndarray:
        try:
            arr = np.asarray(vector, dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise InvalidVector("vector must be numeric") from exc
        if arr.ndim != 1 or arr.size == 0:
            raise InvalidVector("vector must not be empty")
        if self._dim is not None and arr.size != self._dim:
            raise DimensionMismatch("dimension mismatch")
        if not np.isfinite(arr).all():
            raise InvalidVector("vector contains a non-finite value")
        return arr

    # -- mutation -----------------------------------------------------------

    def put(self, id: str, vector) -> None:
        arr = self._validate(vector)
        if self._bulk is not None:
            self._mutate_bulk([str(id)], arr[None, :].astype(np.float32))
        else:
            self._insert(str(id), arr)
        self._version += 1

    def put_many(self, pairs) -> None:
        batch = []
        expected = self._dim
        for id, vector in pairs:
            try:
                arr = np.asarray(vector, dtype=np.float64)
            except (TypeError, ValueError) as exc:
                raise InvalidVector("vector must be numeric") from exc
            if arr.ndim != 1 or arr.size == 0:
                raise InvalidVector("vector must not be empty")
            if expected is None:
                expected = arr.size
            if arr.size != expected:
                raise DimensionMismatch("dimension mismatch")
            if not np.isfinite(arr).all():
                raise InvalidVector("vector contains a non-finite value")
            batch.append((str(id), arr))
        if self._bulk is not None:
            if batch:
                self._mutate_bulk([id for id, _ in batch],
                                  np.stack([arr for _, arr in batch]).astype(np.float32))
                self._version += 1
            return
        if not self._vectors and len(batch) >= self.BULK_THRESHOLD:
            # duplicate ids keep the last occurrence, matching the replace
            # semantics of sequential insert
            last = dict(batch)
            ids = list(last)
            # one f32 copy of the vectors, filled row by row (no f64 stack)
            self._bulk_build(ids, np.stack([last[i] for i in ids], dtype=np.float32))
            return
        for id, arr in batch:
            self._insert(id, arr)
        if batch:
            self._version += 1

    def put_matrix(self, ids, matrix) -> None:
        """Bulk ingest of an [n, d] matrix with one row per id (the path of
        ``Collection.put_matrix``): the same result as ``put_many`` of its
        rows, with the matrix validated as a whole and handed on as one f32
        block (no per-row Python) to the bulk build, on an empty index of
        ``BULK_THRESHOLD`` distinct ids or more, or to the bulk graph's
        incremental put."""
        ids = [str(i) for i in ids]
        matrix = np.asarray(matrix)
        if matrix.ndim != 2 or matrix.shape[0] != len(ids):
            raise InvalidVector("matrix must be [n, d] with one row per id")
        cold = (self._bulk is None and not self._vectors and len(ids) >= self.BULK_THRESHOLD
                and len(set(ids)) == len(ids))
        if not ids or matrix.shape[1] == 0 or not (cold or self._bulk is not None):
            self.put_many(zip(ids, matrix))
            return
        try:
            finite = np.isfinite(matrix).all()
        except TypeError as exc:
            raise InvalidVector("vector must be numeric") from exc
        if not finite:
            raise InvalidVector("vector contains a non-finite value")
        if cold:
            self._bulk_build(ids, np.ascontiguousarray(matrix, dtype=np.float32))
            return
        if matrix.shape[1] != self._dim:
            raise DimensionMismatch("dimension mismatch")
        self._mutate_bulk(ids, np.ascontiguousarray(matrix, dtype=np.float32))
        self._version += 1

    def _bulk_build(self, ids, vectors):
        """Device construction for large cold-start ingests (see
        hnsw_build.py) of ``vectors`` [n, d] f32, one row per distinct id."""
        from . import hnsw_build

        self._bulk = hnsw_build.bulk_build(self.metric, self.params, ids, vectors,
                                           device=self.device)
        self._dim = vectors.shape[1]
        self._version += 1
        self._device = self._bulk
        self._device_version = self._version

    def bulk_ingest_device(self, ids, x_device) -> None:
        """Bulk-builds the graph from a device-resident [n, d] f32 block on
        the index's device, in ``ids`` order (e.g. a flat index's block) — no
        host-to-device transfer. Only valid on an empty index."""
        from . import hnsw_build

        if self._bulk is not None or self._vectors:
            raise VettoreError("bulk_ingest_device requires an empty index",
                               reason="not_empty")
        if x_device.device.type != self.device.type:
            raise ValueError(f"x_device is on {x_device.device}, the index on {self.device}")
        self._bulk = hnsw_build.bulk_build(self.metric, self.params, [str(i) for i in ids],
                                           x_device=x_device)
        self._dim = int(x_device.shape[1])
        self._version += 1
        self._device = self._bulk
        self._device_version = self._version

    def save_graph(self, path: str, *, include_x: bool = True) -> None:
        """Serializes the device graph as a rebuildable acceleration cache
        (see ``hnsw_build.save_graph``). Only bulk-built graphs serialize —
        a host-incremental graph is already cheap to reconstruct."""
        if self._bulk is None:
            raise VettoreError("only bulk-built graphs can be saved", reason="not_bulk_built")
        from . import hnsw_build

        hnsw_build.save_graph(self._bulk, path, include_x=include_x)

    @classmethod
    def load_graph(cls, metric: str, options: dict | None, path: str, *,
                   x_device=None, device="cuda") -> "HnswIndex":
        """Builds an index on ``device`` around a graph saved by
        :meth:`save_graph` (this package's or the JAX package's).
        ``x_device`` optionally shares an existing ``[n, d]`` f32 block on
        ``device`` (graph slot order) instead of reading the file's."""
        from . import hnsw_build

        index = cls(metric, options, device=device)
        graph = hnsw_build.load_graph(path, x_device=x_device, device=index.device)
        if graph.metric != index.metric:
            raise UnsupportedHnswMetric(
                f"graph metric {graph.metric!r} != index metric {index.metric!r}")
        index._bulk = graph
        index._dim = int(graph.x.shape[1])
        index._version += 1
        index._device = graph
        index._device_version = index._version
        return index

    def _mutate_bulk(self, ids, vecs) -> None:
        """Incremental insert/replace of ``ids`` with rows ``vecs`` [B, d]
        f32 into the bulk-built device graph: new slots append through the
        build's wave step, replaced ids tombstone
        (``hnsw_build.incremental_put``) — no O(n) host hydration."""
        from . import hnsw_build

        hnsw_build.incremental_put(self._bulk, self.params, ids, vecs)
        self._dim = int(self._bulk.x.shape[1])
        if hnsw_build.should_compact(self._bulk):
            self._compact_bulk()

    def _compact_bulk(self) -> None:
        from . import hnsw_build

        graph = hnsw_build.compact(self._bulk, self.params)
        self._bulk = graph
        self._device = graph
        if graph is None:
            self._dim = None
            self._device_version = -1

    def _insert(self, external_id: str, vector: np.ndarray) -> None:
        if external_id in self._internal:
            self.delete(external_id)

        internal = self._next
        self._next += 1
        level = level_for(external_id, self.params["max_level"])
        vec = vector.astype(np.float64)

        if not self._vectors:
            self._vectors[internal] = vec
            self._external[internal] = external_id
            self._levels[internal] = level
            self._connections[internal] = [[] for _ in range(level + 1)]
            self._internal[external_id] = internal
            self._entry = internal
            self._dim = vec.size
            return

        entry = self._entry
        top_layer = self._levels[entry]
        for layer in range(top_layer, level, -1):
            entry = self._greedy_closest(entry, vec, layer)

        new_connections = [[] for _ in range(level + 1)]
        for layer in range(min(level, top_layer), -1, -1):
            candidates = self._search_layer(entry, vec, layer, self.params["ef_construction"])
            candidates.sort(key=lambda c: (c[0], c[1]))
            seen = set()
            deduped = []
            for dist, nid in candidates:
                if nid not in seen:
                    seen.add(nid)
                    deduped.append((dist, nid))
            limit = self.params["m0"] if layer == 0 else self.params["m"]
            deduped = deduped[:limit]
            new_connections[layer] = [nid for _, nid in deduped]
            if deduped:
                entry = deduped[0][1]

        self._vectors[internal] = vec
        self._external[internal] = external_id
        self._levels[internal] = level
        self._connections[internal] = new_connections
        self._internal[external_id] = internal
        self._dim = vec.size

        # reciprocal edges AFTER the node exists, then prune (hnsw.rs:220-236)
        for layer, neighbors in enumerate(new_connections):
            for nid in neighbors:
                conns = self._connections.get(nid)
                if conns is not None and layer < len(conns) and internal not in conns[layer]:
                    conns[layer].append(internal)
                self._prune(nid, layer)

        if level > self._levels[self._entry]:
            self._entry = internal

    def delete(self, external_id: str) -> None:
        if self._bulk is not None:
            from . import hnsw_build

            removed = hnsw_build.incremental_delete(self._bulk, [str(external_id)])
            if removed:
                self._version += 1
                if self._bulk.live == 0:
                    self._bulk = None
                    self._device = None
                    self._device_version = -1
                    self._dim = None
                elif hnsw_build.should_compact(self._bulk):
                    self._compact_bulk()
            return
        internal = self._internal.pop(str(external_id), None)
        if internal is None:
            return
        del self._vectors[internal]
        del self._external[internal]
        del self._levels[internal]
        del self._connections[internal]
        for conns in self._connections.values():
            for layer in conns:
                if internal in layer:
                    layer[:] = [i for i in layer if i != internal]
        if self._entry == internal:
            # highest layer wins; ties pick the smallest external id
            self._entry = min(
                self._levels,
                key=lambda i: (-self._levels[i], self._external[i]),
                default=None,
            ) if self._levels else None
        if not self._vectors:
            self._dim = None
        self._version += 1

    # -- traversal ----------------------------------------------------------

    def _greedy_closest(self, start: int, query: np.ndarray, layer: int) -> int:
        current = start
        current_dist = self._rank(self._vectors[current], query)
        while True:
            conns = self._connections.get(current)
            if conns is None or layer >= len(conns) or not conns[layer]:
                break
            neighbor_ids = [i for i in conns[layer] if i in self._vectors]
            if not neighbor_ids:
                break
            dists = self._rank_to_neighbors(query, neighbor_ids)
            best = int(np.argmin(dists))
            if dists[best] < current_dist:
                current = neighbor_ids[best]
                current_dist = float(dists[best])
            else:
                break
        return current

    def _search_layer(self, entry: int, query: np.ndarray, layer: int, ef: int) -> list:
        """Beam exploration with candidate and bounded-result heaps
        (hnsw.rs:375-434). Returns [(rank_dist, internal_id)]."""
        if entry not in self._vectors:
            return []
        dist = self._rank(self._vectors[entry], query)
        visited = {entry}
        candidates = [(dist, entry)]  # min-heap by (dist, id)
        results = [(-dist, entry)]  # max-heap of worst-first via negation
        while candidates:
            current_dist, current = heapq.heappop(candidates)
            worst = -results[0][0] if results else math.inf
            if len(results) >= ef and current_dist > worst:
                break
            conns = self._connections.get(current)
            if conns is None or layer >= len(conns):
                continue
            fresh = [i for i in conns[layer] if i not in visited and i in self._vectors]
            visited.update(conns[layer])
            if not fresh:
                continue
            dists = self._rank_to_neighbors(query, fresh)
            for nid, ndist in zip(fresh, dists):
                ndist = float(ndist)
                worst = -results[0][0] if results else math.inf
                if len(results) < ef or ndist < worst:
                    heapq.heappush(candidates, (ndist, nid))
                    heapq.heappush(results, (-ndist, nid))
                    if len(results) > ef:
                        heapq.heappop(results)
        return [(-negdist, nid) for negdist, nid in results]

    def _prune(self, node_id: int, layer: int) -> None:
        limit = self.params["m0"] if layer == 0 else self.params["m"]
        conns = self._connections.get(node_id)
        if conns is None or layer >= len(conns) or len(conns[layer]) <= limit:
            if conns is not None and layer < len(conns):
                conns[layer] = [i for i in conns[layer] if i in self._vectors]
            return
        vector = self._vectors[node_id]
        alive = [i for i in conns[layer] if i in self._vectors]
        if not alive:
            conns[layer] = []
            return
        dists = self._rank_to_neighbors(vector, alive)
        scored = sorted(zip(dists, alive), key=lambda c: (c[0], c[1]))
        conns[layer] = [nid for _, nid in scored[:limit]]

    # -- search -------------------------------------------------------------

    @span("index.search")
    def search(self, query, limit: int) -> list:
        if limit == 0:
            return []
        with span("index.validate"):
            arr = self._validate(query)
        if self._bulk is None and self._entry is None:
            return []
        if self._use_device():
            from . import hnsw_device

            return hnsw_device.search(self, arr[None, :], limit)[0]
        return self._search_host(arr, limit)

    @span("index.search_batch")
    def search_batch(self, queries, limit: int) -> list:
        with span("index.validate"):
            queries = np.asarray(queries, dtype=np.float64)
            if limit == 0:
                return [[] for _ in range(queries.shape[0])]
            for q in queries:
                self._validate(q)
        if self._bulk is None and self._entry is None:
            return [[] for _ in range(queries.shape[0])]
        if self._use_device():
            from . import hnsw_device

            return hnsw_device.search(self, queries, limit)
        return [self._search_host(q, limit) for q in queries]

    def search_batch_device(self, queries_device, limit: int):
        """Device-to-device beam search: resident [B, d] f32 queries in,
        (slots [B, limit] int64, raws [B, limit] f32) tensors out on the
        index's device — no host transfer (serving path)."""
        from . import hnsw_device

        return hnsw_device.search_tensors(self, queries_device, limit)

    def candidate_slots_device(self, queries_device, count: int):
        """Hybrid-generator path: ``(slots [B, k] int64, ok [B, k] bool)``
        on the index's device, ``ok`` masking the beam's -1 pads. Slots index
        the device graph's slot order (its ``ids`` map them to external
        ids)."""
        slots, raws = self.search_batch_device(queries_device, count)
        return slots, (slots >= 0) & torch.isfinite(raws)

    def _use_device(self) -> bool:
        # bulk graphs only exist on the device; otherwise the batched beam
        # pays off past a few thousand nodes
        return self._bulk is not None or len(self._internal) >= 2048

    def _search_host(self, query: np.ndarray, limit: int) -> list:
        entry = self._entry
        top_layer = self._levels[entry]
        for layer in range(top_layer, 0, -1):
            entry = self._greedy_closest(entry, query, layer)
        ef = max(self.params["ef_search"], limit)
        best = self._search_layer(entry, query, 0, ef)
        best.sort(key=lambda c: (c[0], self._external.get(c[1], "")))
        out = []
        for _dist, nid in best[:limit]:
            vec = self._vectors[nid]
            out.append((self._external[nid], self._raw(query, vec)))
        return out
