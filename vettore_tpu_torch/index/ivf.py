"""IVF approximate index: k-means routing + contiguous-block rescore.

The port of ``vettore_tpu/index/ivf.py``. It fills the same role as HNSW
(sub-linear approximate search, reference hnsw.rs:292-333) with a design
built from dense products instead of pointer-chasing: the build is k-means
(``ops/ivf.py``), a search routes queries to ``n_probe`` contiguous 64-row
blocks and rescores only those through K2 (``ops/flat_scan.rescore``).

Semantics:

* the canonical mirror is an inner :class:`FlatIndex` — validation, exact
  (rank, id) host oracle, and the EXACT search path while the collection is
  below ``min_rows`` (small collections get exact results, the same "index
  defines recall, not correctness" posture as HNSW's recall parity gate);
* mutations after a build go to an exact pending tail (merged with probed
  results by (rank, id)); deletes/replaces of built rows tombstone their
  block slot on the device. The structure rebuilds once pending+tombstoned
  rows exceed ``rebuild_fraction`` of the build;
* with ``n_probe >= n_blocks`` every block is probed and results equal the
  exact fused scan, tie order included (tested).

The index lives on ``device`` (default ``"cuda"``, which needs a CUDA
device; pass ``device="cpu"`` to run on the CPU) and never moves on its own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DimensionMismatch, InvalidIvfOptions, InvalidVector, UnsupportedIvfMetric
from ..metrics import F32_MAX, normalize_metric, rank_value
from ..ops import ivf as ops_ivf
from ..ops.ivf import GROUP, IVF_METRICS
from .base import Index
from .flat import FlatIndex, resolve_device

DEFAULT_OPTIONS = {
    "n_probe": 8,
    "kmeans_iters": 4,
    "storage": "bf16",
    "min_rows": 4096,
    "rebuild_fraction": 0.2,
    "target_recall": 0.95,
}

_MAX_PROBE = 65_536
_MAX_ITERS = 64
#: auto-tune probe ladder (stops at n_blocks); powers of two, as in the JAX
#: package, so both tune to the same probe counts
_AUTO_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
_AUTO_SAMPLE = 64


def validate_options(options: dict | None) -> dict:
    """Strict whitelist validation (the collection option posture,
    reference lib/vettore/index/hnsw.ex:122-173)."""
    options = dict(options or {})
    for key in options:
        if key not in DEFAULT_OPTIONS:
            raise InvalidIvfOptions(f"unknown ivf option: {key!r}")
    merged = {**DEFAULT_OPTIONS, **options}

    def pos_int(v):
        return isinstance(v, int) and not isinstance(v, bool) and v > 0

    np_opt = merged["n_probe"]
    if np_opt != "auto" and not (pos_int(np_opt) and np_opt <= _MAX_PROBE):
        raise InvalidIvfOptions("invalid n_probe")
    tr = merged["target_recall"]
    if not isinstance(tr, (int, float)) or isinstance(tr, bool) or not (
            0.0 < float(tr) <= 1.0):
        raise InvalidIvfOptions("invalid target_recall")
    merged["target_recall"] = float(tr)
    if not (pos_int(merged["kmeans_iters"]) and merged["kmeans_iters"] <= _MAX_ITERS):
        raise InvalidIvfOptions("invalid kmeans_iters")
    if merged["storage"] not in ("f32", "bf16"):
        raise InvalidIvfOptions(f"invalid ivf storage: {merged['storage']!r}")
    if not (pos_int(merged["min_rows"])):
        raise InvalidIvfOptions("invalid min_rows")
    frac = merged["rebuild_fraction"]
    if not isinstance(frac, (int, float)) or isinstance(frac, bool) or not (
            0.0 < float(frac) <= 1.0):
        raise InvalidIvfOptions("invalid rebuild_fraction")
    merged["rebuild_fraction"] = float(frac)
    return merged


class IvfIndex(Index):
    """Inverted-file approximate index over one ranking metric."""

    def __init__(self, metric: str, options: dict | None = None, *, device="cuda"):
        metric = normalize_metric(metric)
        if metric not in IVF_METRICS:
            raise UnsupportedIvfMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.device = resolve_device(device)
        self._mirror = FlatIndex(metric, device=self.device)  # canonical rows + validation
        self._tail: FlatIndex | None = None  # exact pending rows post-build
        self._version = 0
        self._built_version = -1
        #: builds so far: each renumbers the block slots (the collection's
        #: hybrid slot table is keyed by it and ``_version``)
        self._builds = 0
        # built device state (None until a build happens)
        self._xb = None          # [capb, d] storage block, cluster-major
        self._xsq = None         # [capb] f32
        self._bias = None        # [capb] f32 (0 live / +inf dead)
        self._lex = None         # [capb] i32 lex rank at build time
        self._bcb = None         # [ngb, d] bf16 routing centroids
        self._csq = None         # [ngb] f32
        self._bbias = None       # [ngb] f32 (+inf = all-dead block)
        self._block_ids: list = []          # block slot -> id (None = pad/dead)
        self._block_slot_of: dict = {}      # id -> block slot
        self._tombstoned = 0
        #: {"n_probe", "recall_at_10", "target"} after an auto-tune build
        self.tuned: dict | None = None

    @classmethod
    def from_flat(cls, flat: FlatIndex, options: dict | None = None) -> "IvfIndex":
        """Wraps an EXISTING flat index as the canonical mirror — the routing
        structure builds from its already-resident device block (no second
        host→device transfer), on its device. Mutating the flat index
        directly afterwards is undefined; mutate through the returned index
        (benchmark / attach-to-collection path, like FlatIndex.storage_view)."""
        ivf = cls(flat.metric, options, device=flat.device)
        ivf._mirror = flat
        return ivf

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._mirror)

    @property
    def dimension(self):
        return self._mirror.dimension

    @property
    def built(self) -> bool:
        return self._xb is not None

    @property
    def _slot_of(self):
        # id -> mirror slot (the collection's bulk-ingest overlap check and
        # the host oracles address the canonical mirror's namespace)
        return self._mirror._slot_of

    # -- mutation -----------------------------------------------------------

    def _ensure_tail(self) -> FlatIndex:
        if self._tail is None:
            self._tail = FlatIndex(self.metric, device=self.device)
        return self._tail

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs) -> None:
        pairs = [(str(id), v) for id, v in pairs]
        self._mirror.put_many(pairs)  # validates the whole batch first
        if self._xb is not None:
            for id, _v in pairs:
                self._tombstone_built(id)
            self._ensure_tail().put_many(pairs)
        self._version += 1

    def put_matrix(self, ids, matrix) -> None:
        """Bulk ingest (see FlatIndex.put_matrix)."""
        self._mirror.put_matrix(ids, matrix)
        if self._xb is not None:
            self._ensure_tail().put_matrix(ids, matrix)
        self._version += 1

    def delete(self, id: str) -> None:
        id = str(id)
        existed = id in self._mirror._slot_of
        self._mirror.delete(id)
        if not existed:
            return
        self._tombstone_built(id)
        if self._tail is not None:
            self._tail.delete(id)
        if not len(self._mirror):
            self._drop_built()
        self._version += 1

    def _tombstone_built(self, id: str) -> None:
        """Masks a built row out of device results (bias +inf at its block
        slot, in place); the row stays resident until the next rebuild."""
        slot = self._block_slot_of.pop(id, None)
        if slot is None:
            return
        self._bias[slot] = float("inf")
        self._block_ids[slot] = None
        self._tombstoned += 1

    def _drop_built(self) -> None:
        self._xb = self._xsq = self._bias = self._lex = None
        self._bcb = self._csq = self._bbias = None
        self._block_ids = []
        self._block_slot_of = {}
        self._tombstoned = 0
        self._tail = None
        self._built_version = -1

    # -- build --------------------------------------------------------------

    def _device_eligible(self) -> bool:
        n = len(self._mirror)
        return n >= self.params["min_rows"] and n >= 2 * GROUP

    def _stale(self) -> bool:
        if self._xb is None:
            return True
        built = max(1, len(self._block_slot_of))
        pending = (len(self._tail) if self._tail is not None else 0)
        return (pending + self._tombstoned) > max(
            64, int(self.params["rebuild_fraction"] * built))

    def rebuild(self) -> None:
        """Builds the cluster-major device structure from the mirror's
        current live rows (the k-means routing build)."""
        mirror = self._mirror
        mirror._sync_device()
        n_live = len(mirror)
        capb = -(-n_live // GROUP) * GROUP
        # live mirror slots in id (lex) order — the mirror's sync already
        # paid the million-string sort; reuse its cached order
        lex_slots = mirror._lex_order_np[:n_live]
        idx = np.full(capb, -1, dtype=np.int64)
        idx[:n_live] = lex_slots
        idx_dev = torch.from_numpy(idx).to(self.device)

        xs_lex = ops_ivf.gather_lex_rows(mirror._device[0], idx_dev)
        valid_lex = idx_dev >= 0
        ng = capb // GROUP
        assign = ops_ivf.kmeans_assign(
            xs_lex, valid_lex, n_cent=ng, iters=self.params["kmeans_iters"],
            metric=self.metric)
        perm = torch.sort(assign, stable=True).indices  # block slot -> lex position
        xs = xs_lex[perm]
        del xs_lex
        valid_sorted = valid_lex[perm]
        bcb, csq, bbias, xsq, bias = ops_ivf.build_blocks(
            xs, valid_sorted, metric=self.metric)
        # the lex rank of the row in block slot s IS its lex position (live
        # rows were gathered in id order; pads sit past n_live and never win)
        perm_np = perm.cpu().numpy()

        self._xb = xs.to(torch.bfloat16) if self.params["storage"] == "bf16" else xs
        self._xsq = xsq
        self._bias = bias
        self._lex = perm.int()
        self._bcb = bcb
        self._csq = csq
        self._bbias = bbias
        live = np.flatnonzero(perm_np < n_live)
        ids = np.empty(capb, dtype=object)
        ids[live] = [mirror._ids[s] for s in lex_slots[perm_np[live]]]
        self._block_ids = ids.tolist()
        self._block_slot_of = dict(zip(ids[live].tolist(), live.tolist()))
        self._tombstoned = 0
        self._tail = None
        self._built_version = self._version
        self._builds += 1
        if self.params["n_probe"] == "auto":
            self._tune_n_probe()

    def _tune_n_probe(self) -> None:
        """``n_probe="auto"``: picks the smallest probe count whose
        recall@10 on a held-out sample of stored rows (vs the mirror's exact
        scan) meets ``target_recall`` — so the recall gate is a build-time
        property of the actual corpus geometry, not a caller guess. Probed
        rows self-route, so the sample measures neighborhood retrieval
        across block boundaries: the other 9 of each row's top-10."""
        mirror = self._mirror
        n = len(mirror)
        sample = min(_AUTO_SAMPLE, n)
        lex_slots = mirror._lex_order_np[:n]
        pick = lex_slots[np.linspace(0, n - 1, sample).astype(np.int64)]
        queries = mirror._host_x[pick].astype(np.float64)
        k = min(10, n)
        truth = [{id for id, _ in row}
                 for row in mirror.search_batch(queries, k)]
        ngb = max(1, len(self._bcb))
        target = self.params["target_recall"]
        chosen, recall = None, 0.0
        for p in _AUTO_SWEEP:
            if chosen is not None and p > ngb:
                break
            got = self._probed_batch(queries, k, min(p, ngb))
            recall = float(np.mean([
                len({id for _r, id, _ in sorted(row)[:k]} & want)
                / max(len(want), 1)
                for row, want in zip(got, truth)]))
            chosen = min(p, ngb)
            if recall >= target or p >= ngb:
                break
        self.tuned = {"n_probe": chosen, "recall_at_10": round(recall, 4),
                      "target": target}

    def effective_n_probe(self) -> int:
        """The probe count searches actually use (auto resolves at build)."""
        p = self.params["n_probe"]
        if p == "auto":
            return self.tuned["n_probe"] if self.tuned else 8
        return p

    def _ensure_built(self) -> bool:
        """Returns True when the device structure is current and usable."""
        if not self._device_eligible():
            return False
        if self._stale():
            self.rebuild()
        return self._xb is not None

    # -- search -------------------------------------------------------------

    def search(self, query, limit: int) -> list:
        if limit == 0:
            return []
        return self.search_batch(
            np.asarray(query, dtype=np.float64)[None, :], limit)[0]

    def search_batch(self, queries, limit: int) -> list:
        queries = np.asarray(queries, dtype=np.float64)
        if limit == 0 or not len(self._mirror):
            # mirror still validates shape/content
            return self._mirror.search_batch(queries, limit)
        if not self._ensure_built():
            return self._mirror.search_batch(queries, limit)
        # mirror validation posture without a full scan
        self._mirror_validate(queries)
        k = min(limit, len(self._mirror))
        probed = self._probed_batch(queries, k, self.effective_n_probe())
        tail_hits = (
            self._tail.search_batch(queries, limit)
            if self._tail is not None and len(self._tail) else None)
        out = []
        for b in range(queries.shape[0]):
            merged = list(probed[b])
            if tail_hits is not None:
                for id, raw in tail_hits[b]:
                    merged.append((rank_value(self.metric, raw), id, raw))
            merged.sort(key=lambda h: (h[0], h[1]))
            out.append([(id, raw) for _rank, id, raw in merged[:limit]])
        return out

    def _search_built(self, queries_device, k: int, nprobe: int):
        """``ops.ivf.ivf_search`` on the built state: (slots, raws, ranks)."""
        kb = min(max(k, 1), max(len(self._block_slot_of), 1))
        return ops_ivf.ivf_search(
            self._xb, self._xsq, self._bias, self._lex, self._bcb, self._csq,
            self._bbias, queries_device, metric=self.metric, nprobe=nprobe, k=kb)

    def _probed_batch(self, queries: np.ndarray, k: int, nprobe: int) -> list:
        """Device probe + host hydration (no tail merge): per query a list
        of ``(rank, id, raw)`` built-row hits."""
        qdev = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(self.device)
        slots, raws, ranks = (t.cpu().numpy() for t in self._search_built(qdev, k, nprobe))
        out = []
        for b in range(queries.shape[0]):
            hits = []
            for s, raw, rank in zip(slots[b], raws[b], ranks[b]):
                if not np.isfinite(rank):
                    continue
                id = self._block_ids[int(s)]
                if id is not None:
                    hits.append((float(rank), id, float(raw)))
            out.append(hits)
        return out

    def _mirror_validate(self, queries: np.ndarray) -> None:
        if queries.ndim != 2 or queries.shape[1] == 0:
            raise InvalidVector("queries must be a [batch, dims] matrix")
        if self._mirror._dim is not None and queries.shape[1] != self._mirror._dim:
            raise DimensionMismatch("dimension mismatch")
        if queries.size and (not np.isfinite(queries).all()
                             or (np.abs(queries) > F32_MAX).any()):
            raise InvalidVector("vector contains a non-finite value")

    def search_batch_device(self, queries_device, limit: int):
        """Device-to-device serving path: resident [B, d] f32 queries in,
        ``(slots, raws)`` device tensors out — slots index the BLOCK slot
        space (map to ids via ``ids_by_slot``). Pending-tail rows merge on
        the device by (rank, build-time lex); tail slots are encoded past the
        built capacity."""
        if not self._ensure_built():
            return self._mirror.search_batch_device(queries_device, limit)
        k = min(limit, max(len(self._mirror), 1))
        slots, raws, ranks = self._search_built(queries_device, k, self.effective_n_probe())
        if self._tail is None or not len(self._tail):
            return slots, raws
        t_slots, t_raws = self._tail.search_batch_device(queries_device, k)
        kt = min(k, int(t_slots.shape[1]))
        return ops_ivf.merge_with_tail(
            slots, raws, ranks, self._lex[slots.clamp_min(0)],
            t_slots[:, :kt], t_raws[:, :kt],
            metric=self.metric, k=k, capb=int(self._xb.shape[0]))

    def ids_by_slot(self) -> list:
        """Block-slot id vocabulary for device hybrid generators (tail slots
        appended past the built capacity)."""
        vocab = list(self._block_ids)
        if self._tail is not None:
            vocab.extend(self._tail._ids)
        return vocab

    def candidate_slots_device(self, queries_device, count: int):
        """Hybrid-generator path: device ``(slots [B, k], ok [B, k])``; slots
        use the :meth:`ids_by_slot` vocabulary."""
        if not self._ensure_built():
            return self._mirror.candidate_slots_device(queries_device, count)
        slots, raws = self.search_batch_device(queries_device, count)
        return slots, (slots >= 0) & torch.isfinite(raws)

    # hook consumed by collection._VectorCache.index_slot_table
    def hybrid_id_vocab(self):
        if not self._ensure_built():
            return self._mirror._ids
        return self.ids_by_slot()
