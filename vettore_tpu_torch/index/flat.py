"""Exact flat index: device-resident vector block + fused scan/top-k.

The port of ``vettore_tpu/index/flat.py``: vectors live in one device
``[cap, d]`` block (f32, bf16, or int8 with per-row f32 scales) with a
validity mask; a search is one batched scan — the fused group-min kernels
(``ops/flat_scan.py``) at capacities of 1024 rows and more for the matmul
metrics, a plain PyTorch scan otherwise — with the reference's (rank, id)
tie-break (flat.rs:34-40) via a host-maintained lexicographic slot
permutation.

Mutations update a host mirror (the index stays rebuildable and cheap to
mutate); the device copy refreshes lazily on the next search. The device is
explicit: ``device="cuda"`` (the default) needs a CUDA device and never
switches to the CPU on its own.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch

from ..errors import (
    DimensionMismatch,
    InvalidFlatOptions,
    InvalidVector,
    UnsupportedFlatMetric,
)
from ..metrics import F32_MAX, METRICS, normalize_metric, rank_value
from ..observability import span
from ..ops import flat_scan
from ..ops.distance import batched_raw_scores, rank_from_raw, validate_vector
from ..ops.topk import bucket_limit, topk_slots
from .base import Index

_MIN_CAP = 8
_ROW_TILE = 1024
_STORAGES = ("f32", "bf16", "int8")
#: rows (capacity; a mesh shard's rows) from which a block searches on the
#: fused kernels; smaller blocks take the plain scan
FUSED_ROWS_MIN = 1024


def _cap_for(needed: int) -> int:
    """Capacity for ``needed`` rows. Small blocks round to a power of two
    (they sit below the fused-kernel threshold anyway); larger ones round up
    to the next ``_ROW_TILE`` multiple, so a bulk-ingested block carries
    <0.1% padding. The reference scans exactly ``n`` rows per query
    (flat.rs:96-124)."""
    if needed <= _ROW_TILE:
        return max(_MIN_CAP, 1 << max(0, math.ceil(math.log2(max(needed, 1)))))
    return -(-needed // _ROW_TILE) * _ROW_TILE


def resolve_device(device) -> torch.device:
    """The ``torch.device`` for a ``device=`` argument. A CUDA device must be
    available; there is no silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs CUDA, which is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def _check_storage(storage: str) -> None:
    if storage not in _STORAGES:
        raise InvalidFlatOptions(f"unknown storage mode: {storage!r}")


def round_bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even) — exactly the
    values a bf16 device block holds."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _search_kernel(x, valid, lex_order, q, scale=None, *, metric, limit):
    """The plain scan for small blocks and non-fused metrics: raw scores of
    every row, rank, top-``limit`` with the lex tie-break. ``q`` [B, d];
    ``scale`` [N] dequantizes an int8 block (every metric and limit stays
    servable on int8 storage, as flat.rs:96-124 serves every metric).
    Returns (slots [B, limit], raws [B, limit], ranks [B, limit],
    all_finite [B])."""
    if scale is not None:
        x = x.float() * scale[:, None]
    raw = batched_raw_scores(x, q, metric=metric)
    rank = rank_from_raw(raw, metric=metric)
    rank = torch.where(valid[None, :], rank, torch.full_like(rank, float("inf")))
    all_finite = (torch.isfinite(raw) | ~valid[None, :]).all(dim=1)
    slots, ranks = topk_slots(rank, lex_order, limit=limit)
    return slots, raw.gather(1, slots), ranks, all_finite


def _to_f64_array(vector) -> np.ndarray:
    try:
        arr = np.asarray(vector, dtype=np.float64)
    except (ValueError, TypeError) as exc:
        raise InvalidVector("vector must be numeric") from exc
    if arr.ndim != 1:
        raise InvalidVector("vector must be one-dimensional")
    return arr


def _on_host(t: torch.Tensor) -> np.ndarray:
    """``t`` copied to the host: a wait for its device."""
    with span("index.wait"):
        return t.cpu().numpy()


def _validate_row(vector, expected_dim):
    if len(vector) == 0:
        raise InvalidVector("vector must not be empty")
    if expected_dim is not None and len(vector) != expected_dim:
        raise DimensionMismatch("dimension mismatch")
    validate_vector(vector)


class FlatIndex(Index):
    """Exact scan over all stored vectors for one ranking metric."""

    def __init__(self, metric: str, options=None, *, storage: str = "f32", device="cuda"):
        if options not in (None, {}, []):
            raise InvalidFlatOptions("flat index accepts no options")
        metric = normalize_metric(metric)
        if metric not in METRICS:
            raise UnsupportedFlatMetric(metric)
        _check_storage(storage)
        #: "bf16" stores the device block in bfloat16: half the device
        #: memory, the K1 scan multiplies bf16 values, raw values approximate
        #: to ~1e-2. The host mirror then holds bf16-rounded values, so every
        #: consumer sees exactly the values the device block scores. "int8"
        #: stores per-row symmetric-quantized values and f32 scales: a
        #: quarter of the device memory, the K3 scan, raw values from the
        #: dequantized rows (~1e-2..1e-1). Its host mirror stays f32, the
        #: dequant reference.
        self.storage = storage
        self._int8_scale = None
        self.device = resolve_device(device)
        self.metric = metric
        self._dim: int | None = None
        self._cap = 0
        self._host_x: np.ndarray | None = None
        self._valid: np.ndarray | None = None
        self._ids: list = []
        self._slot_of: dict[str, int] = {}
        self._free: list[int] = []
        self._device = None
        self._device_scan = None
        self._lex_order_np = None
        self._dirty = True
        #: queries answered by the f64 host oracle (overflow or tie spill)
        self.host_routes = 0

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._slot_of)

    @property
    def dimension(self):
        return self._dim

    # -- mutation -----------------------------------------------------------

    def _store_rows(self, slots, rows) -> None:
        self._host_x[slots] = round_bf16(rows) if self.storage == "bf16" else rows

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs: Iterable[Tuple[str, list]]) -> None:
        """Insert-or-replace a batch. The whole batch is validated before any
        mutation (flat.rs:69-85). Rectangular batches take a vectorized path
        (single matrix validate + bulk slot assignment) — the row loop only
        handles ragged/replacing edge cases."""
        pairs = list(pairs)
        if not pairs:
            return
        ids = [str(id) for id, _ in pairs]
        matrix = None
        try:
            with np.errstate(over="ignore"):
                rows = [v for _, v in pairs]
                if rows and all(
                    isinstance(v, np.ndarray) and v.ndim == 1 and v.shape == rows[0].shape
                    for v in rows
                ):
                    matrix = np.concatenate(rows, dtype=np.float32).reshape(len(rows), -1)
                else:
                    matrix = np.stack([np.asarray(v, dtype=np.float32) for v in rows])
        except (TypeError, ValueError):
            matrix = None
        if (
            matrix is not None
            and matrix.ndim == 2
            and matrix.shape[1] > 0
            and len(set(ids)) == len(ids)
        ):
            expected = self._dim if self._dim is not None else matrix.shape[1]
            if matrix.shape[1] != expected:
                raise DimensionMismatch("dimension mismatch")
            with np.errstate(invalid="ignore"):
                if not np.isfinite(matrix).all():
                    raise InvalidVector("vector contains a non-finite value")
            new_ids = [id for id in ids if id not in self._slot_of]
            self._reserve(len(self._slot_of) + len(new_ids), expected)
            slots = np.empty(len(ids), dtype=np.int64)
            for i, id in enumerate(ids):
                slot = self._slot_of.get(id)
                if slot is None:
                    slot = self._free.pop()
                    self._slot_of[id] = slot
                    self._ids[slot] = id
                slots[i] = slot
            self._store_rows(slots, matrix)
            self._valid[slots] = True
            if self._dim is None:
                self._dim = expected
            self._dirty = True
            return

        # slow path: ragged rows / duplicate ids within the batch (replace
        # semantics: last occurrence wins) / precise per-row errors
        batch = [(str(id), _to_f64_array(v)) for id, v in pairs]
        expected = self._dim
        if expected is None and batch:
            expected = len(batch[0][1])
        for _, v in batch:
            _validate_row(v, expected)
        new_count = sum(1 for id, _ in batch if id not in self._slot_of)
        self._reserve(len(self._slot_of) + new_count, expected)
        for id, v in batch:
            slot = self._slot_of.get(id)
            if slot is None:
                slot = self._free.pop()
                self._slot_of[id] = slot
                self._ids[slot] = id
            self._store_rows(slot, v.astype(np.float32))
            self._valid[slot] = True
        if self._dim is None:
            self._dim = expected
        self._dirty = True

    def put_matrix(self, ids, matrix) -> None:
        """Bulk insert from an [n, d] f32 matrix with one row per id —
        the zero-copy ingest path for million-row corpora (no per-row Python
        objects; the reference's batched ``put_many`` analog at matrix
        granularity, flat.rs:59-85). Ids must be unique and not yet present;
        mixed insert-or-replace batches go through :meth:`put_many`."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or matrix.shape[1] == 0:
            raise InvalidVector("matrix must be [n, d] with d > 0")
        if len(ids) != matrix.shape[0]:
            raise InvalidVector("ids and matrix row count differ")
        expected = self._dim if self._dim is not None else matrix.shape[1]
        if matrix.shape[1] != expected:
            raise DimensionMismatch("dimension mismatch")
        with np.errstate(invalid="ignore"):
            if not np.isfinite(matrix).all():
                raise InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if len(set(ids)) != len(ids):
            raise InvalidVector("duplicate ids in matrix batch")
        if any(i in self._slot_of for i in ids):
            raise InvalidVector("put_matrix ids must not already exist")
        self._reserve(len(self._slot_of) + len(ids), expected)
        # fresh ids take the tail of the free list in one vectorized strip
        slots = np.array([self._free.pop() for _ in ids], dtype=np.int64)
        for id, slot in zip(ids, slots):
            self._slot_of[id] = int(slot)
            self._ids[int(slot)] = id
        self._store_rows(slots, matrix)
        self._valid[slots] = True
        if self._dim is None:
            self._dim = expected
        self._dirty = True

    def delete(self, id: str) -> None:
        slot = self._slot_of.pop(id, None)
        if slot is None:
            return
        # zero the dead row: the fused scan needs dead slots all-zero so
        # their rank is exactly the +inf bias under every fused metric
        self._host_x[slot, :] = 0.0
        self._valid[slot] = False
        self._ids[slot] = None
        self._free.append(slot)
        if not self._slot_of:
            # Empty index forgets its dimension (flat.rs:88-93).
            self._dim = None
            self._cap = 0
            self._host_x = None
            self._valid = None
            self._ids = []
            self._free = []
        self._dirty = True

    def _reserve(self, needed: int, dim: int):
        if self._host_x is None:
            cap = _cap_for(needed)
            self._cap = cap
            self._host_x = np.zeros((cap, dim), dtype=np.float32)
            self._valid = np.zeros(cap, dtype=bool)
            self._ids = [None] * cap
            self._free = list(range(cap - 1, -1, -1))
            return
        if needed <= self._cap:
            return
        # ~1.25x geometric growth amortizes incremental inserts; a one-shot
        # bulk ingest into a fresh/small index still reserves near-exact-fit
        cap = _cap_for(max(needed, self._cap + (self._cap >> 2)))
        grown_x = np.zeros((cap, self._host_x.shape[1]), dtype=np.float32)
        grown_x[: self._cap] = self._host_x
        grown_valid = np.zeros(cap, dtype=bool)
        grown_valid[: self._cap] = self._valid
        self._ids.extend([None] * (cap - self._cap))
        self._free.extend(range(cap - 1, self._cap - 1, -1))
        self._host_x = grown_x
        self._valid = grown_valid
        self._cap = cap

    def storage_view(self, storage: str) -> "FlatIndex":
        """A read-only view of this index under a different storage mode —
        the device block converts on device (no host→device re-transfer).
        Mutating either index afterwards is undefined; intended for
        benchmarking / serving-time storage experiments."""
        _check_storage(storage)
        view = FlatIndex(self.metric, storage=storage, device=self.device)
        view._dim = self._dim
        view._cap = self._cap
        view._host_x = self._host_x
        view._valid = self._valid
        view._ids = self._ids
        view._slot_of = self._slot_of
        view._free = self._free
        self._sync_device()
        view._lex_order_np = self._lex_order_np
        x, valid, lex_order = self._device
        if storage == "int8":
            if x.dtype == torch.int8:
                view._int8_scale = self._int8_scale
            else:
                x, view._int8_scale = flat_scan.quantize_rows(x)
        elif x.dtype == torch.int8:
            # a widening view cannot recover precision from the quantized
            # block: it rebuilds from the f32 host mirror
            view._dirty = True
            return view
        else:
            x = x.to(torch.bfloat16 if storage == "bf16" else torch.float32)
        view._device = (x, valid, lex_order)
        view._device_scan = self._device_scan
        view._dirty = False
        return view

    # -- search -------------------------------------------------------------

    def _sync_device(self):
        if not self._dirty and self._device is not None:
            return
        live = np.flatnonzero(self._valid)
        id_arr = np.array([self._ids[s] for s in live], dtype=str)
        order = live[np.argsort(id_arr, kind="stable")] if live.size else live
        invalid = np.flatnonzero(~self._valid)
        lex_order = np.concatenate([order, invalid]).astype(np.int64)
        # kept on the host for consumers that need the live slots in id
        # order without re-sorting a million id strings (IvfIndex.rebuild)
        self._lex_order_np = lex_order
        lex_rank = np.zeros(self._cap, dtype=np.int32)
        lex_rank[lex_order] = np.arange(self._cap, dtype=np.int32)
        bias = np.where(self._valid, np.float32(0.0), np.float32(np.inf)).astype(np.float32)
        xsq = np.sum(self._host_x ** 2, axis=1, dtype=np.float32)
        def put(a):  # always a copy: the mirror mutates in place
            return torch.from_numpy(a).to(self.device, copy=True)

        device_x = put(self._host_x)
        if self.storage == "bf16":
            device_x = device_x.to(torch.bfloat16)
        elif self.storage == "int8":
            device_x, self._int8_scale = flat_scan.quantize_rows(device_x)
        self._device = (device_x, put(self._valid), put(lex_order))
        self._device_scan = (put(xsq), put(bias), put(lex_rank))
        self._dirty = False

    def _fused_eligible(self, k: int) -> bool:
        """Whether the fused group-min scan (ops/flat_scan.py) handles this
        search; small blocks and other metrics take the plain scan (group
        selection only pays off past a few row tiles)."""
        return self._cap >= FUSED_ROWS_MIN and flat_scan.supports(self.metric, self._cap, k)

    def _dispatch(self, queries_device, k: int):
        """(slots [B, k], raws [B, k], ranks [B, k], ok [B]) device tensors:
        the fused kernels when eligible (one ok flag for the whole batch),
        else the plain scan (one flag per query)."""
        x, valid, lex_order = self._device
        if self._fused_eligible(k):
            xsq, bias, lex_rank = self._device_scan
            if self.storage == "int8":
                slots, raws, ranks, ok = flat_scan.fused_int8_search(
                    x, self._int8_scale, xsq, bias, lex_rank, queries_device,
                    metric=self.metric, k=k)
            else:
                slots, raws, ranks, ok = flat_scan.fused_flat_search(
                    x, xsq, bias, lex_rank, queries_device, metric=self.metric, k=k)
            return slots, raws, ranks, ok.expand(queries_device.shape[0])
        # _int8_scale is None unless the block is int8
        return _search_kernel(x, valid, lex_order, queries_device, self._int8_scale,
                              metric=self.metric, limit=k)

    def _query_block(self, qs: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(qs, dtype=np.float32)).to(self.device)

    @span("index.search")
    def search(self, query, limit: int) -> list:
        """Returns up to ``limit`` ``(id, raw)`` hits, best-first with
        deterministic (rank, id) tie-break."""
        if limit == 0:
            return []
        with span("index.validate"):
            q = _to_f64_array(query)
            _validate_row(q, self._dim)
        if not self._slot_of:
            return []
        return self._search_rows(q[None, :], limit)[0]

    @span("index.search_batch")
    def search_batch(self, queries, limit: int) -> list:
        """Scores a whole query batch in one device dispatch; returns one
        ``[(id, raw)]`` hit list per query."""
        if limit == 0:
            return [[] for _ in range(len(queries))]
        with span("index.validate"):
            try:
                qs = np.asarray(queries, dtype=np.float64)
            except (TypeError, ValueError) as exc:
                raise InvalidVector("queries must be numeric") from exc
            if qs.ndim != 2:
                raise InvalidVector("queries must be a [batch, dims] matrix")
            if qs.shape[0] == 0:
                return []
            if qs.shape[1] == 0:
                raise InvalidVector("vector must not be empty")
            if self._dim is not None and qs.shape[1] != self._dim:
                raise DimensionMismatch("dimension mismatch")
            if qs.size and (not np.isfinite(qs).all() or (np.abs(qs) > F32_MAX).any()):
                raise InvalidVector("vector contains a non-finite value")
        if not self._slot_of:
            return [[] for _ in range(qs.shape[0])]
        return self._search_rows(qs, limit)

    def _search_rows(self, qs: np.ndarray, limit: int) -> list:
        self._sync_device()
        k = bucket_limit(min(limit, len(self._slot_of)), self._cap)
        d_slots, d_raws, _ranks, d_ok = self._dispatch(self._query_block(qs), k)
        slots, raws, ok = _on_host(d_slots), _on_host(d_raws), _on_host(d_ok)
        n = min(limit, len(self._slot_of))
        results = []
        with span("index.assemble"):
            for b in range(qs.shape[0]):
                if not ok[b]:
                    results.append(self._host_search(qs[b], limit))
                else:
                    results.append(
                        [(self._ids[int(s)], float(r)) for s, r in zip(slots[b, :n], raws[b, :n])]
                    )
        return results

    def search_batch_device(self, queries_device, limit: int):
        """Device-to-device search: takes a resident [B, d] f32 query block,
        returns (slots, raws) device tensors with no host transfer. This is the
        serving/pipelining path — callers own staging and result fetch."""
        self._sync_device()
        k = bucket_limit(min(limit, max(len(self._slot_of), 1)), self._cap)
        slots, raws, _ranks, _ok = self._dispatch(queries_device, k)
        return slots, raws

    def candidate_slots_device(self, queries_device, count: int):
        """Hybrid-generator path: device ``(slots [B, k], ok [B, k])`` with
        ``ok`` masking pad and dead rows (rank +inf); ``k`` is ``count``
        bucketed as for a search. Slots index this index's internal slot
        order. As in the JAX package, a fused batch's tie-spill flag is not
        read here: the candidates are the scan's top ``k`` as they stand."""
        self._sync_device()
        k = bucket_limit(min(count, max(len(self._slot_of), 1)), self._cap)
        slots, _raws, ranks, _ok = self._dispatch(queries_device, k)
        return slots, torch.isfinite(ranks)

    def _host_search(self, q: np.ndarray, limit: int) -> list:
        """float64 fallback when f32 scoring overflowed or a tie spilled —
        the analog of the reference's per-pair f64 recovery
        (distances.rs:59-98). Raises MetricOverflow when a value is
        genuinely unrepresentable."""
        from ..ops.distance import _check_f32, _raw_f64

        self.host_routes += 1
        hits = []
        for id, slot in self._slot_of.items():
            row = self._host_x[slot].astype(np.float64)
            value = _raw_f64(self.metric, q, row)
            if self.metric not in ("hamming", "jaccard"):
                value = _check_f32(value)
            hits.append((rank_value(self.metric, value), id, value))
        hits.sort(key=lambda h: (h[0], h[1]))
        return [(id, raw) for _, id, raw in hits[:limit]]
