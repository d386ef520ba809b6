"""Collection orchestration: validation, insert pipeline, search modes,
snapshot/restore.

The port of ``vettore_tpu/collection.py`` for the slices ported so far: the
canonical record store lives on host; acceleration state (the flat index's
vector block, the adaptive scan cache) lives on the collection's device and
is always rebuildable from the store. Search modes:

* ``search``              — exact flat scan
* ``funnel_search``       — Matryoshka prefix staging + exact rerank
* ``quantized_search``    — sign-bit Hamming candidates + exact rerank
* ``multi_vector_search`` — ColBERT MaxSim late interaction over token sets,
  exact or over MUVERA FDE candidates (``candidates=`` / ``muvera=``)
* ``hybrid_search``       — a union of candidate generators (funnel,
  quantized, the index's search, the HNSW beam) + an exact or MaxSim rerank

The index is the exact flat index (``index="flat"``), the HNSW graph
(``index="hnsw"``: host inserts, and the kNN or wave bulk build, writes to
the bulk graph and the batched beam search on the collection's device,
``index/hnsw*.py``) or the IVF index (``index="ivf"``: k-means routing and
K2 over the probed blocks, ``index/ivf.py``); ``attach_index``
swaps in a prebuilt one (e.g. a graph from ``HnswIndex.load_graph``).
``compressed=True`` keeps the flat index's device block in bf16 and the
canonical records in a bf16 columnar store (``store/columnar.py``);
``store="columnar"`` asks for that store at f32.

``mesh=`` (``parallel.make_mesh``) shards the index and the scan cache by
rows across a grid of devices (``parallel/``); the collection's own
single-device work (queries, the hybrid's union, results) runs on the
mesh's first device.

Option validation is strict (unknown/duplicate options rejected,
collection.ex:1116-1157); score/distance semantics follow
``Distance.result_values`` exactly.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable

import numpy as np
import torch

from . import errors as E
from .embedding import Embedding, Result
from .index.base import Index, valid_index
from .index.flat import _ROW_TILE, FlatIndex, resolve_device
from .index.hnsw import HnswIndex
from .index.ivf import IvfIndex
from .metrics import (
    F32_MAX,
    MAX_USIZE,
    METRICS,
    default_normalize,
    normalize_metric,
    result_values,
)
from .observability import StatsRegistry, observed, span, tracing
from .observability import count as count_event
from .ops import flat_scan, scan_host
from .ops import maxsim as maxsim_ops
from .ops import muvera_fde
from .ops import pipeline as pipe
from .ops.distance import NORMALIZATIONS, normalize_rows, validate_vector
from .ops.packing import pack_signs_u32, pack_signs_u64_rows, words_for
from .ops.pipeline import _BIG32
from .parallel import adaptive_mesh as amesh
from .parallel.collection_mesh import MeshFlatIndex, MeshHnswIndex
from .parallel.ivf_mesh import MeshIvfIndex
from .parallel.mesh import pad_batch
from .store.base import Store, valid_store
from .store.columnar import ColumnarStore
from .store.memory import MemoryStore

SNAPSHOT_VERSION = 1
_SCORE_MODES = ("raw", "similarity")


def _validate_limit(limit):
    if not isinstance(limit, int) or isinstance(limit, bool) or not 0 < limit <= MAX_USIZE:
        raise E.InvalidLimit(f"invalid limit: {limit!r}")


def _reject_extra(extra: dict):
    if extra:
        raise E.UnsupportedOption(next(iter(extra)))


def _collection_device(device, mesh) -> torch.device:
    """The device of a collection's single-device work: ``device`` (default
    ``"cuda"``), or on a mesh the mesh's first device, which a ``device``
    given beside the mesh must name."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None:
        dev = resolve_device(device)
        first = mesh.first
        if dev.type != first.type or (dev.index or 0) != (first.index or 0):
            raise E.VettoreError(
                f"device {dev} is not the mesh's first device {first}", reason="invalid_device")
    return mesh.first


def _validate_candidates(candidates, limit):
    if (
        not isinstance(candidates, int)
        or isinstance(candidates, bool)
        or candidates < limit
        or candidates <= 0
        or candidates > MAX_USIZE
    ):
        raise E.InvalidCandidates(f"invalid candidates: {candidates!r}")


def _default_candidates(candidates, limit):
    """``candidates`` validated, defaulting to ``10 * limit``."""
    if candidates is None:
        candidates = max(limit * 10, limit)
    _validate_candidates(candidates, limit)
    return candidates


def _pow2_at_least(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def _mv_chunk(cap: int, b: int, qt: int, t: int) -> int:
    """Doc-chunk size for the plain MaxSim scan: bounds the [B, chunk, Qt, T]
    similarity block to ~512 MB f32 (the only large intermediate; the token
    block itself stays resident)."""
    budget = 512 * 1024 * 1024 // 4
    chunk = max(budget // max(1, b * qt * t), 1)
    chunk = max(1024, 1 << int(math.floor(math.log2(chunk))))
    return min(cap, chunk)


def _cap_at_least(n: int, floor: int = 8) -> int:
    """Scan-cache capacity: pow2 below one row tile, then the next tile
    multiple — <0.1% padded rows instead of up to 100% (the reference scans
    exactly n records, collection.ex:699-713). Equal to the flat index's
    capacity for the same count, so the cache can share its block."""
    if n <= _ROW_TILE:
        return _pow2_at_least(n, floor)
    return -(-n // _ROW_TILE) * _ROW_TILE


def _read_all(tensors) -> tuple:
    """Each device tensor of ``tensors`` read to the host as a numpy array,
    each read a ``hybrid.wait`` span."""
    out = []
    for t in tensors:
        with span("hybrid.wait"):
            out.append(t.cpu().numpy())
    return tuple(out)


def _has_tokens(vs) -> bool:
    """True when a record carries a non-empty multi-vector token set —
    either a list/tuple of rows (put/put_many) or a [t, d] ndarray
    (put_tokens). Plain truthiness would raise on a multi-row ndarray."""
    return vs is not None and len(vs) > 0


def _prefix_xsq(x, *, dims):
    sub = x[:, :dims].float()
    return (sub * sub).sum(dim=1)


class _VectorCache:
    """Device-resident mirror of all stored primary vectors for the adaptive
    scans (funnel / quantized). Rebuilt from the canonical store whenever
    the collection mutates — the same canonical-vs-acceleration split the
    reference keeps between ETS and native resources.

    Records are held in LEXICOGRAPHIC id order, so slot order == id order:
    a stable selection resolves equal-rank ties to the smallest id with no
    per-query gather through a lex permutation."""

    def __init__(self, records, dimensions, device, mesh=None):
        self.n = len(records)
        ids = []
        seen = set()
        for r in records:
            if not isinstance(r, Embedding) or not isinstance(r.id, str) or r.id == "":
                raise E.InvalidEmbedding("invalid embedding in store")
            if r.id in seen:
                raise E.DuplicateId(f"duplicate id: {r.id!r}")
            seen.add(r.id)
            ids.append(r.id)
        order = np.argsort(np.array(ids, dtype=str), kind="stable") if ids else []
        self.records = [records[i] for i in order]
        self.ids = [ids[i] for i in order]
        self.by_id = {id: r for id, r in zip(self.ids, self.records)}
        self.cap = _cap_at_least(self.n)
        self.mesh = mesh
        if mesh is not None:
            # equal shard rows, each a multiple of the kernels' 64-row group
            unit = mesh.shape["shard"] * flat_scan.GROUP
            self.cap = -(-self.cap // unit) * unit
        self.dimensions = dimensions
        self.device = device
        self._x = None
        self._valid = None
        self._host_mat = None
        self._signs = None
        self._stage_xsq = {}
        self._mv = None
        self._mv_norms = None
        #: derived device tables: FDE blocks by config, index slot tables
        self._tables = {}
        self._ids_np = None
        self._slot_of = None

    @property
    def slot_of(self) -> dict:
        """Cache slot of each id (lazy: only the hybrid's host union reads
        it)."""
        if self._slot_of is None:
            self._slot_of = {id: i for i, id in enumerate(self.ids)}
        return self._slot_of

    @property
    def n_loc(self) -> int:
        """Rows per shard on a mesh (the whole cache without one)."""
        return self.cap // self.mesh.shape["shard"] if self.mesh is not None else self.cap

    def _put(self, arr):
        """A host block on the device, or row-sharded over the mesh
        (``parallel.mesh.Blocks``)."""
        if self.mesh is not None:
            return self.mesh.shard_rows(arr)
        return torch.from_numpy(arr).to(self.device)

    def _stack_vectors(self) -> np.ndarray:
        """One [n, d] f32 matrix of all primary vectors, validated in bulk —
        the rebuild must be O(n) numpy work, not O(n) Python (a fresh cache is
        paid on the first adaptive scan after any mutation)."""
        if self._host_mat is not None:
            return self._host_mat
        rows = [r.vector for r in self.records]
        if any(v is None for v in rows):
            raise E.InvalidVector("embedding has no vector")
        d = self.dimensions
        if all(isinstance(v, np.ndarray) and v.shape == (d,) for v in rows):
            block = np.concatenate(rows, dtype=np.float32).reshape(self.n, d)
        else:
            try:
                block = np.asarray(rows, dtype=np.float32)
            except (TypeError, ValueError):
                block = None
        if block is None or block.ndim != 2 or block.shape[1] != self.dimensions:
            # ragged / wrong-width / non-numeric: re-walk for the precise error
            for v in rows:
                if len(v) != self.dimensions:
                    raise E.DimensionMismatch("dimension mismatch")
                np.asarray(v, dtype=np.float32)
            raise E.InvalidVector("vector must be numeric")
        with np.errstate(invalid="ignore"):
            if not np.isfinite(block).all():
                raise E.InvalidVector("vector contains a non-finite value")
        self._host_mat = block
        return block

    def valid_mask(self) -> torch.Tensor:
        """Device [cap] bool marking live slots (the cache is lex-packed, so
        this is just ``slot < n``)."""
        if self._x is not None:
            return self._x[1]
        if self._valid is None:
            self._valid = self._put(np.arange(self.cap) < self.n)
        return self._valid

    def vectors(self):
        """``(x [cap, d] f32, valid [cap] bool)`` on the device; records are
        lex-sorted, so slot order IS id order."""
        if self._x is not None:
            return self._x
        mat = np.zeros((self.cap, self.dimensions), dtype=np.float32)
        if self.n:
            mat[: self.n] = self._stack_vectors()
        self._x = (self._put(mat), self.valid_mask())
        return self._x

    def bits(self) -> torch.Tensor:
        """Packed sign bits per record, ``[cap, 2 * words_for(d)]`` uint32
        words held in int64 on the host: stored ``binary_vector`` words when present
        (validated), else packed from the primary vector
        (collection.ex:730-740). When no record stores words and every vector
        is float32, the bits pack from the f32 block itself (the sign test
        ``>= 0.0`` reads the same bits as the reference's f64 copy)."""
        expected_words = words_for(self.dimensions)
        width = 2 * expected_words
        out = np.zeros((self.cap, width), dtype=np.uint32)
        with_bv = [i for i, r in enumerate(self.records) if r.binary_vector is not None]
        without = [i for i, r in enumerate(self.records) if r.binary_vector is None]
        if with_bv:
            bvs = [self.records[i].binary_vector for i in with_bv]
            if all(isinstance(bv, np.ndarray) and bv.dtype == np.uint64
                   and bv.shape == (expected_words,) for bv in bvs):
                words = np.concatenate(bvs).reshape(len(bvs), expected_words)
            else:
                for bv in bvs:
                    # signed numpy arrays would WRAP under a uint64 cast (only
                    # Python ints raise OverflowError on negatives)
                    if isinstance(bv, np.ndarray) and bv.dtype.kind in "if" and (bv < 0).any():
                        raise E.InvalidBinaryVector("invalid binary vector")
                try:
                    words = np.asarray(bvs, dtype=np.uint64)
                except (TypeError, ValueError, OverflowError) as exc:
                    raise E.InvalidBinaryVector("invalid binary vector") from exc
            if words.ndim != 2 or words.shape[1] != expected_words:
                raise E.InvalidBinaryVector("invalid binary vector")
            rem = self.dimensions % 64
            if rem:
                words[:, -1] &= np.uint64((1 << rem) - 1)
            block = np.empty((len(with_bv), width), dtype=np.uint32)
            block[:, 0::2] = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            block[:, 1::2] = (words >> np.uint64(32)).astype(np.uint32)
            out[with_bv] = block
        if without:
            if not with_bv and all(isinstance(r.vector, np.ndarray)
                                   and r.vector.dtype == np.float32 for r in self.records):
                out[: self.n] = pack_signs_u32(self._stack_vectors())
            else:
                for i in without:
                    v = self.records[i].vector
                    if v is None or len(v) != self.dimensions:
                        raise E.DimensionMismatch("dimension mismatch")
                sub = np.asarray([self.records[i].vector for i in without], dtype=np.float64)
                if not np.isfinite(sub).all():
                    raise E.InvalidVector("vector contains a non-finite value")
                out[without] = pack_signs_u32(sub)
        # int64, not uint32: torch has no shifts for uint32
        return torch.from_numpy(out.astype(np.int64))

    def multi_vectors(self):
        """``(tokens [cap, T, d], counts [cap] int32)`` on the device: each
        record's ``vectors`` when non-empty, else its primary vector
        (collection.ex:773-777), zero-padded to T = the next power of two of
        the longest set. The block is bf16-resident when that is lossless
        (``maxsim.put_token_block``)."""
        if self._mv is not None:
            return self._mv
        d = self.dimensions
        counts = np.zeros(self.cap, dtype=np.int32)
        if all(not _has_tokens(r.vectors) for r in self.records):
            # plain single-vector corpus: the token block IS the primary
            # matrix, one stack instead of a per-record walk
            tokens = np.zeros((self.cap, 1, d), dtype=np.float32)
            has = np.array([r.vector is not None for r in self.records], dtype=bool)
            if has.all() and self.n:
                tokens[: self.n, 0] = self._stack_vectors()
                counts[: self.n] = 1
            else:
                for i, r in enumerate(self.records):
                    if r.vector is None:
                        continue
                    if len(r.vector) != d:
                        raise E.DimensionMismatch("dimension mismatch")
                    row = np.asarray(r.vector, dtype=np.float32)
                    if not np.isfinite(row).all():
                        raise E.InvalidMultiVector("invalid multi vector")
                    tokens[i, 0] = row
                    counts[i] = 1
            return self._set_mv(tokens, counts)
        first = self.records[0].vectors
        if (
            isinstance(first, np.ndarray)
            and first.ndim == 2
            and first.shape[1] == d
            and all(isinstance(r.vectors, np.ndarray) and r.vectors.shape == first.shape
                    for r in self.records)
        ):
            # bulk-ingested corpus (put_tokens): one [n*t, d] concatenate
            # instead of a per-record walk
            t = first.shape[0]
            t_max = _pow2_at_least(t, 1)
            tokens = np.zeros((self.cap, t_max, d), dtype=np.float32)
            block = np.concatenate([r.vectors for r in self.records],
                                   dtype=np.float32).reshape(self.n, t, d)
            if not np.isfinite(block).all():
                raise E.InvalidMultiVector("invalid multi vector")
            tokens[: self.n, :t] = block
            counts[: self.n] = t
            return self._set_mv(tokens, counts)
        docs = []
        for r in self.records:
            vs = r.vectors if _has_tokens(r.vectors) else (
                [r.vector] if r.vector is not None else [])
            if len(vs) == 0:
                docs.append(np.zeros((0, d), dtype=np.float32))
                continue
            try:
                rows = np.asarray(vs, dtype=np.float32)
            except (TypeError, ValueError) as exc:
                raise E.InvalidMultiVector("invalid multi vector") from exc
            if rows.ndim != 2 or rows.shape[1] != d:
                raise E.DimensionMismatch("dimension mismatch")
            if not np.isfinite(rows).all():
                raise E.InvalidMultiVector("invalid multi vector")
            docs.append(rows)
        t_max = _pow2_at_least(max((len(doc) for doc in docs), default=1), 1)
        tokens = np.zeros((self.cap, t_max, d), dtype=np.float32)
        for i, rows in enumerate(docs):
            counts[i] = len(rows)
            tokens[i, : len(rows)] = rows
        return self._set_mv(tokens, counts)

    def _set_mv(self, tokens: np.ndarray, counts: np.ndarray):
        if self.mesh is not None:
            # bf16 when the whole block is lossless, then row-sharded
            block = self.mesh.shard_rows(maxsim_ops.put_token_block(tokens, "cpu"))
        else:
            block = maxsim_ops.put_token_block(tokens, self.device)
        self._mv = (block, self._put(counts))
        return self._mv

    def token_norms(self):
        """``maxsim.token_norms`` of the token block of ``multi_vectors``:
        ``(tsq, tinv)`` per token row, computed once per block and dropped
        with it (a mutation makes a new cache)."""
        if self._mv_norms is None:
            tokens = self.multi_vectors()[0]
            self._mv_norms = (tokens.map(maxsim_ops.token_norms) if self.mesh is not None
                              else maxsim_ops.token_norms(tokens))
        return self._mv_norms

    def signs(self) -> torch.Tensor:
        """Device ±1 int8 sign block [cap, d] for the Hamming scan, expanded
        on the device from a transient device copy of the packed words (only
        the block stays resident)."""
        if self._signs is None:
            if self.mesh is not None:
                self._signs = self.mesh.shard_rows(self.bits()).map(
                    lambda words: pipe.signs_from_bits(words, d=self.dimensions))
            else:
                self._signs = pipe.signs_from_bits(self.bits().to(self.device),
                                                   d=self.dimensions)
        return self._signs

    def stage_xsq(self, dims: int) -> torch.Tensor:
        """Device [cap] f32 squared norms over the first ``dims`` columns —
        K5's renormalisation input, computed once per (stage, cache
        version). Pad rows are zero (cosine denom 0 -> sim 0; the +inf bias
        already masks them)."""
        if dims not in self._stage_xsq:
            x, _valid = self.vectors()
            self._stage_xsq[dims] = (x.map(lambda t: _prefix_xsq(t, dims=dims))
                                     if self.mesh is not None else _prefix_xsq(x, dims=dims))
        return self._stage_xsq[dims]

    def fde(self, cfg):
        """Device MUVERA document-FDE block for candidate generation:
        ``(fde [cap, W] bf16, xsq [cap] f32, bias [cap] f32)`` — encoded on
        the device from the token block (``ops/muvera_fde``), built once per
        cache generation and config. bf16 halves the block (a 1M x 2048 FDE
        block is ~4 GB next to the token block)."""
        key = ("fde", muvera_fde.config_key(cfg))
        if key not in self._tables:
            tokens, counts = self.multi_vectors()
            fde16 = muvera_fde.encode_documents_device(tokens, counts, cfg,
                                                       out_dtype=torch.bfloat16)
            xsq = muvera_fde.block_sq_norms(fde16)
            bias = torch.where(self.valid_mask(), 0.0, float("inf")).float()
            self._tables[key] = (fde16, xsq, bias)
        return self._tables[key]

    def index_slot_table(self, index):
        """Device int32 table mapping an index's internal slots to cache
        (lex) slots, ``2**31 - 1`` where an index slot's id is not in the
        cache — it keeps the hybrid's index generators on the device.
        ``None`` for a custom index without a device slot vocabulary. An
        HNSW index's table reads its device graph's ids, so callers run the
        index's device search (which refreshes that graph) first. An index
        with a ``hybrid_id_vocab`` (IVF) renumbers its slots when it
        rebuilds, so its table is keyed by its version and build count too."""
        key, index_ids = ("slots", id(index)), None
        vocab = getattr(index, "hybrid_id_vocab", None)
        if callable(vocab) and not isinstance(index, FlatIndex):
            index_ids = vocab()  # builds first where the index is stale
            key += (getattr(index, "_version", None), getattr(index, "_builds", None))
        if key in self._tables:
            return self._tables[key]
        if isinstance(index, FlatIndex):
            index_ids = index._ids
        elif index_ids is None:
            graph = getattr(index, "_bulk", None) or getattr(index, "_device", None)
            index_ids = getattr(graph, "ids", None)
        if index_ids is None:
            self._tables[key] = None
            return None
        if self._ids_np is None:
            self._ids_np = np.asarray(self.ids, dtype=str)
        src = np.asarray([i if isinstance(i, str) else "" for i in index_ids], dtype=str)
        if self.n:
            pos = np.searchsorted(self._ids_np, src)
            posc = np.clip(pos, 0, self.n - 1)
            table = np.where(self._ids_np[posc] == src, posc, _BIG32).astype(np.int32)
        else:
            table = np.full(len(src), _BIG32, dtype=np.int32)
        # on the collection's device, also on a mesh: the union is there
        self._tables[key] = torch.from_numpy(table).to(self.device)
        return self._tables[key]


class Collection:
    """One vector collection: canonical host store + device flat index.

    ``device`` (a ``torch.device`` or a string, default ``"cuda"``) is where
    the index's vector block lives and where searches run. ``"cuda"`` needs
    a CUDA device and raises when there is none; pass ``device="cpu"`` to
    run on the CPU. ``mesh`` (``parallel.make_mesh``) shards the index and
    the scan cache across the mesh's devices; the collection's own work then
    runs on the mesh's first device, which ``device``, if given, must
    name."""

    def __init__(
        self,
        *,
        name=None,
        dimensions=None,
        metric="cosine",
        normalize=None,
        store="memory",
        index="flat",
        index_options=None,
        score="raw",
        compressed=False,
        mesh=None,
        device=None,
        **extra,
    ):
        _reject_extra(extra)
        metric = normalize_metric(metric)
        if normalize is None:
            normalize = default_normalize(metric)
        if not isinstance(dimensions, int) or isinstance(dimensions, bool) or dimensions <= 0:
            raise E.InvalidDimensions(f"invalid dimensions: {dimensions!r}")
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        if normalize not in NORMALIZATIONS:
            raise E.InvalidNormalization(f"invalid normalization: {normalize!r}")
        if score not in _SCORE_MODES:
            raise E.InvalidScoreMode(f"invalid score mode: {score!r}")
        if not isinstance(compressed, bool):
            raise E.VettoreError("compressed must be a boolean", reason="invalid_compressed")
        if index_options is not None and not isinstance(index_options, dict):
            raise E.InvalidIndexOptions("index_options must be a dict")

        self.name = name
        self.dimensions = dimensions
        self.metric = metric
        self.normalize = normalize
        self.score = score
        self.index_kind = index if isinstance(index, str) else "custom"
        self.index_options = dict(index_options or {})
        self.compressed = compressed
        self.mesh = mesh
        self.device = _collection_device(device, mesh)

        self._stats = StatsRegistry()
        self._index = self._make_index(index, metric, self.index_options, compressed,
                                       device=self.device, mesh=mesh)
        self._store = self._make_store(store, self._config())
        self._write_lock = threading.RLock()
        self._version = 0
        self._cache = None
        self._cache_version = -1
        #: queries the adaptive modes answered on the host oracle (ok False)
        self.host_routes = 0

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    @staticmethod
    def _make_index(index, metric, index_options, compressed=False, *, device, mesh=None):
        if mesh is not None and index in ("flat", "hnsw", "ivf"):
            # a collection larger than one card shards across the mesh
            # (SURVEY §5.8): the same Index behaviour, row-sharded device state
            if index == "flat":
                return MeshFlatIndex(metric, index_options or None, mesh=mesh,
                                     storage="bf16" if compressed else "f32")
            if index == "hnsw":
                return MeshHnswIndex(metric, index_options, mesh=mesh)
            return MeshIvfIndex(metric, index_options, mesh=mesh)
        if index == "flat":
            # the reference's `compressed` trades CPU for ETS memory; here
            # the device block is stored in bf16 (half the card's memory,
            # K1's bf16 products)
            return FlatIndex(metric, index_options or None,
                             storage="bf16" if compressed else "f32", device=device)
        if index == "hnsw":
            return HnswIndex(metric, index_options, device=device)
        if index == "ivf":
            return IvfIndex(metric, index_options, device=device)
        if isinstance(index, type):
            instance = index(metric, index_options)
        else:
            instance = index
        if not valid_index(instance):
            raise E.InvalidIndex(f"invalid index: {index!r}")
        return instance

    @staticmethod
    def _make_store(store, config):
        compressed = bool(config.get("compressed"))
        if store == "memory":
            if compressed:
                # the reference's `compressed` cuts ETS (host) RAM
                # (store/ets.ex:273-282); the host analog is the columnar
                # store with bf16 halves — same rounding the compressed
                # device block scores with
                return ColumnarStore(config, dtype="bf16")
            return MemoryStore(config)
        if store == "columnar":
            return ColumnarStore(config, dtype="bf16" if compressed else "f32")
        if isinstance(store, type):
            instance = store(config)
        else:
            instance = store
        if not valid_store(instance):
            raise E.InvalidStore(f"invalid store: {store!r}")
        return instance

    def _config(self) -> dict:
        return {
            "snapshot_version": SNAPSHOT_VERSION,
            "name": self.name,
            "dimensions": self.dimensions,
            "metric": self.metric,
            "normalize": self.normalize,
            "score": self.score,
            "index": self.index_kind,
            "index_options": self.index_options,
            "compressed": self.compressed,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def ensure_open(self):
        alive = getattr(self._store, "alive", None)
        if callable(alive) and not alive():
            raise E.Closed("collection is closed")

    def close(self):
        close = getattr(self._store, "close", None)
        if callable(close):
            close()

    def stats(self) -> dict:
        """Snapshot of per-operation counters and latency aggregates.

        Search timings include the device work (the search APIs copy their
        results to the host before returning). Ingest timings exclude the
        device upload, which runs at the next search; bracket with
        :meth:`sync` when end-to-end ingest latency matters."""
        return self._stats.snapshot()

    @observed("sync")
    def sync(self) -> None:
        """Returns only after every queued device operation has finished (on
        every device of the mesh)."""
        for dev in self.mesh.distinct() if self.mesh is not None else [self.device]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    @property
    def store(self) -> Store:
        return self._store

    @property
    def index(self) -> Index:
        return self._index

    def attach_index(self, index) -> None:
        """Expert API: swaps in a prebuilt acceleration index for the SAME
        record set — e.g. a graph saved by ``HnswIndex.save_graph`` and
        reloaded with ``HnswIndex.load_graph`` (a warm start that skips the
        bulk build). The canonical store is untouched; the index must hold
        exactly the collection's records, and a port index must live on the
        collection's device. The attached index sets ``index_kind`` (an HNSW
        graph over a flat-ingested collection enables the ``hnsw`` hybrid
        generator)."""
        if not valid_index(index):
            raise E.InvalidIndex(f"invalid index: {index!r}")
        with self._write_lock:
            self.ensure_open()
            n = self.count()
            try:
                index_n = len(index)
            except TypeError:
                index_n = n  # custom index without __len__: the caller's contract
            if index_n != n:
                raise E.InvalidIndex(
                    f"attached index holds {index_n} records, collection has {n}")
            device = torch.device(getattr(index, "device", self.device))
            if device.type != self.device.type:
                raise E.InvalidIndex(
                    f"attached index lives on {device}, the collection on {self.device}")
            self._index = index
            if isinstance(index, FlatIndex):
                self.index_kind = "flat"
            elif isinstance(index, HnswIndex):
                self.index_kind = "hnsw"
            elif isinstance(index, IvfIndex):
                self.index_kind = "ivf"
            else:
                self.index_kind = "custom"
            self._bump()

    def _bump(self):
        self._version += 1

    def refresh(self):
        """Marks derived state stale (call after mutating a custom store
        directly, outside the collection API)."""
        self._bump()

    # ------------------------------------------------------------------
    # insert pipeline (collection.ex:920-1017)
    # ------------------------------------------------------------------

    def _prepare_one(self, item) -> Embedding:
        emb = Embedding.from_input(item)
        id = emb.id
        if not (isinstance(id, str) and id):
            if isinstance(emb.value, str) and emb.value:
                id = emb.value
            else:
                raise E.MissingId("embedding needs an id or a non-empty string value")

        vectors = None
        if emb.vectors is not None:
            if not isinstance(emb.vectors, (list, tuple)) or not emb.vectors:
                raise E.InvalidMultiVector("invalid multi vector")
            prepared = []
            for v in emb.vectors:
                self._validate_dims(v)
                prepared.append(normalize_rows(np.asarray(v, np.float64)[None, :], self.normalize)[0])
            vectors = prepared

        if emb.vector is not None:
            self._validate_dims(emb.vector)
            vector = normalize_rows(np.asarray(emb.vector, np.float64)[None, :], self.normalize)[0]
        elif vectors is not None:
            mean = np.mean(np.stack([v.astype(np.float64) for v in vectors]), axis=0)
            vector = normalize_rows(mean[None, :], self.normalize)[0]
        else:
            raise E.InvalidVector("embedding has no vector")

        binary = pack_signs_u64_rows(vector[None, :])[0]
        return Embedding(
            id=id,
            value=emb.value if emb.value is not None else id,
            vector=vector,
            vectors=vectors,
            binary_vector=[int(w) for w in binary],
            metadata=emb.metadata,
        )

    def _prepare_batch(self, items) -> list:
        """Batch insert preparation. Large homogeneous batches (plain
        single-vector records) take a vectorized path — one matrix validate /
        normalize / sign-pack instead of per-record Python work."""
        if len(items) < 256:
            return [self._prepare_one(i) for i in items]
        simple = []
        for item in items:
            if isinstance(item, Embedding):
                if item.vectors is not None or item.vector is None:
                    return self._prepare_batch_multi(items)
                id = item.id if isinstance(item.id, str) and item.id else (
                    item.value if isinstance(item.value, str) and item.value else None
                )
                if id is None:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                simple.append((id, item.value if item.value is not None else id,
                               item.vector, item.metadata))
            else:
                if "vectors" in item or "vector" not in item:
                    return self._prepare_batch_multi(items)
                id = item.get("id") or item.get("value")
                if not isinstance(id, str) or not id:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                simple.append((id, item.get("value", id), item["vector"],
                               item.get("metadata")))
        try:
            matrix = np.asarray([row[2] for row in simple], dtype=np.float64)
        except (TypeError, ValueError) as exc:
            raise E.InvalidVector("vector must be numeric") from exc
        if matrix.ndim != 2 or matrix.shape[1] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if not np.isfinite(matrix).all() or (np.abs(matrix) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        normalized = normalize_rows(matrix, self.normalize)
        packed = pack_signs_u64_rows(normalized)
        return [
            Embedding(id=id, value=value, vector=normalized[i],
                      vectors=None, binary_vector=[int(w) for w in packed[i]],
                      metadata=metadata)
            for i, (id, value, _vec, metadata) in enumerate(simple)
        ]

    def _prepare_batch_multi(self, items) -> list:
        """Vectorized preparation for homogeneous MULTI-vector batches (every
        record carries ``vectors`` with the same token count and no explicit
        primary vector). Anything ragged or mixed falls back to the
        per-record path."""
        rows = []
        for item in items:
            if isinstance(item, Embedding):
                if item.vector is not None or not item.vectors:
                    return [self._prepare_one(i) for i in items]
                id = item.id if isinstance(item.id, str) and item.id else (
                    item.value if isinstance(item.value, str) and item.value else None
                )
                if id is None:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                rows.append((id, item.value if item.value is not None else id,
                             item.vectors, item.metadata))
            else:
                if "vector" in item or not item.get("vectors"):
                    return [self._prepare_one(i) for i in items]
                id = item.get("id") or item.get("value")
                if not isinstance(id, str) or not id:
                    raise E.MissingId("embedding needs an id or a non-empty string value")
                rows.append((id, item.get("value", id), item["vectors"],
                             item.get("metadata")))
        t0 = len(rows[0][2]) if isinstance(rows[0][2], (list, tuple)) else -1
        if t0 <= 0 or not all(
            isinstance(r[2], (list, tuple)) and len(r[2]) == t0 for r in rows
        ):
            return [self._prepare_one(i) for i in items]
        try:
            tokens = np.asarray([r[2] for r in rows], dtype=np.float64)
        except (TypeError, ValueError):
            return [self._prepare_one(i) for i in items]
        if tokens.ndim != 3 or tokens.shape[2] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if not np.isfinite(tokens).all() or (np.abs(tokens) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        n, t, d = tokens.shape
        normalized = normalize_rows(tokens.reshape(n * t, d), self.normalize)
        normalized = normalized.reshape(n, t, d)
        # mean in f64 over the (f32) normalized tokens — byte parity with
        # _prepare_one's per-record pipeline
        primary = normalize_rows(
            normalized.astype(np.float64).mean(axis=1), self.normalize
        )
        packed = pack_signs_u64_rows(primary)
        return [
            Embedding(id=id, value=value,
                      vector=primary[i],
                      vectors=[normalized[i, j] for j in range(t)],
                      binary_vector=[int(w) for w in packed[i]],
                      metadata=metadata)
            for i, (id, value, _vs, metadata) in enumerate(rows)
        ]

    def _validate_dims(self, vector):
        if not isinstance(vector, (list, tuple, np.ndarray)):
            raise E.InvalidVector("vector must be a list")
        if len(vector) != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        validate_vector(list(vector) if not isinstance(vector, np.ndarray) else vector)

    def put(self, item) -> None:
        """Inserts or replaces one record (dict or :class:`Embedding`)."""
        self.put_many([item])

    @observed("put_many")
    def put_many(self, items: Iterable) -> None:
        items = list(items)
        if not all(isinstance(i, (dict, Embedding)) for i in items):
            raise E.InvalidEmbedding("invalid embeddings")
        prepared = self._prepare_batch(items)
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    @observed("put_matrix")
    def put_matrix(self, ids, matrix, *, values=None, metadata=None) -> None:
        """Bulk ingest from an [n, d] matrix with one row per id — the
        million-row path (vectorized validate / normalize / sign-pack; no
        per-record Python). Per-record ``binary_vector`` is stored as a
        uint64 ndarray row (accepted everywhere a word list is)."""
        matrix = np.asarray(matrix)
        if matrix.dtype.kind not in "iuf":
            matrix = matrix.astype(np.float64)  # rejects non-numeric input
        if matrix.ndim != 2:
            raise E.InvalidVector("matrix must be [n, d]")
        if matrix.shape[1] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if len(ids) != matrix.shape[0]:
            raise E.InvalidVector("ids and matrix row count differ")
        # validity is dtype-independent: check the input in place instead of
        # materializing a full-matrix f64 copy first (normalize_rows does its
        # f64 math in bounded row chunks)
        if not np.isfinite(matrix).all() or (np.abs(matrix) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if any(not i for i in ids):
            raise E.MissingId("embedding needs an id or a non-empty string value")
        normalized = normalize_rows(matrix, self.normalize)
        packed = pack_signs_u64_rows(normalized)
        prepared = [
            Embedding(
                id=id,
                value=(values[i] if values is not None else id),
                vector=normalized[i],
                vectors=None,
                binary_vector=packed[i],
                metadata=(metadata[i] if metadata is not None else None),
            )
            for i, id in enumerate(ids)
        ]
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                index_bulk = getattr(self._index, "put_matrix", None)
                if callable(index_bulk) and not any(
                    i in getattr(self._index, "_slot_of", {}) for i in ids
                ):
                    index_bulk(ids, normalized.astype(np.float32, copy=False))
                else:
                    self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    @observed("put_tokens")
    def put_tokens(self, ids, tokens, *, values=None, metadata=None) -> None:
        """Bulk multi-vector ingest from an [n, t, d] token block — the
        million-document ColBERT path. Semantics match ``put_many`` with
        ``vectors`` records (primary = normalized mean of the normalized
        tokens, auto sign packing; collection.ex:1008-1017), as one
        vectorized validate / normalize / mean / sign-pack. Stored
        ``vectors`` are [t, d] f32 ndarrays (accepted everywhere a row list
        is)."""
        tokens = np.asarray(tokens)
        if tokens.dtype.kind not in "iuf":
            tokens = tokens.astype(np.float64)  # rejects non-numeric input
        if tokens.ndim != 3 or tokens.shape[1] == 0:
            raise E.InvalidMultiVector("tokens must be [n, t, d]")
        if tokens.shape[2] != self.dimensions:
            raise E.DimensionMismatch("dimension mismatch")
        if len(ids) != tokens.shape[0]:
            raise E.InvalidVector("ids and token row count differ")
        if not np.isfinite(tokens).all() or (np.abs(tokens) > F32_MAX).any():
            raise E.InvalidVector("vector contains a non-finite value")
        ids = [str(i) for i in ids]
        if any(not i for i in ids):
            raise E.MissingId("embedding needs an id or a non-empty string value")
        n, t, d = tokens.shape
        normalized = normalize_rows(tokens.reshape(n * t, d), self.normalize).reshape(n, t, d)
        # mean accumulated in f64 straight off the f32 block: byte parity
        # with _prepare_batch_multi / _prepare_one
        primary = normalize_rows(normalized.mean(axis=1, dtype=np.float64), self.normalize)
        packed = pack_signs_u64_rows(primary)
        prepared = [
            Embedding(
                id=id,
                value=(values[i] if values is not None else id),
                vector=primary[i],
                vectors=normalized[i],
                binary_vector=packed[i],
                metadata=(metadata[i] if metadata is not None else None),
            )
            for i, id in enumerate(ids)
        ]
        with self._write_lock:
            self.ensure_open()
            self._store.put_many(prepared)
            try:
                index_bulk = getattr(self._index, "put_matrix", None)
                if callable(index_bulk) and not any(
                    i in getattr(self._index, "_slot_of", {}) for i in ids
                ):
                    index_bulk(ids, primary.astype(np.float32, copy=False))
                else:
                    self._index.put_many([(e.id, e.vector) for e in prepared])
            except Exception:
                for e in prepared:
                    self._index.delete(e.id)
                    self._store.delete(e.id)
                raise
            finally:
                self._bump()

    def get(self, id: str) -> Embedding:
        if not isinstance(id, str):
            raise E.VettoreError("invalid id", reason="invalid_id")
        return self._store.get(id)

    @observed("delete")
    def delete(self, id: str) -> None:
        if not isinstance(id, str):
            raise E.VettoreError("invalid id", reason="invalid_id")
        with self._write_lock:
            self.ensure_open()
            try:
                embedding = self._store.get(id)
            except E.NotFound:
                self._index.delete(id)
                self._bump()
                return
            self._index.delete(id)
            try:
                self._store.delete(id)
            except Exception as store_error:
                try:
                    self._index.put(id, embedding.vector)
                except Exception as index_error:
                    raise E.IndexRestoreFailed(store_error, index_error) from store_error
                raise
            finally:
                self._bump()

    def all(self) -> list:
        self.ensure_open()
        return self._store.all()

    def count(self) -> int:
        self.ensure_open()
        count = getattr(self._store, "count", None)
        return count() if callable(count) else len(self._store.all())

    # ------------------------------------------------------------------
    # query preparation and result hydration
    # ------------------------------------------------------------------

    def prepare_query(self, query) -> np.ndarray:
        self.ensure_open()
        with span("collection.validate"):
            self._validate_dims(query)
            q = np.asarray(query, np.float64)[None, :]
        with span("collection.normalize"):
            return normalize_rows(q, self.normalize)[0]

    def _to_result(self, embedding: Embedding, raw: float) -> Result:
        score, distance = result_values(self.metric, raw, self.score)
        return Result(
            id=embedding.id,
            value=embedding.value,
            score=score,
            distance=distance,
            metric=self.metric,
            metadata=embedding.metadata,
        )

    def _hydrate_hits(self, hits) -> list:
        results = []
        for id, raw in hits:
            try:
                embedding = self._store.get(id)
            except E.NotFound:
                continue
            results.append(self._to_result(embedding, raw))
        return results

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    @observed("search")
    def search(self, query, *, limit=10, **extra) -> list:
        """Index search (exact flat, or the HNSW beam) for one query; ``Result``
        list, best first."""
        _reject_extra(extra)
        _validate_limit(limit)
        q = self.prepare_query(query)
        hits = self._index.search(q, limit)
        with span("collection.hydrate"):
            return self._hydrate_hits(hits)

    @observed("search_batch")
    def search_batch(self, queries, *, limit=10, **extra) -> list:
        """Batched index search: one device dispatch for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        prepared = self._prepare_query_batch(queries)
        batch = getattr(self._index, "search_batch", None)
        if callable(batch):
            all_hits = batch(prepared, limit)
        else:
            all_hits = [self._index.search(q, limit) for q in prepared]
        with span("collection.hydrate"):
            return [self._hydrate_hits(hits) for hits in all_hits]

    # ------------------------------------------------------------------
    # adaptive modes: funnel and quantized (collection.ex:244-295,660-713)
    # ------------------------------------------------------------------

    def _prepare_query_vectors(self, query_vectors) -> np.ndarray:
        return self._prepare_token_sets([query_vectors])[0]

    def _prepare_token_sets(self, query_sets):
        """A call's query token sets checked and normalised: ``(block [ΣQ, d]
        f32, lengths)``, the sets' rows in order. Sets (non-empty lists or
        tuples) of ``(d,)`` integer or float ndarrays take one float64 range
        test (every value within ±F32_MAX, which NaN and ±inf fail) and one
        ``normalize_rows`` over the block, whose reductions are row-local, so
        each row's bits are its own call's. Any other input, or a block that
        fails the test, takes the per-token loop, which raises the first bad
        token's error (``collection.token_fallbacks``)."""
        rows, lengths = [], []
        for qs in query_sets:
            if not isinstance(qs, (list, tuple)) or not qs:
                break
            rows.extend(qs)
            lengths.append(len(qs))
        else:
            d = self.dimensions
            if all(type(t) is np.ndarray and t.shape == (d,) and t.dtype.kind in "iuf"
                   for t in rows):
                block = np.concatenate(rows, dtype=np.float64).reshape(len(rows), -1)
                with np.errstate(invalid="ignore"):
                    if -F32_MAX <= block.min() and block.max() <= F32_MAX:
                        count_event("collection.token_fallbacks", 0)
                        return normalize_rows(block, self.normalize), lengths
        count_event("collection.token_fallbacks")
        per = [self._token_rows(qs) for qs in query_sets]
        return np.concatenate(per), [len(p) for p in per]

    def _token_rows(self, query_vectors) -> np.ndarray:
        """One query token set, checked and normalised token by token."""
        if not isinstance(query_vectors, (list, tuple)) or not query_vectors:
            raise E.InvalidMultiVector("invalid multi vector")
        rows = []
        for v in query_vectors:
            self._validate_dims(v)
            rows.append(normalize_rows(np.asarray(v, np.float64)[None, :], self.normalize)[0])
        return np.stack(rows)

    def _prepare_query_batch(self, queries) -> np.ndarray:
        self.ensure_open()
        if not len(queries):
            return np.zeros((0, self.dimensions), np.float32)
        with span("collection.validate"):
            try:
                qs = np.asarray(queries, dtype=np.float64)
            except (TypeError, ValueError) as exc:
                raise E.InvalidVector("queries must be numeric") from exc
            if qs.ndim != 2:
                raise E.InvalidVector("queries must be a [batch, dims] matrix")
            if qs.shape[1] != self.dimensions:
                raise E.DimensionMismatch("dimension mismatch")
            if qs.size and (not np.isfinite(qs).all() or (np.abs(qs) > F32_MAX).any()):
                raise E.InvalidVector("vector contains a non-finite value")
        if not qs.size:
            return qs
        with span("collection.normalize"):
            return normalize_rows(qs, self.normalize)

    def _query_tensor(self, prepared: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(prepared, dtype=np.float32)).to(self.device)

    def _mesh_pad(self, rows):
        """A sync path's batch padded to whole data rows on a mesh
        (``parallel.mesh.pad_batch``); as it is without one."""
        return rows if self.mesh is None else pad_batch(self.mesh, rows)

    def _scan_cache(self) -> _VectorCache:
        if self._cache is None or self._cache_version != self._version:
            cache = _VectorCache(self._store.all(), self.dimensions, self.device, self.mesh)
            self._try_share_block(cache)
            self._cache = cache
            self._cache_version = self._version
        return self._cache

    def _try_share_block(self, cache: _VectorCache) -> None:
        """Shares the flat index's device block with the scan cache when slot
        order equals lex id order (true after a sorted bulk ingest) — saves a
        second multi-GB upload of the same vectors."""
        idx = self._index
        if not (
            isinstance(idx, FlatIndex)
            and idx.storage == "f32"
            and idx.device == cache.device
            and cache.n
            and len(idx) == cache.n
            and idx.dimension == self.dimensions
        ):
            return
        if idx._cap != cache.cap or not idx._valid[: cache.n].all() or idx._valid[cache.n:].any():
            return
        if idx._ids[: cache.n] != cache.ids:
            return
        idx._sync_device()
        x, valid, _lex_order = idx._device
        cache._x = (x, valid)

    def _slots_to_results(self, cache, slots, raws, ranks) -> list:
        return [self._to_result(cache.records[int(slot)], float(raw))
                for slot, raw, rank in zip(slots, raws, ranks) if np.isfinite(rank)]

    def _batch_results(self, cache, out, host_route, b=None) -> list:
        """Per-query Results from a batched pipeline's ``(slots, raws,
        ranks, ok)`` (its first ``b`` rows: the rest pad a mesh batch); a
        query whose ``ok`` is False takes ``host_route(b)`` (counted in
        ``adaptive.fallbacks``, 0 included, outside ``collection.hydrate``)."""
        host = []
        for t in out:
            with span("adaptive.wait"):
                host.append(t.cpu().numpy())
        top, raws, ranks, finite = host
        b = top.shape[0] if b is None else b
        flagged = [i for i in range(b) if not finite[i]]
        count_event("adaptive.fallbacks", len(flagged))
        with span("collection.hydrate"):
            results = [self._slots_to_results(cache, top[i], raws[i], ranks[i]) if finite[i]
                       else None for i in range(b)]
        for i in flagged:
            results[i] = host_route(i)
        return results

    def _funnel_stages(self, stages, dimensions):
        if stages is None:
            stages = [dimensions] if dimensions is not None else [min(self.dimensions, 128)]
        if not isinstance(stages, (list, tuple)) or not stages or not all(
            isinstance(s, int) and not isinstance(s, bool) and 0 < s <= self.dimensions
            for s in stages
        ):
            raise E.InvalidStages(f"invalid stages: {stages!r}")
        return list(stages)

    def _funnel_stage_xsq(self, cache, stages, count):
        """Prefix squared norms for the fused K5 stage 1, or None when the
        config takes the plain stage 1 (small corpora, unsupported metric,
        stage width or count). On a mesh the thresholds apply to a shard's
        rows, and the norms are sharded too."""
        rows = cache.n_loc
        if (
            rows >= pipe._FUSED_STAGE_MIN
            and flat_scan.supports_candidates(
                self.metric, rows, stages[0], min(count, max(cache.n, 1), rows))
        ):
            return cache.stage_xsq(stages[0])
        return None

    def _funnel_device(self, cache, queries, limit, candidates, stages):
        """The batched funnel pipeline over the cache (sharded on a mesh,
        whose batches must be a multiple of ``data``): device ``(slots,
        raws, ranks, ok)``."""
        x, valid = cache.vectors()
        count = min(candidates, max(cache.n, 1))
        stage_xsq = self._funnel_stage_xsq(cache, stages, count)
        if cache.mesh is not None:
            return amesh.sharded_funnel_topk(
                cache.mesh, x, valid, stage_xsq, queries, n=cache.n, metric=self.metric,
                stages=tuple(stages), count=count, limit=min(limit, count))
        return pipe.funnel_pipeline_batch(
            x, valid, queries, stage_xsq,
            metric=self.metric, stages=tuple(stages), count=count, limit=min(limit, count))

    def _quantized_device(self, cache, queries, limit, candidates):
        """The batched quantized pipeline over the cache (sharded on a
        mesh): device ``(slots, raws, ranks, ok)``."""
        x, valid = cache.vectors()
        count = min(candidates, max(cache.n, 1))
        if cache.mesh is not None:
            return amesh.sharded_quantized_topk(
                cache.mesh, x, cache.signs(), valid, queries, n=cache.n, metric=self.metric,
                count=count, limit=min(limit, count), d=self.dimensions)
        return pipe.quantized_pipeline_batch(
            x, cache.signs(), valid, queries, metric=self.metric, count=count,
            limit=min(limit, count), d=self.dimensions)

    @observed("funnel_search")
    def funnel_search(self, query, *, limit=10, candidates=None, stages=None, dimensions=None,
                      **extra) -> list:
        """Matryoshka funnel: prefix-staged candidate narrowing + exact rerank
        (collection.ex:244-260,660-691)."""
        _reject_extra(extra)
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        q = self.prepare_query(query)
        cache = self._scan_cache()
        if cache.n == 0:
            return []
        out = self._funnel_device(cache, self._query_tensor(self._mesh_pad(q[None, :])), limit,
                                  candidates, stages)
        return self._batch_results(
            cache, out, lambda b: self._funnel_host(cache, q, stages, candidates, limit), 1)[0]

    @observed("funnel_search_batch")
    def funnel_search_batch(self, queries, *, limit=10, candidates=None, stages=None,
                            dimensions=None, **extra) -> list:
        """Batched funnel search: one device pipeline for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        prepared = self._prepare_query_batch(queries)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in range(prepared.shape[0])]
        if prepared.shape[0] == 0:
            return []
        out = self._funnel_device(cache, self._query_tensor(self._mesh_pad(prepared)), limit,
                                  candidates, stages)
        return self._batch_results(
            cache, out,
            lambda b: self._funnel_host(cache, prepared[b], stages, candidates, limit),
            prepared.shape[0])

    def funnel_search_batch_device(self, queries_device, *, limit=10, candidates=None,
                                   stages=None, dimensions=None):
        """Device-to-device funnel search: takes a resident [B, d] f32
        PREPARED query block (caller owns validation/normalization — see
        ``prepare_query``), returns ``(slots, raws, ranks, ok)`` device
        tensors with no host transfer. The serving/pipelining path, like
        ``FlatIndex.search_batch_device``; hydrate with
        ``results_from_device``. On a mesh the batch must be a multiple of
        the ``data`` axis, and the results land on the mesh's first
        device."""
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        stages = self._funnel_stages(stages, dimensions)
        self.ensure_open()
        return self._funnel_device(self._scan_cache(), queries_device, limit, candidates, stages)

    @observed("quantized_search")
    def quantized_search(self, query, *, limit=10, candidates=None, **extra) -> list:
        """Sign-bit Hamming candidates + exact rerank (collection.ex:274-295)."""
        _reject_extra(extra)
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        q = self.prepare_query(query)
        cache = self._scan_cache()
        if cache.n == 0:
            return []
        out = self._quantized_device(cache, self._query_tensor(self._mesh_pad(q[None, :])), limit,
                                     candidates)
        return self._batch_results(
            cache, out, lambda b: self._quantized_host(cache, q, candidates, limit), 1)[0]

    @observed("quantized_search_batch")
    def quantized_search_batch(self, queries, *, limit=10, candidates=None, **extra) -> list:
        """Batched quantized search: one device pipeline for a query batch."""
        _reject_extra(extra)
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        prepared = self._prepare_query_batch(queries)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in range(prepared.shape[0])]
        if prepared.shape[0] == 0:
            return []
        out = self._quantized_device(cache, self._query_tensor(self._mesh_pad(prepared)), limit,
                                     candidates)
        return self._batch_results(
            cache, out, lambda b: self._quantized_host(cache, prepared[b], candidates, limit),
            prepared.shape[0])

    def quantized_search_batch_device(self, queries_device, *, limit=10, candidates=None):
        """Device-to-device quantized search; same contract as
        ``funnel_search_batch_device``."""
        _validate_limit(limit)
        candidates = _default_candidates(candidates, limit)
        self.ensure_open()
        return self._quantized_device(self._scan_cache(), queries_device, limit, candidates)

    def results_from_device(self, out) -> list:
        """Hydrates a ``(slots, raws, ranks, ok)`` device tuple from a
        ``*_search_batch_device`` call into per-query Result lists. Rows
        whose ``ok`` flag is False (f32 overflow or selection spill) come
        back as ``None`` — the sync batch APIs route those to the host
        oracle instead."""
        return self._batch_results(self._scan_cache(), out, lambda b: None)

    def _funnel_host(self, cache, q, stages, candidates, limit):
        self.host_routes += 1
        return self._rank_host(cache, q, self._funnel_host_ids(cache, q, stages, candidates),
                               limit)

    def _quantized_host(self, cache, q, candidates, limit):
        self.host_routes += 1
        return self._rank_host(cache, q, self._quantized_host_ids(cache, q, candidates), limit)

    def _funnel_host_ids(self, cache, q, stages, candidates):
        """The funnel's candidate ids by the float64 host scan: each stage
        keeps the best ``candidates`` by its prefix."""
        pairs = [(r.id, np.asarray(r.vector)) for r in cache.records]
        for dims in stages:
            hits = scan_host.vector_top_k(pairs, q, self.metric, dims, candidates)
            by_id = dict(pairs)
            pairs = [(id, by_id[id]) for id, _ in hits]
        return [id for id, _ in pairs]

    def _quantized_host_ids(self, cache, q, candidates):
        """The quantized mode's candidate ids by the host's packed Hamming
        scan."""
        qwords = [int(w) for w in pack_signs_u64_rows(q[None, :])[0]]
        pairs = []
        for r in cache.records:
            words = [int(w) for w in r.binary_vector] if r.binary_vector is not None else [
                int(w) for w in pack_signs_u64_rows(np.asarray(r.vector, np.float64)[None, :])[0]
            ]
            pairs.append((r.id, words))
        return [id for id, _ in scan_host.binary_top_k(pairs, qwords, self.dimensions,
                                                       candidates)]

    def _rank_host(self, cache, q, ids, limit):
        """The top ``limit`` of the records ``ids`` by the float64 host rank
        over every dimension."""
        pairs = [(id, np.asarray(cache.by_id[id].vector)) for id in ids]
        hits = scan_host.vector_top_k(pairs, q, self.metric, self.dimensions, limit)
        return [self._to_result(cache.by_id[id], raw) for id, raw in hits]

    # ------------------------------------------------------------------
    # multi-vector MaxSim (collection.ex:311-323,742-760)
    # ------------------------------------------------------------------

    @observed("multi_vector_search")
    def multi_vector_search(self, query_vectors, *, limit=10, metric=None,
                            candidates=None, muvera=None, **extra) -> list:
        """ColBERT MaxSim late interaction over multi-vector records
        (collection.ex:311-323,742-760): each query vector takes its best
        token similarity in a record, and the record's score is the sum.
        Records without ``vectors`` score through their primary vector.

        ``candidates``: route through the MUVERA FDE candidate generator
        (document FDEs encoded on the device from the token block) and
        rerank only the top ``candidates`` docs by exact MaxSim; ``muvera``
        optionally overrides the FDE config (the keys of the public
        encoders). Omitted: the exact full scan.

        >>> import vettore_tpu_torch as vt
        >>> col = vt.Collection(name="doc-mv", dimensions=2, metric="cosine",
        ...                     device="cpu")
        >>> col.put_many([
        ...     {"id": "a", "vectors": [[1.0, 0.0], [0.9, 0.1]]},
        ...     {"id": "b", "vectors": [[0.0, 1.0]]},
        ... ])
        >>> res = col.multi_vector_search([[1.0, 0.0]], limit=2)
        >>> [r.id for r in res]
        ['a', 'b']
        >>> round(res[0].score, 2)  # best token similarity, summed
        1.0
        """
        _reject_extra(extra)
        _validate_limit(limit)
        metric = normalize_metric(metric) if metric is not None else self.metric
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        self.ensure_open()
        self._prepare_query_vectors(query_vectors)
        # a batch of one: the same device scan (the MaxSim kernel for the
        # dot metrics) as multi_vector_search_batch
        fde_cfg = self._fde_config(candidates, muvera, metric)
        return self._multi_vector_sets([query_vectors], limit=limit, metric=metric,
                                       candidates=candidates, fde_cfg=fde_cfg)[0]

    def _multi_vector_host(self, cache, queries, metric, limit, ids=None, count=True):
        """The float64 host MaxSim (multi_vector.rs) over every record, or
        over the records ``ids``, for queries whose device scores overflowed
        f32 (counted in ``host_routes`` unless ``count`` is False: a caller
        that counted the route itself)."""
        self.host_routes += count
        documents = []
        for r in cache.records if ids is None else (cache.by_id[id] for id in ids):
            vs = r.vectors if _has_tokens(r.vectors) else [r.vector]
            documents.append((r.id, [list(np.asarray(v, np.float64)) for v in vs]))
        hits = maxsim_ops.top_k(documents, [list(q) for q in queries], metric, limit)
        return [
            Result(id=id, value=cache.by_id[id].value, score=score, distance=None,
                   metric=metric, metadata=cache.by_id[id].metadata)
            for id, score in hits
        ]

    def _pad_query_sets(self, query_sets):
        """Prepares a batch of ragged query token sets: ``(qtok [B, Qmax, d]
        f32, qmask [B, Qmax] bool)`` with Qmax the next power of two of the
        longest set."""
        with span("collection.validate_tokens"):
            block, lengths = self._prepare_token_sets(query_sets)
            lengths = np.asarray(lengths)
            qmask = np.arange(_pow2_at_least(int(lengths.max()), 1)) < lengths[:, None]
            qtok = np.zeros((*qmask.shape, self.dimensions), np.float32)
            qtok[qmask] = block  # row-major: the sets' rows in order
            return qtok, qmask

    def _mv_slots_to_results(self, cache, slots, scores, metric) -> list:
        return [
            Result(id=cache.records[int(slot)].id, value=cache.records[int(slot)].value,
                   score=float(score), distance=None, metric=metric,
                   metadata=cache.records[int(slot)].metadata)
            for slot, score in zip(slots, scores) if slot >= 0 and np.isfinite(score)
        ]

    @observed("multi_vector_search_batch")
    def multi_vector_search_batch(self, query_sets, *, limit=10, metric=None,
                                  candidates=None, muvera=None, **extra) -> list:
        """Batched ColBERT MaxSim over the full corpus: one query token set
        per batch element (ragged ok), one device scan for the whole batch.
        Dot-family metrics run the fused MaxSim kernel
        (``ops/maxsim.fused_maxsim_topk_batch``); the other metrics the
        chunked plain scan (``maxsim_full_topk_batch``).

        ``candidates`` / ``muvera``: MUVERA FDE candidate generation and an
        exact subset rerank (see :meth:`multi_vector_search`); ``candidates``
        at least the record count is the exact scan by definition."""
        _reject_extra(extra)
        _validate_limit(limit)
        metric = normalize_metric(metric) if metric is not None else self.metric
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        fde_cfg = self._fde_config(candidates, muvera, metric)
        self.ensure_open()
        if not isinstance(query_sets, (list, tuple)):
            raise E.InvalidMultiVector("invalid multi vector")
        if len(query_sets) == 0:
            return []
        return self._multi_vector_sets(query_sets, limit=limit, metric=metric,
                                       candidates=candidates, fde_cfg=fde_cfg)

    def _multi_vector_sets(self, query_sets, *, limit, metric, candidates, fde_cfg) -> list:
        """MaxSim search of a non-empty batch of query token sets: over MUVERA
        candidates when ``fde_cfg`` is set and ``candidates`` is below the
        record count, else the full scan (always on a mesh, as in the JAX
        package)."""
        qtok, qmask = self._pad_query_sets(query_sets)
        cache = self._scan_cache()
        if cache.n == 0:
            return [[] for _ in query_sets]
        k = min(limit, cache.n)
        if fde_cfg is not None and candidates < cache.n and self.mesh is None:
            out = self._mv_fde_pipeline(cache, qtok, qmask, metric=metric,
                                        candidates=candidates, cfg=fde_cfg, k=k)
        else:
            out = self._mv_full_scan(cache, qtok, qmask, metric=metric, k=k)
        slots, scores, ok = (t.cpu().numpy() for t in out)
        return [self._mv_slots_to_results(cache, slots[b], scores[b], metric) if ok[b]
                else self._multi_vector_host(cache, qtok[b][qmask[b]], metric, limit)
                for b in range(len(query_sets))]

    def _fde_config(self, candidates, muvera, metric):
        """The validated MUVERA config of a multi-vector search, or None for
        the exact scan."""
        if candidates is None:
            if muvera is not None:
                raise E.InvalidMuveraConfig("muvera config requires candidates")
            return None
        if not isinstance(candidates, int) or isinstance(candidates, bool) or candidates <= 0:
            raise E.InvalidCandidates(candidates)
        if metric not in muvera_fde.FDE_METRICS:
            raise E.InvalidMuveraConfig(
                f"muvera candidate generation requires a dot-family metric, got {metric!r}")
        return muvera_fde.normalize_config(muvera, self.dimensions)

    def _mv_fde_pipeline(self, cache, qtok, qmask, *, metric, candidates, cfg, k):
        """MUVERA candidate generation + exact subset rerank: bit-exact
        host-encoded query FDEs (the public encoder, muvera.rs sum mode), one
        device scan of the FDE block for the top-C slots (K5), then exact
        MaxSim of the C winners ((score desc, slot asc) order). Returns
        device ``(slots [B, k], scores [B, k], ok [B])``."""
        tokens, counts = cache.multi_vectors()
        fde16, fde_xsq, fde_bias = cache.fde(cfg)
        # _pad_query_sets refuses empty sets: every row has live tokens
        qfde = muvera_fde.encode_query_sets_host([qtok[i][qmask[i]] for i in range(len(qtok))],
                                                 cfg)
        c_eff = min(_pow2_at_least(candidates, 64), cache.cap)
        cand_slots, cand_ok = muvera_fde.fde_candidates(
            fde16, fde_xsq, fde_bias, self._query_tensor(qfde), count=c_eff)
        slot_ok = cand_slots >= 0
        # bound the [B, C, T, d] rerank gather by chunking the query batch
        b = qtok.shape[0]
        per_q = c_eff * tokens.shape[1] * tokens.shape[2] * tokens.element_size()
        qchunk = max(1, min(b, (512 << 20) // max(per_q, 1)))
        qtok_t = self._query_tensor(qtok)
        qmask_t = torch.from_numpy(qmask).to(self.device)
        parts = [maxsim_ops.maxsim_subset_topk_batch(
            tokens, counts, cand_slots[s:s + qchunk].clamp_min(0), slot_ok[s:s + qchunk],
            qtok_t[s:s + qchunk], qmask_t[s:s + qchunk], metric=metric, limit=k)
            for s in range(0, b, qchunk)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]) & cand_ok)

    def _mv_full_scan(self, cache, qtok, qmask, *, metric, k):
        """One device MaxSim scan of every doc for a batch of query token
        sets: the fused kernel path for the dot metrics, the chunked plain
        scan for the others. Returns device ``(slots, scores, ok)``; a set
        whose ``ok`` is False (f32 overflow) takes the float64 host path."""
        tokens, counts = cache.multi_vectors()
        valid = cache.valid_mask()
        if cache.mesh is not None:
            fused = maxsim_ops.supports_fused(metric, cache.n_loc, qtok.shape[1])
            return amesh.sharded_maxsim_topk(
                cache.mesh, tokens, counts, valid, cache.token_norms() if fused else None,
                self._query_tensor(self._mesh_pad(qtok)),
                torch.from_numpy(self._mesh_pad(qmask)).to(self.device), n=cache.n,
                metric=metric, limit=k, chunk=_mv_chunk(cache.n_loc, qtok.shape[0], qtok.shape[1],
                                         tokens.shard(0).shape[1]))
        qtok_t = self._query_tensor(qtok)
        qmask_t = torch.from_numpy(qmask).to(self.device)
        if maxsim_ops.supports_fused(metric, cache.cap, qtok.shape[1]):
            return maxsim_ops.fused_maxsim_topk_batch(
                tokens, counts, valid, qtok_t, qmask_t, metric=metric, limit=k,
                norms=cache.token_norms())
        return maxsim_ops.maxsim_full_topk_batch(
            tokens, counts, valid, qtok_t, qmask_t, metric=metric, limit=k,
            chunk=_mv_chunk(cache.cap, qtok.shape[0], qtok.shape[1], tokens.shape[1]))

    # ------------------------------------------------------------------
    # hybrid pipelines (collection.ex:337-348,516-658)
    # ------------------------------------------------------------------

    @observed("hybrid_search")
    def hybrid_search(self, query, *, limit=10, generators=None, rerank="exact",
                      **extra) -> list:
        """Candidate-generator union + rerank (collection.ex:337-348,516-658).

        ``generators`` names candidate generators, each a name or a
        ``(name, options)`` pair: ``"funnel"`` (options ``candidates``,
        ``stages``, ``dimensions``), ``"quantized"``, ``"search"`` (the
        index's own search) and ``"hnsw"`` (an HNSW index's beam), each
        with ``candidates`` (default ``10 * limit``). ``rerank`` is
        ``"exact"`` or ``("multi_vector", query_vectors[, {"metric": m}])``.

        >>> import vettore_tpu_torch as vt
        >>> col = vt.Collection(name="doc-hybrid", dimensions=2,
        ...                     metric="cosine", index="flat", device="cpu")
        >>> col.put_many([{"id": "a", "vector": [1.0, 0.0]},
        ...               {"id": "b", "vector": [0.0, 1.0]}])
        >>> [r.id for r in col.hybrid_search([1.0, 0.2], limit=1,
        ...                                  generators=["funnel", "quantized"])]
        ['a']
        """
        _reject_extra(extra)
        _validate_limit(limit)
        if generators is None:
            generators = self._default_generators()
        if not isinstance(generators, (list, tuple)) or not generators:
            raise E.InvalidGenerator(generators)
        q = self.prepare_query(query)
        if self.mesh is not None:
            # one query rides the sharded batch pipeline; the raw query, so
            # normalization applies once
            if isinstance(rerank, tuple) and len(rerank) in (2, 3) and rerank[0] == "multi_vector":
                rerank = ("multi_vector", [rerank[1]]) + tuple(rerank[2:])
            return self.hybrid_search_batch(np.asarray(query, np.float64)[None, :], limit=limit,
                                            generators=generators, rerank=rerank)[0]
        return self._hybrid_single(q, limit, generators, rerank)

    def _default_generators(self) -> list:
        """collection.ex:513-514: hnsw collections default to
        [:hnsw, :quantized], everything else to [:funnel, :quantized]; ivf
        collections (an extension over the reference) pair their index
        generator with the quantized prefilter."""
        if self.index_kind == "hnsw":
            return ["hnsw", "quantized"]
        if self.index_kind == "ivf":
            return ["search", "quantized"]
        return ["funnel", "quantized"]

    def _hybrid_single(self, q, limit, generators, rerank) -> list:
        """Single-query pipeline: each generator's candidates on the device,
        the union by id on the host, then the rerank. Also the re-run of a
        batch query that a batched generator or rerank flagged (it must not
        re-enter the batch path)."""
        cache = self._scan_cache()
        candidate_ids: list = []
        seen = set()
        for gen in generators:
            for id in self._run_generator(cache, q, gen, limit):
                if id not in seen:
                    seen.add(id)
                    candidate_ids.append(id)
        return self._hybrid_rerank(cache, q, candidate_ids, rerank, limit)

    def _parse_generator(self, gen, limit):
        """Validates one hybrid generator spec; returns (name, candidates,
        stages) with stages only set for funnel (collection.ex:535-556)."""
        if isinstance(gen, str):
            name, opts = gen, {}
        elif isinstance(gen, tuple) and len(gen) == 2 and isinstance(gen[0], str):
            name, opts = gen[0], dict(gen[1])
        else:
            raise E.InvalidGenerator(gen)
        allowed = {
            "funnel": {"candidates", "stages", "dimensions"},
            "quantized": {"candidates"},
            "search": {"candidates"},
            "hnsw": {"candidates"},
        }.get(name)
        if allowed is None:
            raise E.UnknownGenerator(name)
        for key in opts:
            if key not in allowed:
                raise E.UnsupportedOption(key)
        candidates = opts.get("candidates", max(limit * 10, limit))
        if (
            not isinstance(candidates, int)
            or isinstance(candidates, bool)
            or candidates <= 0
            or candidates > MAX_USIZE
        ):
            raise E.InvalidCandidates(f"invalid candidates: {candidates!r}")
        stages = None
        if name == "funnel":
            stages = self._funnel_stages(opts.get("stages"), opts.get("dimensions"))
        return name, candidates, stages

    @staticmethod
    def _mv_rerank_opts(rerank):
        """``(metric or None, query sets)`` of a ``("multi_vector", sets[,
        {"metric": m}])`` rerank; ``None`` for ``"exact"``."""
        if isinstance(rerank, str) and rerank == "exact":
            return None
        if not (isinstance(rerank, tuple) and len(rerank) in (2, 3)
                and rerank[0] == "multi_vector"):
            raise E.InvalidRerank(rerank)
        opts = dict(rerank[2]) if len(rerank) == 3 else {}
        for key in opts:
            if key != "metric":
                raise E.UnsupportedOption(key)
        return opts.get("metric"), rerank[1]

    def _rerank_metric(self, metric):
        metric = normalize_metric(metric if metric is not None else self.metric)
        if metric not in METRICS:
            raise E.InvalidMetric(f"invalid metric: {metric!r}")
        return metric

    @observed("hybrid_search_batch")
    def hybrid_search_batch(self, queries, *, limit=10, generators=None,
                            rerank="exact", **extra) -> list:
        """Batched hybrid pipeline: each generator runs once on the device
        for the whole query batch, the candidate union happens on the device
        (sort + neighbour dedup, ``ops/pipeline.union_candidates``), and the
        rerank (exact or MaxSim) is batched. With a ``multi_vector`` rerank,
        pass one query token set per query: ``("multi_vector", [qset_0, ...,
        qset_B-1])`` (+ an optional opts dict). Per query the results are
        ``hybrid_search``'s; a query that a generator or the rerank flags
        (overflow, tie spill) re-runs alone and counts in ``host_routes``."""
        _reject_extra(extra)
        _validate_limit(limit)
        if generators is None:
            generators = self._default_generators()
        if not isinstance(generators, (list, tuple)) or not generators:
            raise E.InvalidGenerator(generators)
        parsed = [self._parse_generator(g, limit) for g in generators]
        mv = self._mv_rerank_opts(rerank)
        mv_metric = None if mv is None else self._rerank_metric(mv[0])
        prepared = self._prepare_query_batch(queries)
        b = prepared.shape[0]
        if mv is not None and (not isinstance(mv[1], (list, tuple)) or len(mv[1]) != b):
            raise E.InvalidMultiVector("multi_vector rerank needs one query token set per query")
        cache = self._scan_cache()
        if b == 0:
            return []
        if cache.n == 0:
            return [[] for _ in range(b)]
        mesh = cache.mesh
        # a mesh batch pads to a multiple of data (the pad rows' results are
        # dropped)
        prepared = self._mesh_pad(prepared)
        qdev = self._query_tensor(prepared)
        blocks = []
        gen_ok = torch.ones(prepared.shape[0], dtype=torch.bool, device=self.device)
        for name, candidates, stages in parsed:
            count = min(candidates, cache.n)
            with span(f"hybrid.{name}"):
                if name == "funnel":
                    x, valid = cache.vectors()
                    stage_xsq = self._funnel_stage_xsq(cache, stages, count)
                    if mesh is not None:
                        slots, slot_ok, g_ok = amesh.sharded_funnel_candidates(
                            mesh, x, valid, stage_xsq, qdev, n=cache.n, metric=self.metric,
                            stages=tuple(stages), count=count)
                    else:
                        slots, slot_ok, g_ok = pipe.funnel_candidates_batch(
                            x, valid, qdev, stage_xsq,
                            metric=self.metric, stages=tuple(stages), count=count)
                elif name == "quantized":
                    fn = (pipe.quantized_candidates_batch if mesh is None else
                          lambda *a, **kw: amesh.sharded_quantized_candidates(mesh, *a,
                                                                              n=cache.n, **kw))
                    slots, slot_ok, g_ok = fn(cache.signs(), cache.valid_mask(), qdev,
                                              count=count, d=self.dimensions)
                else:
                    # a mesh index has no device candidates: the host path
                    blocks.append(self._index_candidates(cache, name, prepared, qdev, count))
                    continue
                blocks.append(torch.where(slot_ok, slots, _BIG32))
                gen_ok = gen_ok & g_ok
        with span("hybrid.union"):
            # one integer dtype for the union's sort (index slot tables are int32)
            u_slots, u_ok = pipe.union_candidates(torch.cat([blk.long() for blk in blocks],
                                                            dim=1))
        if tracing():  # a device sum, so the untraced path launches nothing for it
            count_event("hybrid.candidates", u_ok[:b].sum())
        k = min(limit, cache.n)

        if mv is None:
            x, _valid = cache.vectors()
            rerank_fn = (pipe.rerank_batch if mesh is None else
                         lambda *a, **kw: amesh.sharded_subset_rerank(mesh, *a, n=cache.n, **kw))
            with span("hybrid.rerank"):
                top, raws, ranks, fin, g_ok = _read_all(
                    (*rerank_fn(x, u_slots, u_ok, qdev, metric=self.metric, limit=k), gen_ok))
            ok = fin & g_ok
            with span("collection.hydrate"):
                out = [self._slots_to_results(cache, top[i], raws[i], ranks[i]) if ok[i]
                       else None for i in range(b)]
            return self._hybrid_reruns(out, queries, limit, generators, lambda i: rerank)

        qsets = mv[1]
        qtok, qmask = (self._mesh_pad(a) for a in self._pad_query_sets(qsets))
        tokens, counts = cache.multi_vectors()
        t_max = (tokens if mesh is None else tokens.shard(0)).shape[1]
        # chunk the query batch so the [B, C, T, d] candidate gather stays
        # bounded (~512 MB of f32); on a mesh by whole data rows
        per_q = max(1, u_slots.shape[1] * t_max * self.dimensions)
        bs = max(1, (512 * 1024 * 1024 // 4) // per_q)
        subset = maxsim_ops.maxsim_subset_topk_batch
        if mesh is not None:
            data = mesh.shape["data"]
            bs = max(data, bs - bs % data)
            subset = lambda *a, **kw: amesh.sharded_subset_maxsim(  # noqa: E731
                mesh, *a, n=cache.n, **kw)
        with span("hybrid.rerank"):
            qtok_t = self._query_tensor(qtok)
            qmask_t = torch.from_numpy(qmask).to(self.device)
            parts = [subset(
                tokens, counts, u_slots[s:s + bs], u_ok[s:s + bs], qtok_t[s:s + bs],
                qmask_t[s:s + bs], metric=mv_metric, limit=k)
                for s in range(0, qtok.shape[0], bs)]
            top, scores, mv_ok, g_ok = _read_all(
                (*(torch.cat([p[j] for p in parts]) for j in range(3)), gen_ok))
        ok = mv_ok & g_ok
        with span("collection.hydrate"):
            out = [self._mv_slots_to_results(cache, top[i], scores[i], mv_metric) if ok[i]
                   else None for i in range(b)]
        return self._hybrid_reruns(out, queries, limit, generators,
                                   lambda i: ("multi_vector", qsets[i]) + tuple(rerank[2:]))

    def _hybrid_reruns(self, out, queries, limit, generators, rerank_of) -> list:
        """``out`` with each query the batch left as None re-run alone
        (``_hybrid_fallback``, with ``rerank_of(i)``), counted in the
        ``hybrid.reruns`` counter."""
        reruns = [i for i, hits in enumerate(out) if hits is None]
        for i in reruns:
            out[i] = self._hybrid_fallback(queries, i, limit, generators, rerank_of(i))
        count_event("hybrid.reruns", len(reruns))
        return out

    def _index_candidates(self, cache, name, prepared, qdev, count):
        """The ``search`` / ``hnsw`` generator over the whole batch: the
        index's device candidates mapped to cache slots through
        ``index_slot_table`` (int32 slots, ``_BIG32`` pads); a custom index
        without a device path is searched query by query."""
        if name == "hnsw" and self.index_kind != "hnsw":
            raise E.HnswIndexRequired("hnsw generator requires an hnsw index")
        cand_dev = getattr(self._index, "candidate_slots_device", None)
        table = None
        if callable(cand_dev):
            islots, iok = cand_dev(qdev, count)
            # AFTER the device search: it refreshes the index's device graph
            table = cache.index_slot_table(self._index)
        if table is not None:
            return torch.where(iok, table[islots.clamp(0, table.shape[0] - 1)], _BIG32)
        rows = [[cache.slot_of[i] for i, _ in self._index.search(q, count) if i in cache.slot_of]
                for q in prepared]
        arr = np.full((len(rows), max([len(r) for r in rows] + [1])), _BIG32, np.int32)
        for i, r in enumerate(rows):
            arr[i, : len(r)] = r
        return torch.from_numpy(arr).to(self.device)

    def _hybrid_fallback(self, queries, b, limit, generators, rerank):
        """Single-query re-run for a batch element whose batched device
        pipeline was flagged (the f64-recovery posture, distances.rs:59-98);
        it leaves the batched device path, so it counts in ``host_routes``."""
        self.host_routes += 1
        q = self.prepare_query(np.asarray(queries, dtype=np.float64)[b])
        return self._hybrid_single(q, limit, generators, rerank)

    def _run_generator(self, cache, q, gen, limit) -> list:
        """One generator's candidate ids for one prepared query ``q``. A
        funnel that overflows f32 or a quantized selection that spills its
        tie slack scans on the host (counted in ``host_routes``). On a mesh
        this is the re-run of a flagged batch query, on the host oracles."""
        name, candidates, stages = self._parse_generator(gen, limit)
        if name in ("funnel", "quantized") and cache.n == 0:
            return []
        if cache.mesh is not None and name == "funnel":
            return self._funnel_host_ids(cache, q, stages, candidates)
        if cache.mesh is not None and name == "quantized":
            return self._quantized_host_ids(cache, q, candidates)
        count = min(candidates, cache.n)
        qt = self._query_tensor(q)
        if name == "funnel":
            x, valid = cache.vectors()
            slots, ok, finite = (t.cpu().numpy() for t in pipe.funnel_candidates_pipeline(
                x, valid, qt, self._funnel_stage_xsq(cache, stages, count),
                metric=self.metric, stages=tuple(stages), count=count))
            if finite:
                return [cache.ids[int(s)] for s, o in zip(slots, ok) if o]
            self.host_routes += 1
            return self._funnel_host_ids(cache, q, stages, candidates)
        if name == "quantized":
            slots, ok, sel_ok = (t.cpu().numpy() for t in pipe.quantized_candidates_pipeline(
                cache.signs(), cache.valid_mask(), qt, count=count, d=self.dimensions))
            if sel_ok:
                return [cache.ids[int(s)] for s, o in zip(slots, ok) if o]
            # a tie spill past the selection slack: exact host candidates
            self.host_routes += 1
            return self._quantized_host_ids(cache, q, candidates)
        if name == "hnsw" and self.index_kind != "hnsw":
            raise E.HnswIndexRequired("hnsw generator requires an hnsw index")
        # "search" / "hnsw": go through the collection's index
        return [id for id, _ in self._index.search(q, candidates) if id in cache.slot_of]

    def _hybrid_rerank(self, cache, q, candidate_ids, rerank, limit):
        """The single-query rerank of a candidate id list: exact (full f32
        over the candidates' rows) or MaxSim over their token sets; a rerank
        that overflows f32 scores on the host in float64."""
        mv = self._mv_rerank_opts(rerank)
        if mv is not None:
            metric = self._rerank_metric(mv[0])
            queries = self._prepare_query_vectors(mv[1])
        if not candidate_ids:
            return []
        if cache.mesh is not None:  # a flagged batch query's host re-run
            if mv is None:
                return self._rank_host(cache, q, candidate_ids, limit)
            return self._multi_vector_host(cache, queries, metric, limit, ids=candidate_ids,
                                           count=False)
        # ascending slots ARE lex order (the cache is id-sorted), which the
        # stable (rank, id) tie-break requires
        slots = np.array(sorted(cache.slot_of[id] for id in candidate_ids), dtype=np.int64)
        bucket = _pow2_at_least(len(slots), 1)
        ok = np.zeros(bucket, dtype=bool)
        ok[: len(slots)] = True
        padded = np.zeros(bucket, dtype=np.int64)
        padded[: len(slots)] = slots
        slots_t, ok_t = (torch.from_numpy(a).to(self.device) for a in (padded, ok))
        k = min(limit, len(slots))
        if mv is None:
            x, _valid = cache.vectors()
            top, raws, ranks, finite = (t.cpu().numpy() for t in pipe.rerank_pipeline(
                x, slots_t, ok_t, self._query_tensor(q), metric=self.metric, limit=k))
            if finite:
                return self._slots_to_results(cache, top, raws, ranks)
            self.host_routes += 1
            return self._rank_host(cache, q, candidate_ids, limit)
        tokens, counts = cache.multi_vectors()
        qtok = self._query_tensor(queries[None])
        qmask = torch.ones((1, queries.shape[0]), dtype=torch.bool, device=self.device)
        top, scores, dev_ok = (t[0].cpu().numpy() for t in maxsim_ops.maxsim_subset_topk_batch(
            tokens, counts, slots_t[None], ok_t[None], qtok, qmask, metric=metric, limit=k))
        if dev_ok:
            return self._mv_slots_to_results(cache, top, scores, metric)
        return self._multi_vector_host(cache, queries, metric, limit, ids=candidate_ids)

    # ------------------------------------------------------------------
    # snapshot / restore (collection.ex:135-164,376-433)
    # ------------------------------------------------------------------

    def snapshot(self, path: str) -> None:
        """Atomic checksummed snapshot (tmp write + rename, store/ets.ex:29-45).
        The file format is the JAX package's: either package loads the
        other's snapshots."""
        if not isinstance(path, str):
            raise E.InvalidSnapshot("invalid snapshot path")
        self.ensure_open()
        configure = getattr(self._store, "configure", None)
        if callable(configure):
            configure(self._config())
        self._store.snapshot(path)


def load_snapshot(path: str, *, name=None, index=None, index_options=None, score=None,
                  store=None, mesh=None, device=None, **extra):
    """Loads a collection from a snapshot; the index is rebuilt from canonical
    records, never deserialized. Overrides are restricted to non-structural
    fields (collection.ex:54,1159-1174) and persist through later snapshots.
    ``device`` is where the rebuilt index lives, as for :class:`Collection`;
    ``mesh`` rebuilds it sharded across the mesh (the snapshot format is
    the same either way: the host records are canonical)."""
    for key in extra:
        raise E.UnsupportedSnapshotOverride(key)
    if not isinstance(path, str):
        raise E.InvalidSnapshot("invalid snapshot path")
    if store == "columnar":
        # ColumnarStore.load_snapshot picks bf16 itself for compressed configs
        store = ColumnarStore
    store_cls = MemoryStore if store is None else store
    if not (isinstance(store_cls, type) and callable(getattr(store_cls, "load_snapshot", None))):
        raise E.InvalidStore(f"invalid store: {store!r}")
    loaded_store, config = store_cls.load_snapshot(path)
    try:
        return _restore(loaded_store, config, name=name, index=index,
                        index_options=index_options, score=score, device=device, mesh=mesh)
    except Exception:
        close = getattr(loaded_store, "close", None)
        if callable(close):
            close()
        raise


def _restore(loaded_store, config, *, name, index, index_options, score, device, mesh=None):
    if not isinstance(config, dict):
        raise E.InvalidSnapshot("snapshot config must be a map")
    if config.get("snapshot_version", 0) not in (0, SNAPSHOT_VERSION):
        raise E.UnsupportedSnapshotVersion("unsupported snapshot version")

    collection = Collection.__new__(Collection)
    metric = normalize_metric(config.get("metric", "cosine"))
    dimensions = config.get("dimensions")
    normalize = config.get("normalize", default_normalize(metric))
    index_kind = index if index is not None else config.get("index", "flat")
    opts = index_options if index_options is not None else config.get("index_options", {}) or {}
    score_mode = score if score is not None else config.get("score", "raw")
    compressed = config.get("compressed", False)

    if not isinstance(dimensions, int) or isinstance(dimensions, bool) or dimensions <= 0:
        raise E.InvalidDimensions(f"invalid dimensions: {dimensions!r}")
    if metric not in METRICS:
        raise E.InvalidMetric(f"invalid metric: {metric!r}")
    if normalize not in NORMALIZATIONS:
        raise E.InvalidNormalization(f"invalid normalization: {normalize!r}")
    if score_mode not in _SCORE_MODES:
        raise E.InvalidScoreMode(f"invalid score mode: {score_mode!r}")
    if not isinstance(compressed, bool):
        raise E.VettoreError("compressed must be a boolean", reason="invalid_compressed")
    if not isinstance(opts, dict):
        raise E.InvalidIndexOptions("index_options must be a dict")

    collection.name = name if name is not None else config.get("name")
    collection.dimensions = dimensions
    collection.metric = metric
    collection.normalize = normalize
    collection.score = score_mode
    collection.index_kind = index_kind if isinstance(index_kind, str) else "custom"
    collection.index_options = dict(opts)
    collection.compressed = compressed
    collection.mesh = mesh
    collection.device = _collection_device(device, mesh)
    collection._stats = StatsRegistry()
    collection._index = Collection._make_index(index_kind, metric, dict(opts), compressed,
                                               device=collection.device, mesh=mesh)
    collection._store = loaded_store
    collection._write_lock = threading.RLock()
    collection._version = 0
    collection._cache = None
    collection._cache_version = -1
    collection.host_routes = 0

    records = loaded_store.all()
    _validate_snapshot_records(collection, records)
    records = sorted(records, key=lambda r: r.id)
    # million-row restore: one stacked matrix through the index's bulk path
    # (the canonical-store rebuild must stay O(n) numpy — same posture as
    # put_matrix)
    index_bulk = getattr(collection._index, "put_matrix", None)
    mat = None
    if callable(index_bulk) and records and all(
        isinstance(r.vector, np.ndarray) and r.vector.shape == (dimensions,)
        for r in records
    ):
        mat = np.concatenate(
            [r.vector for r in records], dtype=np.float32
        ).reshape(len(records), dimensions)
    if mat is not None:
        index_bulk([r.id for r in records], mat)
    else:
        collection._index.put_many([(r.id, r.vector) for r in records])
    configure = getattr(loaded_store, "configure", None)
    if callable(configure):
        configure(collection._config())
    return collection


def _validate_snapshot_records(collection, records):
    if not isinstance(records, list):
        raise E.InvalidSnapshot("invalid snapshot records")
    d = collection.dimensions
    W = words_for(d)
    # vectorized fast path for what the snapshot reader actually produces
    # (homogeneous f32 ndarray rows, uint64 word rows): one bulk finite
    # check instead of a million per-record validations. Anything unusual
    # falls through to the per-record loop for the precise error.
    if records and all(
        isinstance(r, Embedding)
        and ((isinstance(r.id, str) and r.id)
             or (isinstance(r.value, str) and r.value))
        and isinstance(r.vector, np.ndarray)
        and r.vector.shape == (d,)
        and r.vector.dtype == np.float32
        and r.vectors is None
        and (r.binary_vector is None or (
            isinstance(r.binary_vector, np.ndarray)
            and r.binary_vector.dtype == np.uint64
            and r.binary_vector.shape == (W,)))
        for r in records
    ):
        block = np.concatenate([r.vector for r in records]).reshape(-1, d)
        if np.isfinite(block).all():
            return
    for r in records:
        if not isinstance(r, Embedding):
            raise E.InvalidSnapshotRecord("invalid_embedding")
        try:
            if not (isinstance(r.id, str) and r.id) and not (
                isinstance(r.value, str) and r.value
            ):
                raise E.MissingId("missing id")
            collection._validate_dims(r.vector)
            if r.vectors is not None:
                if (
                    not isinstance(r.vectors, (list, tuple, np.ndarray))
                    or len(r.vectors) == 0
                ):
                    raise E.InvalidMultiVector("invalid multi vector")
                for v in r.vectors:
                    collection._validate_dims(v)
            if r.binary_vector is not None:
                words = [int(w) for w in r.binary_vector]
                if len(words) != words_for(collection.dimensions) or any(
                    w < 0 or w > 2**64 - 1 for w in words
                ):
                    raise E.InvalidBinaryVector("invalid binary vector")
        except E.VettoreError as exc:
            raise E.InvalidSnapshotRecord(exc.reason) from exc
