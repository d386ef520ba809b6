"""Mesh-sharded flat search: row shards, query batches by data row, an exact
(rank, id) merge.

The port of ``vettore_tpu/parallel/mesh.py``. JAX runs every shard from one
controller under ``shard_map`` over a ``jax.sharding.Mesh``; here one Python
process drives a ``[data, shard]`` grid of ``torch.device``s:

* ``shard`` — the ``[N, d]`` block is row-sharded: shard ``s`` keeps its rows
  on the devices of grid column ``s``;
* ``data`` — a query batch splits into ``data`` equal row batches, and row
  ``r`` of the grid serves batch ``r`` (the analog of the reference's
  concurrent readers).

Each shard computes a local top-k on its own device with the hand kernels
(the fused flat scan, K1 + K2), then the candidate planes (rank, lex rank,
global slot, raw) are gathered onto the data row's first device and merged
with a stable two-key sort, so the reference's (rank, id) tie-break survives
end to end. A device may appear in the grid more than once: its shards are
then virtual (several shards, one card), and a gather between them is no
copy. Across cards a gather is a peer copy. ``sharded_search`` searches
blocks already placed on the mesh, as JAX's does; ``ShardedFlat`` builds
and keeps such blocks for a collection.
"""

from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from ..index import flat as flat_index
from ..index.flat import _search_kernel, resolve_device
from ..observability import count, span
from ..ops import flat_scan
from ..ops.topk import lex_sort

_BIG32 = 2**31 - 1


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index (``"cuda"``
    is card 0)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


class Mesh:
    """A ``[data, shard]`` grid of torch devices with the axis sizes in
    ``shape`` (``jax.sharding.Mesh``'s ``shape``). ``gathered_bytes`` counts
    the bytes the merges gathered (``parallel/cost.py``), ``reruns`` the
    shard batches ``sharded_search`` reran on the plain scan."""

    def __init__(self, grid):
        self.devices = tuple(tuple(_device(d) for d in row) for row in grid)
        self.shape = {"data": len(self.devices), "shard": len(self.devices[0])}
        self.gathered_bytes = 0
        self.reruns = 0

    @property
    def first(self) -> torch.device:
        """The device of the collection's single-device work and of every
        result (the grid's first)."""
        return self.devices[0][0]

    def distinct(self) -> list:
        """The grid's devices, each once."""
        return list(dict.fromkeys(d for row in self.devices for d in row))

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={[[str(d) for d in r] for r in self.devices]})"

    def copies(self, s: int, piece) -> list:
        """``piece`` (a host array, a tensor, or a tuple or dict of them
        beside plain values) on shard ``s``'s device in every data row:
        ``[data]`` entries, one copy per distinct device."""
        made = {}
        for row in self.devices:
            if row[s] not in made:
                made[row[s]] = _to(piece, row[s])
        return [made[row[s]] for row in self.devices]

    def place(self, pieces) -> "Blocks":
        """Shard ``s`` of ``pieces`` (host arrays or tensors, one per shard)
        on every device of grid column ``s``, one tensor per distinct
        device."""
        cols = [self.copies(s, p) for s, p in enumerate(pieces)]
        return Blocks(self, [[col[r] for col in cols] for r in range(self.shape["data"])])

    def shard_rows(self, block) -> "Blocks":
        """A ``[S * n_loc, ...]`` block cut into its ``S`` row shards and
        placed (``place``)."""
        n_loc = block.shape[0] // self.shape["shard"]
        return self.place([block[s * n_loc:(s + 1) * n_loc]
                           for s in range(self.shape["shard"])])

    def gather(self, per_shard, device):
        """The merge's gather (``all_gather(..., "shard", tiled=True)``):
        ``per_shard`` holds one tuple of ``[b, c]`` planes per shard; returns
        each plane concatenated over the shards along dim 1, on ``device``."""
        out = tuple(torch.cat([planes[i].to(device) for planes in per_shard], dim=1)
                    for i in range(len(per_shard[0])))
        self.gathered_bytes += sum(t.numel() * t.element_size() for t in out)
        return out

    def replicate(self, t, row: int) -> list:
        """A merged tensor copied to each shard device of grid row ``row``
        (one copy per distinct device): the replicated result of a merge."""
        made = {}
        for dev in self.devices[row]:
            if dev not in made:
                made[dev] = t.to(dev)
        return [made[dev] for dev in self.devices[row]]


def _to(piece, dev):
    if isinstance(piece, np.ndarray):
        piece = torch.from_numpy(np.ascontiguousarray(piece))
    if isinstance(piece, torch.Tensor):
        return piece.to(dev)
    if isinstance(piece, tuple):
        return tuple(_to(p, dev) for p in piece)
    if isinstance(piece, dict):
        return {k: _to(p, dev) for k, p in piece.items()}
    return piece


def make_mesh(devices=None, *, data: int = 1) -> Mesh:
    """Builds a ``(data, shard)`` mesh over the given devices, or over every
    CUDA device (``cuda:0`` .. ``cuda:{n-1}``) when none are given. A device
    may repeat
    (``[torch.device("cuda", 0)] * 4``: four virtual shards on one card);
    the CPU tests pass ``["cpu"] * n``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every CUDA device, and CUDA is not "
                               "available; pass devices (e.g. ['cpu'] * 2)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if n == 0 or n % data != 0:
        raise ValueError(f"{n} devices not divisible by data={data}")
    per = n // data
    return Mesh([devices[r * per:(r + 1) * per] for r in range(data)])


class Blocks:
    """A block row-sharded over a mesh: ``parts[r][s]`` is shard ``s`` on
    device ``mesh.devices[r][s]``; data rows share one tensor per distinct
    device."""

    def __init__(self, mesh: Mesh, parts):
        self.mesh = mesh
        self.parts = parts
        #: ``derived``'s memos by name: ``{id(t): (weakref of t, stamp, fn(t))}``
        self._derived = {}

    def shard(self, s: int, row: int = 0) -> torch.Tensor:
        return self.parts[row][s]

    @property
    def rows(self) -> int:
        """Rows per shard."""
        return self.parts[0][0].shape[0]

    def map(self, fn) -> "Blocks":
        """``fn`` of every distinct shard tensor, with the same sharing."""
        made = {}
        parts = []
        for row in self.parts:
            out = []
            for t in row:
                if id(t) not in made:
                    made[id(t)] = fn(t)
                out.append(made[id(t)])
            parts.append(out)
        return Blocks(self.mesh, parts)

    def derived(self, name: str, fn) -> "Blocks":
        """``map(fn)`` kept under ``name``: a later call returns the same
        tensors of the shards that are unchanged, and runs ``fn`` again only
        on a shard tensor that is new in ``parts`` or was written since.

        A shard is known by the tensor itself (a weak reference, so a part
        replaced in ``parts`` is a new shard), its ``data_ptr()`` and its
        version counter, which every in-place torch write bumps: ``copy_``,
        ``mul_``, ``index_put_``, slice assignment, a write through a view.
        The key does not see a write behind torch's back (through ``.data``
        or a raw pointer); a tensor made under ``torch.inference_mode``
        keeps no version, and its ``fn`` runs on every call. JAX's arrays
        never change in place, so this memo is the port's one departure
        from the reference."""
        old = self._derived.get(name, {})
        memo = {}

        def kept(t):
            stamp = None if t.is_inference() else (t.data_ptr(), t._version)
            hit = old.get(id(t))
            if stamp is None or hit is None or hit[0]() is not t or hit[1] != stamp:
                hit = (weakref.ref(t), stamp, fn(t))
            memo[id(t)] = hit
            return hit[2]

        out = self.map(kept)
        self._derived[name] = memo  # the present shards only: a replaced part's entry goes
        return out


def pad_batch(mesh: Mesh, rows):
    """``rows`` (an array or tensor ``[B, ...]``) padded to a whole number
    of data rows by repeats of its first row: the sync paths' batches. A
    repeat, not a zero row, keeps a fused scan's per-batch checks what the
    real rows make them (a zero query ties every rank)."""
    pad = (-len(rows)) % mesh.shape["data"]
    if not pad:
        return rows
    if isinstance(rows, torch.Tensor):
        return torch.cat([rows, rows[:1].expand(pad, *rows.shape[1:])])
    return np.concatenate([rows, np.repeat(rows[:1], pad, axis=0)])


def row_queries(mesh: Mesh, queries):
    """Splits a ``[B, ...]`` batch (``B`` a multiple of ``data``) into the
    data rows' batches, each as ``{device: tensor}`` over the row's distinct
    devices."""
    data = mesh.shape["data"]
    if queries.shape[0] % data:
        raise ValueError(f"a batch of {queries.shape[0]} is not a multiple of data={data}")
    b = queries.shape[0] // data
    out = []
    for r, row in enumerate(mesh.devices):
        q = queries[r * b:(r + 1) * b]
        out.append({dev: q.to(dev) for dev in dict.fromkeys(row)})
    return out


def to_first(mesh: Mesh, per_row):
    """The data rows' outputs (tuples of tensors) concatenated on the mesh's
    first device."""
    return tuple(torch.cat([out[i].to(mesh.first) for out in per_row])
                 for i in range(len(per_row[0])))


def _local_topk(x, valid, lex_order, q, *, metric, k):
    """The plain per-shard exact top-k (JAX's ``_local_topk``): raw scores
    of every row, rank, and the ``k`` best by (rank, lex id) through
    ``index.flat._search_kernel``. Returns ``(slots, raws, ranks)``."""
    slots, raws, ranks, _finite = _search_kernel(x, valid, lex_order, q, metric=metric,
                                                 limit=min(k, x.shape[0]))
    return slots, raws, ranks


def _merge_hits(mesh, per_shard, device, k):
    """Exact merge of per-shard ``(rank, lex, global slot, raw)`` planes:
    the ``k`` best by (rank, lex). Returns ``(slots [b, k], raws [b, k])``,
    slot -1 where the rank is not finite."""
    r, lex, s, w = mesh.gather(per_shard, device)
    order = lex_sort(r, lex)[:, :k]
    rm, sm, wm = r.gather(1, order), s.gather(1, order), w.gather(1, order)
    return torch.where(torch.isfinite(rm), sm, -1), wm


def _row_sq(x):
    """Squared norms of the rows of ``x`` in f32, in one pass over it (no
    temporary of ``x``'s size: a shard may fill most of its card); each pass
    is counted in ``mesh.norms``."""
    count("mesh.norms")
    return torch.linalg.vector_norm(x, dim=1, dtype=torch.float32).square()


def _bias(valid):
    """0 on valid rows, +inf on the rest: the fused scan's row bias."""
    return torch.where(valid, 0.0, float("inf")).float()


def _ok_on_host(flag) -> bool:
    """A fused shard search's ok flag, read on the host (a wait for its
    card)."""
    with span("mesh.wait"):
        return bool(flag)


def _search_shards(mesh, x, valid, lex, queries, *, metric, k, stride, xsq=None, bias=None):
    """The sharded exact search that ``sharded_search`` and
    ``ShardedFlat.search_device`` share, over ``Blocks`` ``x`` (f32 or bf16
    rows), ``valid`` (bool) and ``lex`` (int32 lex ranks). Each shard runs
    the fused search (K1 + K2) when its rows allow it, else the plain scan
    (JAX's ``_local_topk``, in the lex permutation's tie order); a fused
    shard batch that is not ``ok`` (a tie spill past the slack, or a batch
    that fails the overflow bound) reruns on the plain scan. ``xsq`` and
    ``bias`` are derived from the blocks unless given, once for a block
    (``Blocks.derived``): a call over unchanged blocks runs no norm pass.
    Shard ``s``'s local row ``i`` is global slot ``s * stride + i``.
    Returns ``(slots [B, k] int32, -1 where the rank is not finite; raws
    [B, k])`` on the mesh's first device, and the number of reruns."""
    fused = x.rows >= flat_index.FUSED_ROWS_MIN and flat_scan.supports(metric, x.rows, k)
    if fused:
        if xsq is None:
            count("mesh.norms", 0)  # so that a traced call that runs none reads 0
            xsq = x.derived("row_sq", _row_sq)
        bias = bias if bias is not None else valid.derived("bias", _bias)

    def plain(s, r, q):
        order = torch.argsort(lex.shard(s, r), stable=True)
        return _local_topk(x.shard(s, r), valid.shard(s, r), order, q, metric=metric, k=k)

    reruns = 0
    per_row = []
    for r, qs in enumerate(row_queries(mesh, queries)):
        outs = []
        for s, dev in enumerate(mesh.devices[r]):
            with span("mesh.launch"):
                if fused:
                    outs.append(flat_scan.fused_flat_search(
                        x.shard(s, r), xsq.shard(s, r), bias.shard(s, r), lex.shard(s, r),
                        qs[dev], metric=metric, k=k))
                else:
                    outs.append(plain(s, r, qs[dev]))
        per_shard = []
        for s, dev in enumerate(mesh.devices[r]):
            slots, raws, ranks = outs[s][:3]
            if fused and not _ok_on_host(outs[s][3]):
                # tie spill or overflow bound: this shard's exact plain scan
                reruns += 1
                slots, raws, ranks = plain(s, r, qs[dev])
            # int32 lex and slot planes, as JAX's (parallel/cost.py)
            lx = lex.shard(s, r)[slots]
            per_shard.append((ranks, lx.where(torch.isfinite(ranks), _BIG32),
                              (slots + s * stride).int(), raws))
        per_row.append(_merge_hits(mesh, per_shard, mesh.devices[r][0], k))
    return (*to_first(mesh, per_row), reruns)


class ShardedFlat:
    """A flat exact index sharded across a mesh.

    Rows split as in JAX (``per = ceil(n / S)`` rows to a shard, in the
    caller's order), and each shard pads its rows to a multiple of
    ``flat_scan.GROUP`` with zero rows (bias +inf, lex ``_BIG32``, invalid),
    so the fused kernels serve every shard of 1,024 rows or more. The host
    keeps ids and the id → row map; the device shards are rebuildable from
    them, as in the single-device design.

    A shard batch whose fused search is not ``ok`` (a tie spill past the
    slack, or a batch that fails the overflow bound) reruns on the plain
    scan, which computes what JAX's ``_local_topk`` computes; ``reruns``
    counts those shard batches."""

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, storage: str = "f32"):
        self.metric = metric
        self.mesh = mesh
        self.storage = storage
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")
        per = max(1, math.ceil(n / shards))
        rows = -(-per // flat_scan.GROUP) * flat_scan.GROUP
        order = np.argsort(np.array(ids, dtype=str), kind="stable")
        lex_rank = np.zeros(n, dtype=np.int32)
        lex_rank[order] = np.arange(n, dtype=np.int32)
        x = np.zeros((shards, rows, d), dtype=np.float32)
        valid = np.zeros((shards, rows), dtype=bool)
        lex = np.full((shards, rows), _BIG32, dtype=np.int32)
        for s in range(shards):
            lo, hi = min(s * per, n), min((s + 1) * per, n)
            x[s, : hi - lo] = vectors[lo:hi]
            valid[s, : hi - lo] = True
            lex[s, : hi - lo] = lex_rank[lo:hi]
        self.ids = list(ids)
        self.n = n
        self.per = per
        self._slot_of = {str(id): i for i, id in enumerate(ids)}
        self._valid_host = valid
        xt = torch.from_numpy(x)
        if storage == "bf16":
            # half the device bytes per shard; K1 scans bf16 products
            xt = xt.to(torch.bfloat16)
        xf = xt.float()
        xsq = (xf * xf).sum(dim=2)  # of the stored values
        del xf
        #: per-shard search state: rows, squared norms, lex ranks
        self._x = mesh.place(list(xt))
        self._xsq = mesh.place(list(xsq))
        self._lex = mesh.place(list(torch.from_numpy(lex)))
        self._set_valid()
        #: shard batches rerun on the plain scan (fused search not ok)
        self.reruns = 0

    def _set_valid(self) -> None:
        valid = [torch.from_numpy(v.copy()) for v in self._valid_host]
        self._valid = self.mesh.place(valid)
        self._bias = self.mesh.place([_bias(v) for v in valid])

    def invalidate_ids(self, ids) -> None:
        """Masks rows out of the search (delete without resharding: the
        shards' validity and bias rows are re-sent; the rows stay)."""
        changed = False
        for id in ids:
            slot = self._slot_of.get(str(id))
            if slot is not None and self._valid_host[slot // self.per, slot % self.per]:
                self._valid_host[slot // self.per, slot % self.per] = False
                changed = True
        if changed:
            self._set_valid()

    @span("mesh.search")
    def search_device(self, queries, k: int):
        """Device search of a prepared ``[B, d]`` f32 batch (``B`` a
        multiple of ``data``): ``(slots [B, k] global rows, -1 where fewer
        hits; raws [B, k])`` on the mesh's first device."""
        slots, raws, reruns = _search_shards(
            self.mesh, self._x, self._valid, self._lex, queries, metric=self.metric, k=k,
            stride=self.per, xsq=self._xsq, bias=self._bias)
        self.reruns += reruns
        return slots, raws

    def search_batch(self, queries, limit: int) -> list:
        """Returns ``[(id, raw)]`` per query, merged across shards."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        k = min(limit, max(self.n, 1))
        slots, raws = (t.cpu().numpy() for t in self.search_device(
            torch.from_numpy(pad_batch(self.mesh, queries)), k))
        out = []
        for row in range(b):
            hits = [(self.ids[int(slot)], float(raw)) for slot, raw in zip(slots[row], raws[row])
                    if 0 <= slot < self.n]
            out.append(hits[:limit])
        return out


@span("mesh.search")
def sharded_search(mesh: Mesh, x, valid, lex_rank, queries, *, metric: str, k: int):
    """Sharded exact search over a row-sharded block (JAX's signature).

    ``x`` (``[rows, d]`` per shard, f32 or bf16), ``valid`` (``[rows]``
    bool) and ``lex_rank`` (``[rows]`` int32 global id-order rank per row,
    ``2**31 - 1`` for pads) are ``Blocks`` placed on ``mesh``
    (``mesh.place`` / ``mesh.shard_rows``); ``queries`` is ``[B, d]``, ``B``
    a multiple of ``data``. Returns ``(slots [B, k] int32 global row
    indices, raws [B, k])`` on ``mesh.first``: global slot = shard * rows
    per shard + local row, merged by (rank, lex rank), slot -1 where the
    rank is not finite. Each shard searches on its own device (the fused
    K1 + K2 search where its rows allow it; its row norms and bias are
    derived once and kept with ``x`` and ``valid``, see ``Blocks.derived``);
    ``mesh.reruns`` counts the shard batches that reran on the plain scan."""
    for name, block in (("x", x), ("valid", valid), ("lex_rank", lex_rank)):
        if not isinstance(block, Blocks) or block.mesh is not mesh:
            raise ValueError(f"{name} is not a block placed on this mesh (placed on another "
                             f"mesh, or not placed)")
    queries = torch.as_tensor(queries, dtype=torch.float32)
    slots, raws, reruns = _search_shards(mesh, x, valid, lex_rank, queries, metric=metric, k=k,
                                         stride=x.rows)
    mesh.reruns += reruns
    return slots, raws
