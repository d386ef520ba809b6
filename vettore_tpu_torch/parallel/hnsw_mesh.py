"""Mesh-sharded HNSW: one graph per shard, scatter-gather search.

The port of ``vettore_tpu/parallel/hnsw_mesh.py``. A collection past one
card's memory shards by rows: each shard builds an independent HNSW graph
over its rows on its own device (``hnsw_build.bulk_build``'s ``auto`` mode:
the kNN build from ``KNN_BUILD_MIN`` rows, the wave build below), and a
query batch searches every shard's graph (``hnsw_device.search_impl``: f32
traversal, hub seeds from the shard's prefix), then the per-shard top-k
candidates (rank, global lex rank, global row, raw) merge exactly, as
single-device search orders them.

Searching S smaller graphs with the same ef loses no recall against one big
graph (each shard's exact neighbours are a superset of the global top-k
restricted to that shard); the merge is exact over the candidates.

JAX stacks the shard graphs to one static ``[S, cap, ...]`` shape so that
``shard_map`` compiles once; here each shard keeps its own graph on its own
device, at its own shape, and the search reads it in place (a data row on
another device reads the copy placed there after each write). The global
row, lex and entry bookkeeping is JAX's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..index import hnsw_build, hnsw_device
from ..index.hnsw import validate_options
from ..metrics import normalize_metric
from ..ops.topk import lex_sort
from .mesh import Mesh, pad_batch, row_queries, to_first

_BIG32 = 2**31 - 1

#: lex-plane pad sentinel — global ranks stay strictly below it
_BIG_LEX = 2**30


class ShardedHnsw:
    """HNSW index sharded across the ``shard`` axis of a mesh."""

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, options=None):
        metric = normalize_metric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")
        per = math.ceil(n / shards)

        # global lex ranks for the deterministic merge tie-break
        order = np.argsort(np.array([str(i) for i in ids], dtype=str), kind="stable")
        global_lex = np.zeros(n, dtype=np.int32)
        global_lex[order] = np.arange(n, dtype=np.int32)

        graphs, row_of, lexs = [], [], []
        for s in range(shards):
            lo, hi = s * per, min((s + 1) * per, n)
            shard_ids = [str(ids[i]) for i in range(lo, hi)]
            if not shard_ids:
                shard_ids, shard_vecs = ["__pad__"], np.zeros((1, d), np.float32)
            else:
                shard_vecs = vectors[lo:hi]
            graph = hnsw_build.bulk_build(self.metric, self.params, shard_ids, shard_vecs,
                                          device=mesh.devices[0][s])
            graphs.append(graph)
            id_to_row = {str(ids[i]): i for i in range(lo, hi)}
            rows = np.array([id_to_row.get(gid, -1) for gid in graph.ids], dtype=np.int32)
            row_of.append(rows)
            # per-shard lex must use GLOBAL lex ranks so the merge tie-break
            # is identical to a single-device index
            lexs.append(np.where(rows >= 0, global_lex[np.maximum(rows, 0)], _BIG_LEX)
                        .astype(np.int64))

        self.ids = [str(i) for i in ids]
        self.n = n
        self.d = d
        self._graphs = graphs
        self._row_of = row_of
        self._mut = None  # _MeshMut once incrementally mutated
        self._lex_host = lexs
        #: per shard, its search operands on its device in every data row
        #: (``mesh.copies``), re-placed after each write to the shard, and
        #: the beam's parts over them (``hnsw_device.BeamGraphs``)
        self._placed = [None] * shards
        self._beams = [None] * shards
        #: per-shard device planes: global lex rank, global row (-1: none)
        self._lex = [None] * shards
        self._rows = [None] * shards
        for s in range(shards):
            self._upload(s)

    @classmethod
    def from_state(cls, metric, mesh, params, ids, shards):
        """A search-only index over shard graphs carried across from the
        JAX package (``convert.sharded_hnsw_state``): ``shards`` holds per
        shard ``(x, a0, up_index, up_adj, lex, rows, entry_slot,
        entry_level, lmax)`` tensors on the shard's device. Its writes need
        the graphs themselves, which such an index does not have."""
        self = cls.__new__(cls)
        self.metric = normalize_metric(metric)
        self.params = validate_options(params)
        self.mesh = mesh
        self.ids = [str(i) for i in ids]
        self.n = len(self.ids)
        self.d = int(shards[0][0].shape[1])
        self._graphs = None
        self._row_of = [s[5].cpu().numpy() for s in shards]
        self._mut = None
        self._placed = [mesh.copies(s, st) for s, st in enumerate(shards)]
        self._beams = [hnsw_device.BeamGraphs() for _ in shards]
        return self

    @property
    def live(self) -> int:
        """Number of live (searchable) records across every shard."""
        return sum(self._live_counts())

    def _live_counts(self) -> list:
        return [int((r >= 0).sum()) for r in self._row_of]

    # ---- search -------------------------------------------------------

    def _place(self, s: int) -> None:
        """Places shard ``s``'s search operands (its graph's arrays up to
        the slot high-water mark, the lex and row planes, the entry) on its
        device in every data row."""
        g = self._graphs[s]
        n = g.n
        self._placed[s] = self.mesh.copies(s, (
            g.x[:n], g.a0[:n], g.up_index[:n], g.up_adj, self._lex[s][:n], self._rows[s][:n],
            g.entry_slot, g.entry_level, g.lmax))
        self._beams[s] = hnsw_device.BeamGraphs()

    def search_device(self, queries, *, ef: int, k: int):
        """Beam search of a prepared ``[B, d]`` f32 batch (``B`` a multiple
        of ``data``) over every shard graph and the exact merge: ``(rows
        [B, k] global rows (-1 where fewer hits), raws [B, k])`` on the
        mesh's first device."""
        mesh = self.mesh
        per_row = []
        for r, qs in enumerate(row_queries(mesh, queries)):
            head = mesh.devices[r][0]
            per_shard = []
            for s, dev in enumerate(mesh.devices[r]):
                x, a0, upi, upa, lex, rows, entry_slot, entry_level, lmax = self._placed[s][r]
                cap = x.shape[0]
                # beams hub-seed from the shard's top-by-level prefix (bulk
                # slots are level-desc sorted); rows without a record (the
                # '__pad__' filler, tombstones) never seed
                h = min(hnsw_device.hub_count(cap), cap)
                slots, raws, dists = hnsw_device.search_impl(
                    x, a0, upi, upa, lex, entry_slot, entry_level, qs[dev],
                    metric=self.metric, lmax=lmax, ef=ef, limit=k,
                    max_steps=hnsw_device.step_bound(ef),
                    hub_slots=torch.arange(h, device=dev), hub_x=x[:h],
                    hub_valid=rows[:h] >= 0,
                    # tombstoned and pad slots keep routing but never surface
                    valid=rows >= 0, beams=self._beams[s])
                # drop pad nodes (row -1) BEFORE the merge: with finite
                # distances they would displace real candidates
                safe = slots.clamp_min(0)
                grows_raw = rows[safe]
                ok = (slots >= 0) & (grows_raw >= 0)
                per_shard.append((torch.where(ok, dists, float("inf")),
                                  torch.where(ok, lex[safe], _BIG32),
                                  torch.where(ok, grows_raw, -1), raws))
            d_all, l_all, r_all, w_all = mesh.gather(per_shard, head)
            order = lex_sort(d_all, l_all)[:, :k]
            dm, rm, wm = (t.gather(1, order) for t in (d_all, r_all, w_all))
            per_row.append((torch.where(torch.isfinite(dm), rm, -1), wm))
        return to_first(mesh, per_row)

    def search_batch(self, queries, limit: int) -> list:
        """Returns ``[(id, raw)]`` per query, exact merge across shard graphs."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        live = self.live if self._mut is not None or self._graphs is None else self.n
        ef = min(max(self.params["ef_search"], limit), max(live, 1))
        k = min(limit, max(live, 1))
        rows, raws = (t.cpu().numpy() for t in self.search_device(
            torch.from_numpy(pad_batch(self.mesh, queries)), ef=ef, k=k))
        out = []
        for row in range(b):
            hits = [(self.ids[int(gr)], float(raw)) for gr, raw in zip(rows[row], raws[row])
                    if gr >= 0]
            out.append(hits[:limit])
        return out

    # ------------------------------------------------------------------
    # incremental mutation (per-shard graph puts/deletes, no full rebuild)
    # ------------------------------------------------------------------
    #
    # Each new record routes to the least-loaded shard and links through
    # that shard's incremental wave (hnsw_build.incremental_put); only that
    # shard's lex and row planes are re-sent. Deletes tombstone like the
    # single-device path; a shard whose tombstones outgrow
    # hnsw_build.REBUILD_FRACTION compacts alone.
    #
    # The cross-shard (rank, id) merge needs one GLOBAL lex-rank space: the
    # mesh owns a spaced global rank table (the midpoint-insert and respace
    # scheme of hnsw_build._assign_lex), independent of each graph's
    # internal ranks.

    def _writable(self) -> None:
        if self._graphs is None:
            raise ValueError("an index carried across without its graphs only searches")

    def incremental_put(self, ids, vecs) -> None:
        """Insert/replace a batch across the shard graphs in place."""
        self._writable()
        ids = [str(i) for i in ids]
        vecs = np.ascontiguousarray(np.asarray(vecs, np.float32))
        last = {}
        for i, id in enumerate(ids):
            last[id] = i
        keep = sorted(last.values())
        ids = [ids[i] for i in keep]
        vecs = vecs[keep]
        if not ids:
            return
        mut = self._ensure_mesh_mutable()
        ranks, respaced = self._assign_global_lex(ids)

        counts = self._live_counts()
        per_shard: dict = {}
        for i, id in enumerate(ids):
            s = mut.shard_of.get(id)
            if s is None:  # new id -> least-loaded shard (replaces stay put)
                s = int(np.argmin(counts))
                counts[s] += 1
            per_shard.setdefault(s, []).append(i)

        for s, idxs in sorted(per_shard.items()):
            g = self._graphs[s]
            st = hnsw_build._ensure_mutable(g)
            sub_ids = [ids[i] for i in idxs]
            old_slots = [st.slot_of[i] for i in sub_ids if i in st.slot_of]
            hnsw_build.incremental_put(g, self.params, sub_ids, vecs[idxs])
            self._grow_shard_maps(s)
            row_of, glex = self._row_of[s], self._lex_host[s]
            for old in old_slots:  # replaced vectors vacated their old slot
                row_of[old] = -1
                glex[old] = _BIG_LEX
            for i in idxs:
                id = ids[i]
                slot = st.slot_of[id]
                row = mut.row_by_id.get(id)
                if row is None:
                    self.ids.append(id)
                    row = len(self.ids) - 1
                    mut.row_by_id[id] = row
                mut.shard_of[id] = s
                row_of[slot] = row
                glex[slot] = ranks[i]
            if hnsw_build.should_compact(g):
                self._compact_shard(s)
            else:
                self._upload(s)
        if respaced:
            for s in range(len(self._graphs)):
                self._upload(s)

    def incremental_delete(self, ids) -> int:
        """Tombstones ids out of their shard graphs; returns count removed."""
        self._writable()
        mut = self._ensure_mesh_mutable()
        per_shard: dict = {}
        for id in {str(i) for i in ids}:
            s = mut.shard_of.get(id)
            if s is not None:
                per_shard.setdefault(s, []).append(id)
        removed = 0
        for s, sub in sorted(per_shard.items()):
            g = self._graphs[s]
            st = hnsw_build._ensure_mutable(g)
            slots = np.asarray([st.slot_of[i] for i in sub if i in st.slot_of], np.int64)
            removed += hnsw_build.incremental_delete(g, sub)
            self._row_of[s][slots] = -1
            self._lex_host[s][slots] = _BIG_LEX
            for id in sub:
                mut.shard_of.pop(id, None)
            if hnsw_build.should_compact(g):
                self._compact_shard(s)
            else:  # validity and the entry's re-election only: two scatters
                sl = torch.from_numpy(slots).to(self._rows[s].device)
                self._rows[s][sl] = -1
                self._lex[s][sl] = _BIG_LEX
                self._place(s)
        return removed

    # ---- internals ----------------------------------------------------

    def _upload(self, s: int) -> None:
        """Re-sends shard ``s``'s lex and row planes (int32, at the graph's
        capacity) and re-places its search operands."""
        dev = self._graphs[s].x.device
        self._lex[s] = torch.from_numpy(self._lex_host[s].astype(np.int32)).to(dev)
        self._rows[s] = torch.from_numpy(self._row_of[s].astype(np.int32)).to(dev)
        self._place(s)

    def _ensure_mesh_mutable(self):
        if self._mut is not None:
            return self._mut
        mut = _MeshMut()
        mut.row_by_id = {}
        mut.shard_of = {}
        for s, row_of in enumerate(self._row_of):
            for row in row_of:
                if row >= 0:
                    id = self.ids[int(row)]
                    mut.row_by_id[id] = int(row)
                    mut.shard_of[id] = s
        live_ids = np.sort(np.array(list(mut.shard_of), dtype=str))
        mut.spacing = max(1, min(1024, (_BIG_LEX - 2) // max(len(live_ids), 1)))
        mut.sorted_ids = live_ids
        mut.sorted_ranks = np.arange(len(live_ids), dtype=np.int64) * mut.spacing
        for s, row_of in enumerate(self._row_of):
            glex = np.full(len(row_of), _BIG_LEX, np.int64)
            liv = np.flatnonzero(row_of >= 0)
            if len(liv):
                ids_s = np.array([self.ids[int(r)] for r in row_of[liv]], dtype=str)
                glex[liv] = mut.sorted_ranks[np.searchsorted(mut.sorted_ids, ids_s)]
            self._lex_host[s] = glex
        self._mut = mut
        for s in range(len(self._graphs)):  # dense build ranks -> spaced global
            self._upload(s)
        return mut

    def _assign_global_lex(self, ids):
        """Global (rank, id) ranks for a put batch: existing ids keep their
        rank, new ids bisect their lex gap; an exhausted gap (or a rank
        nearing the pad sentinel) respaces the whole table. Returns
        (int64 [B], respaced)."""
        mut = self._mut
        ids_np = np.array(ids, dtype=str)
        ns = len(mut.sorted_ids)
        pos = np.searchsorted(mut.sorted_ids, ids_np)
        exists = np.zeros(len(ids), bool)
        if ns:
            exists = (pos < ns) & (mut.sorted_ids[np.minimum(pos, ns - 1)] == ids_np)
        out = np.zeros(len(ids), np.int64)
        out[exists] = mut.sorted_ranks[pos[exists]] if ns else 0
        fresh = np.flatnonzero(~exists)
        if not len(fresh):
            return out, False
        order = fresh[np.argsort(ids_np[fresh], kind="stable")]
        gap_pos = pos[order]
        insert_ids = ids_np[order]
        new_ranks = np.zeros(len(order), np.int64)
        respace = False
        i = 0
        while i < len(order):
            j = i
            while j < len(order) and gap_pos[j] == gap_pos[i]:
                j += 1
            k = j - i
            left = (mut.sorted_ranks[gap_pos[i] - 1] if gap_pos[i] > 0
                    else -(mut.spacing * (k + 1)))
            right = (mut.sorted_ranks[gap_pos[i]] if gap_pos[i] < ns
                     else left + mut.spacing * (k + 1))
            if right - left <= k or right >= _BIG_LEX - 1:
                respace = True
                break
            step = (right - left) / (k + 1)
            new_ranks[i:j] = left + (np.arange(1, k + 1) * step).astype(np.int64)
            i = j
        if insert_ids.dtype.itemsize > mut.sorted_ids.dtype.itemsize:
            # widen first: np.insert truncates longer strings to the width
            mut.sorted_ids = mut.sorted_ids.astype(insert_ids.dtype)
        mut.sorted_ids = np.insert(mut.sorted_ids, gap_pos, insert_ids)
        mut.sorted_ranks = np.insert(mut.sorted_ranks, gap_pos, new_ranks)
        if respace:
            mut.spacing = max(1, min(1024, (_BIG_LEX - 2) // max(len(mut.sorted_ids), 1)))
            mut.sorted_ranks = np.arange(len(mut.sorted_ids), dtype=np.int64) * mut.spacing
            for s, glex in enumerate(self._lex_host):
                liv = np.flatnonzero(self._row_of[s] >= 0)
                if len(liv):
                    ids_s = np.array([self.ids[int(r)] for r in self._row_of[s][liv]],
                                     dtype=str)
                    glex[liv] = mut.sorted_ranks[np.searchsorted(mut.sorted_ids, ids_s)]
            allpos = np.searchsorted(mut.sorted_ids, ids_np)
            return mut.sorted_ranks[allpos], True
        out[order] = new_ranks
        return out, False

    def _grow_shard_maps(self, s) -> None:
        cap = self._graphs[s].x.shape[0]
        if len(self._row_of[s]) < cap:
            pad = cap - len(self._row_of[s])
            self._row_of[s] = np.concatenate([self._row_of[s], np.full(pad, -1, np.int32)])
            self._lex_host[s] = np.concatenate(
                [self._lex_host[s], np.full(pad, _BIG_LEX, np.int64)])

    def _compact_shard(self, s) -> None:
        """Rebuilds one shard's graph from its live slots (on its device);
        the other shards' graphs are untouched."""
        g = self._graphs[s]
        mut = self._mut
        fresh = hnsw_build.compact(g, self.params)
        if fresh is None:  # shard emptied: a single pad row, as at construction
            fresh = hnsw_build.bulk_build(self.metric, self.params, ["__pad__"],
                                          np.zeros((1, self.d), np.float32),
                                          device=g.x.device)
            self._graphs[s] = fresh
            self._row_of[s] = np.full(fresh.n, -1, np.int32)
            self._lex_host[s] = np.full(fresh.n, _BIG_LEX, np.int64)
            self._upload(s)
            return
        self._graphs[s] = fresh
        self._row_of[s] = np.array([mut.row_by_id.get(id, -1) for id in fresh.ids], np.int32)
        glex = np.full(fresh.n, _BIG_LEX, np.int64)
        idx = np.searchsorted(mut.sorted_ids, np.array(fresh.ids, dtype=str))
        ok = self._row_of[s] >= 0
        glex[ok] = mut.sorted_ranks[idx[ok]]
        self._lex_host[s] = glex
        self._upload(s)


class _MeshMut:
    """Host bookkeeping for an incrementally-mutated ShardedHnsw."""

    __slots__ = ("row_by_id", "shard_of", "sorted_ids", "sorted_ranks", "spacing")
