"""Mesh-sharded IVF: per-shard k-means routing blocks, an exact merge.

The port of ``vettore_tpu/parallel/ivf_mesh.py``. The IVF index
(``index/ivf.py``) sharded by rows across the ``shard`` axis of a mesh, the
scatter-gather shape of ``hnsw_mesh.ShardedHnsw``: each shard holds a
cluster-major block of its row range and that block's routing centroids on
its device in every data row (one copy per distinct device). A query
routes to its best ``n_probe`` blocks on each shard (``ops/ivf.bf16_dots``:
f32 sums of bf16-rounded operands), the probed rows are rescored by K2
(``ops/flat_scan.rescore``, the wrapper single-device IVF calls, where JAX
gathers the rows and runs an einsum), the winners' raws are recomputed in
full f32, and the per-shard top-k triples (rank, global lex, global row)
merge with a stable two-key sort — the (rank, id) tie-break survives end
to end. Probing P blocks on each of S shards examines S·P blocks, so
per-shard recall at a fixed ``n_probe`` is at least single-device recall.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import UnsupportedIvfMetric
from ..index.base import Index
from ..index.flat import FlatIndex
from ..index.ivf import IVF_METRICS, validate_options
from ..metrics import normalize_metric
from ..ops import flat_scan
from ..ops import ivf as ops_ivf
from ..ops.distance import no_tf32
from ..ops.flat_scan import GROUP, _group_rows
from ..ops.topk import lex_sort, smallest
from .mesh import Mesh, pad_batch, row_queries, to_first

_BIG32 = 2**31 - 1


class ShardedIvf:
    """IVF structure sharded across the ``shard`` axis of a mesh."""

    def __init__(self, metric: str, mesh: Mesh, ids, vectors, *, options=None):
        metric = normalize_metric(metric)
        if metric not in IVF_METRICS:
            raise UnsupportedIvfMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        shards = mesh.shape["shard"]
        vectors = np.asarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if len(ids) != n:
            raise ValueError("ids/vectors length mismatch")

        # global lex ranks (ids arrive in caller order; the merge needs the
        # id-sorted rank like every other sharded index here)
        order = np.argsort(np.array([str(i) for i in ids], dtype=str), kind="stable")
        global_lex = np.zeros(n, dtype=np.int32)
        global_lex[order] = np.arange(n, dtype=np.int32)

        per = max(GROUP, math.ceil(n / shards))
        capb = -(-per // GROUP) * GROUP
        ngb = capb // GROUP
        storage = torch.float32 if self.params["storage"] == "f32" else torch.bfloat16
        self._shards = []
        for s in range(shards):
            dev = mesh.devices[0][s]
            lo, hi = s * per, min((s + 1) * per, n)
            cnt = max(0, hi - lo)
            if cnt == 0:  # an empty shard: every block dead
                self._shards.append({
                    "x": torch.zeros((capb, d), dtype=storage, device=dev),
                    "xsq": torch.zeros(capb, device=dev),
                    "bias": torch.full((capb,), float("inf"), device=dev),
                    "lex": torch.full((capb,), _BIG32, dtype=torch.int32, device=dev),
                    "rows": torch.full((capb,), -1, dtype=torch.int32, device=dev),
                    "bcb": torch.zeros((ngb, d), dtype=torch.bfloat16, device=dev),
                    "csq": torch.zeros(ngb, device=dev),
                    "bbias": torch.full((ngb,), float("inf"), device=dev)})
                continue
            block = np.zeros((capb, d), np.float32)
            block[:cnt] = vectors[lo:hi]
            valid = np.zeros(capb, bool)
            valid[:cnt] = True
            xdev = torch.from_numpy(block).to(dev)
            vdev = torch.from_numpy(valid).to(dev)
            assign = ops_ivf.kmeans_assign(xdev, vdev, n_cent=ngb,
                                           iters=self.params["kmeans_iters"], metric=metric)
            perm = torch.sort(assign, stable=True).indices  # block slot -> shard row
            xs = xdev[perm]
            valid_sorted = vdev[perm]
            bcb, csq, bbias, xsq, bias = ops_ivf.build_blocks(xs, valid_sorted, metric=metric)
            perm_np = perm.cpu().numpy()
            ok = valid[perm_np]
            src = lo + perm_np  # block slot -> global row (pads map past hi)
            rows = np.where(ok, src, -1).astype(np.int32)
            lex = np.where(ok, global_lex[np.minimum(src, n - 1)], _BIG32).astype(np.int32)
            self._shards.append({
                "x": xs.to(storage), "xsq": xsq, "bias": bias,
                "lex": torch.from_numpy(lex).to(dev), "rows": torch.from_numpy(rows).to(dev),
                "bcb": bcb, "csq": csq, "bbias": bbias})
        self.ids = [str(i) for i in ids]
        self.n = n
        self.d = d
        self.capb = capb
        self._place()
        #: {"n_probe", "recall_at_10", "target"} after an auto-tune build
        self.tuned: dict | None = None
        if self.params["n_probe"] == "auto":
            self._tune_n_probe(vectors)

    @classmethod
    def from_state(cls, metric, mesh, ids, shards, *, options=None, tuned=None):
        """An index over shard blocks carried across from the JAX package
        (``convert.sharded_ivf_state``): ``shards`` holds per shard a dict
        of its ``x``, ``xsq``, ``bias``, ``lex``, ``rows``, ``bcb``, ``csq``
        and ``bbias`` tensors, on the shard's device."""
        self = cls.__new__(cls)
        self.metric = normalize_metric(metric)
        self.params = validate_options(options)
        self.mesh = mesh
        self._shards = list(shards)
        self.ids = [str(i) for i in ids]
        self.n = len(self.ids)
        self.capb, self.d = (int(v) for v in shards[0]["x"].shape)
        self._place()
        self.tuned = None if tuned is None else dict(tuned)
        return self

    def _place(self) -> None:
        """Each shard's state on its device in every data row, one copy per
        distinct device (``_placed[s][r]``); ``_shards[s]`` is data row
        0's."""
        self._placed = [self.mesh.copies(s, st) for s, st in enumerate(self._shards)]
        self._shards = [copies[0] for copies in self._placed]
        self._rows_host = [st["rows"].cpu().numpy() for st in self._shards]

    def _tune_n_probe(self, vectors: np.ndarray) -> None:
        """``n_probe="auto"`` (``index/ivf.py``'s ``_tune_n_probe``,
        sharded): the smallest probe count whose recall@10 on a held-out row
        sample meets ``target_recall``; the ground truth probes every block
        (exact by the n_probe >= n_blocks contract)."""
        sample = min(64, self.n)
        pick = np.linspace(0, self.n - 1, sample).astype(np.int64)
        queries = vectors[pick]
        k = min(10, self.n)
        ngb = self.capb // GROUP
        truth = [{id for id, _ in row} for row in self._probe_batch(queries, k, ngb)]
        target = self.params["target_recall"]
        chosen, recall = None, 0.0
        for p in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
            if chosen is not None and p > ngb:
                break
            got = self._probe_batch(queries, k, min(p, ngb))
            recall = float(np.mean([
                len({id for id, _ in row} & want) / max(len(want), 1)
                for row, want in zip(got, truth)]))
            chosen = min(p, ngb)
            if recall >= target or p >= ngb:
                break
        self.tuned = {"n_probe": chosen, "recall_at_10": round(recall, 4), "target": target}

    def effective_n_probe(self) -> int:
        """The probe count searches actually use (auto resolves at build)."""
        p = self.params["n_probe"]
        if p == "auto":
            return self.tuned["n_probe"] if self.tuned else 8
        return p

    def invalidate_rows(self, global_rows) -> None:
        """Masks global rows out of results (delete without rebuild): bias
        +inf at their block slots, in place on each shard's device."""
        targets = np.asarray(sorted(int(r) for r in global_rows), dtype=np.int64)
        for s, rows in enumerate(self._rows_host):
            hit = np.flatnonzero(np.isin(rows, targets))
            if len(hit):
                for bias in {id(st["bias"]): st["bias"] for st in self._placed[s]}.values():
                    bias[torch.from_numpy(hit).to(bias.device)] = float("inf")

    def search_batch(self, queries, limit: int) -> list:
        ngb = self.capb // GROUP
        return self._probe_batch(queries, limit, min(self.effective_n_probe(), ngb))

    def _shard_search(self, st, q, *, nprobe, k):
        """One shard's probed top-k: ``(rank, lex, global row, raw)``
        planes ``[b, k]``, rank +inf (lex ``_BIG32``, row -1) where fewer
        hits."""
        xs, metric = st["x"], self.metric
        ngb = xs.shape[0] // GROUP
        qf = q.float()
        dots = ops_ivf.bf16_dots(qf, st["bcb"])  # [b, ngb]
        if metric in ("cosine", "inner_product"):
            crank = -dots
        elif metric == "negative_inner_product":
            crank = dots
        else:
            crank = st["csq"][None, :] - 2.0 * dots
        crank = crank + st["bbias"][None, :]
        # XLA's top_k breaks ties to the lowest index: a stable sort does
        _v, gidx = smallest(crank, nprobe)
        gidx = gidx.clamp_max(ngb - 1)
        b = qf.shape[0]
        crk = flat_scan.rescore(xs, st["xsq"], st["bias"], qf, gidx.int(),
                                metric=metric).reshape(b, -1)  # [b, p*64]
        slots = _group_rows(gidx).reshape(b, -1)
        clex = torch.where(torch.isfinite(crk), st["lex"][slots], _BIG32)
        kk = min(k, crk.shape[1])
        order = lex_sort(crk, clex)[:, :kk]
        rank_s, lex_s, slot_s = (t.gather(1, order) for t in (crk, clex, slots))
        if kk < k:
            pad = k - kk
            rank_s = torch.nn.functional.pad(rank_s, (0, pad), value=float("inf"))
            lex_s = torch.nn.functional.pad(lex_s, (0, pad), value=_BIG32)
            slot_s = torch.nn.functional.pad(slot_s, (0, pad), value=0)
        found = torch.isfinite(rank_s)
        grows = torch.where(found, st["rows"][slot_s], -1)
        # the winners' raws in full f32 (the flat _finalize posture)
        win = xs[slot_s].float()  # [b, k, d]
        if metric in ("l2", "l2_squared"):
            diff = win - qf[:, None, :]
            sq = (diff * diff).sum(dim=-1)
            raw = sq.sqrt() if metric == "l2" else sq
            rank_m = raw
        else:
            no_tf32(win)
            rdots = torch.einsum("bkd,bd->bk", win, qf)
            raw = -rdots if metric == "negative_inner_product" else rdots
            rank_m = (1.0 - raw) if metric == "cosine" else (
                -raw if metric == "inner_product" else raw)
        return torch.where(found, rank_m, float("inf")), lex_s, grows, raw

    def search_device(self, queries, *, nprobe: int, k: int):
        """Probed search of a prepared ``[B, d]`` f32 batch (``B`` a
        multiple of ``data``) on every shard and the exact merge: ``(rows
        [B, k] global rows (-1 where fewer hits), raws [B, k])`` on the
        mesh's first device."""
        mesh = self.mesh
        per_row = []
        for r, qs in enumerate(row_queries(mesh, queries)):
            head = mesh.devices[r][0]
            per_shard = []
            for s, dev in enumerate(mesh.devices[r]):
                per_shard.append(self._shard_search(self._placed[s][r], qs[dev],
                                                    nprobe=nprobe, k=k))
            d_all, l_all, r_all, w_all = mesh.gather(per_shard, head)
            order = lex_sort(d_all, l_all)[:, :k]
            dm, rm, wm = (t.gather(1, order) for t in (d_all, r_all, w_all))
            per_row.append((torch.where(torch.isfinite(dm), rm, -1), wm))
        return to_first(mesh, per_row)

    def _probe_batch(self, queries, limit: int, nprobe: int) -> list:
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        k = min(limit, max(self.n, 1))
        rows, raws = (t.cpu().numpy() for t in self.search_device(
            torch.from_numpy(pad_batch(self.mesh, queries)), nprobe=nprobe, k=k))
        out = []
        for row in range(b):
            hits = [(self.ids[int(gr)], float(raw)) for gr, raw in zip(rows[row], raws[row])
                    if gr >= 0]
            out.append(hits[:limit])
        return out


class MeshIvfIndex(Index):
    """IVF sharded over a mesh, in the Index behaviour
    (lib/vettore/index.ex:12-17): a host mirror for validation and the
    canonical rows, a full relayout on inserts, bias flips on delete."""

    def __init__(self, metric: str, options=None, *, mesh):
        metric = normalize_metric(metric)
        if metric not in IVF_METRICS:
            raise UnsupportedIvfMetric(metric)
        self.metric = metric
        self.params = validate_options(options)
        self.mesh = mesh
        self.device = mesh.first
        self._host = FlatIndex(metric, device=mesh.first)
        self._sharded: ShardedIvf | None = None
        self._built_version = -1
        self._version = 0
        self._built_row_of: dict = {}  # id -> global row in the built layout

    def __len__(self):
        return len(self._host)

    @property
    def dimension(self):
        return self._host.dimension

    @property
    def _slot_of(self):
        return self._host._slot_of

    def put(self, id: str, vector) -> None:
        self.put_many([(id, vector)])

    def put_many(self, pairs) -> None:
        self._host.put_many(pairs)
        self._version += 1

    def put_matrix(self, ids, matrix) -> None:
        self._host.put_matrix(ids, matrix)
        self._version += 1

    def delete(self, id: str) -> None:
        existed = id in self._host._slot_of
        self._host.delete(id)
        if not existed:
            return
        if self._sharded is not None and self._built_version == self._version:
            row = self._built_row_of.get(str(id))
            if row is not None:
                self._sharded.invalidate_rows([row])
            self._version += 1
            self._built_version = self._version
        else:
            self._version += 1

    def _sync(self):
        if self._sharded is not None and self._built_version == self._version:
            return
        host = self._host
        if host._host_x is None or not host._slot_of:
            self._sharded = None
            self._built_version = self._version
            self._built_row_of = {}
            return
        live = sorted(host._slot_of)
        rows = host._host_x[np.array([host._slot_of[id] for id in live], dtype=np.int64)]
        self._sharded = ShardedIvf(self.metric, self.mesh, live, rows, options=self.params)
        self._built_row_of = {id: i for i, id in enumerate(live)}
        self._built_version = self._version

    def search(self, query, limit: int) -> list:
        return self.search_batch(np.asarray(query, np.float32)[None, :], limit)[0]

    def search_batch(self, queries, limit: int) -> list:
        if limit == 0:
            return [[] for _ in range(len(queries))]
        self._sync()
        if self._sharded is None:
            return [[] for _ in range(len(queries))]
        return self._sharded.search_batch(queries, limit)
