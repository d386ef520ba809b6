"""Bulk HNSW construction on the device: the parts the default build needs.

The port of the default path of ``vettore_tpu/index/hnsw_build.py``: the
shared build preamble (:func:`_prep_order`: deterministic FNV-1a levels,
(level desc, id) slot order, lexicographic tie-break ranks, the upper-layer
row map), Malkov's diversity heuristic (:func:`_heuristic_select`), the
:class:`BulkGraph` every bulk build produces, and :func:`bulk_build`, which
routes ``build="auto"`` / ``"knn"`` to the cluster-blocked kNN build
(``hnsw_knn_build.py``).

:func:`save_graph` / :func:`load_graph` write and read a bulk graph as the
JAX package's ``.npz`` file (the same keys, dtypes and ``GRAPH_MAGIC``), so
either package loads the other's files.

Not ported yet, and refused with a message that says so: the wave build
(``build="wave"``, and ``"auto"`` below ``KNN_BUILD_MIN`` rows), which also
carries incremental mutation and compaction of bulk graphs. The build reads
``params["build"]`` only; the JAX package's ``VETTORE_HNSW_BUILD`` /
``VETTORE_BUILD_*`` environment overrides are not carried over.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..errors import InvalidIndex
from .flat import resolve_device
from .hnsw import levels_batch
from .hnsw_device import DeviceGraph, hub_count

_BIG32 = 2**31 - 1


def _heuristic_select(cand_ids, cand_dists, P, deg):
    """Diversity selection over candidates sorted ascending by distance-to-base
    (Malkov's select-neighbors heuristic, the bulk builds' neighbour choice).

    The reference prunes by plain distance truncation (hnsw.rs:437-465),
    which severs inter-cluster bridges on clustered corpora and caps recall;
    the heuristic keeps a candidate only when it is closer to the base point
    than to every already-kept neighbor, preserving one edge per
    "direction" — a construction-side change only, query semantics are
    unchanged. (The JAX package's ``HEURISTIC_SELECTION = False`` branch,
    plain truncation, is not ported.)

    Keeps candidate j when it is closer to the base than to every kept
    neighbor; remaining slots fill with the closest pruned candidates
    (hnswlib's keepPrunedConnections). Shapes: cand_ids/cand_dists [..., C],
    P [..., C, C] pairwise candidate distances. Returns (ids [..., deg],
    dists [..., deg]), -1 / +inf where fewer than ``deg`` are valid.
    """
    C = cand_ids.shape[-1]
    valid = torch.isfinite(cand_dists) & (cand_ids >= 0)
    # sequential scan in ascending-distance order: mdk[i] is candidate i's
    # distance to the closest KEPT neighbor so far. An invalid candidate's
    # distance is +inf here, which is never below mdk: it is never kept.
    # (Few tensor calls per step: on the card this loop is bound by them.)
    dist = cand_dists.masked_fill(~valid, float("inf"))
    mdk = torch.full(cand_dists.shape, float("inf"), device=cand_dists.device)
    count = torch.zeros(cand_dists.shape[:-1], dtype=torch.int64, device=cand_dists.device)
    keeps = []
    for j in range(C):
        keep = (dist[..., j] < mdk[..., j]) & (count < deg)
        mdk = torch.where(keep[..., None], torch.minimum(mdk, P[..., :, j]), mdk)
        count += keep
        keeps.append(keep)
    kept = torch.stack(keeps, dim=-1)

    # kept candidates first (in distance order), then pruned-but-valid fills
    pos = torch.arange(C, device=valid.device).expand(valid.shape)
    key = torch.where(kept, pos, torch.where(valid, C + pos, 2 * C + pos))
    order = torch.sort(key, dim=-1).indices[..., :deg]  # keys are distinct
    sel = cand_ids.gather(-1, order)
    sel_d = cand_dists.gather(-1, order)
    ok = key.gather(-1, order) < 2 * C
    return (torch.where(ok, sel, torch.full_like(sel, -1)),
            torch.where(ok, sel_d, torch.full_like(sel_d, float("inf"))))


class BulkGraph(DeviceGraph):
    """:class:`DeviceGraph` produced by a bulk build. Slots are (level
    desc, id) ordered, so the hub set is simply the first H slots, the upper
    layers' nodes are slot prefixes, and slot 0 is the entry. ``levels``
    ([n] int32 numpy, slot order) and ``lex_spacing`` (1: ranks are dense)
    are kept as the JAX package keeps them."""

    def __init__(self, *, ids, n, m, m0, lmax, metric, x, a0, up_index, up_adj, lex_rank,
                 entry_slot, entry_level, levels, valid=None, lex_spacing=1):
        super().__init__(ids=ids, n=n, m=m, m0=m0, lmax=lmax, metric=metric, x=x, a0=a0,
                         up_index=up_index, up_adj=up_adj, lex_rank=lex_rank,
                         entry_slot=entry_slot, entry_level=entry_level,
                         hub_slots=np.arange(hub_count(n), dtype=np.int32), valid=valid)
        self.levels = levels
        self.lex_spacing = lex_spacing
        self._id_set = None

    @property
    def id_set(self) -> frozenset:
        """The graph's ids (lazy)."""
        if self._id_set is None:
            self._id_set = frozenset(self.ids)
        return self._id_set

    @property
    def live(self) -> int:
        """Records in the graph (slots not tombstoned)."""
        if self.valid is None:
            return self.n
        return int(self.valid[: self.n].sum())


GRAPH_MAGIC = "vettore-tpu-hnsw-graph-v1"


def _np32(t) -> np.ndarray:
    return t.cpu().numpy().astype(np.int32, copy=False)


def save_graph(graph: BulkGraph, path: str, *, include_x: bool = True) -> None:
    """Serializes a bulk-built graph to an ``.npz`` (atomic tmp + rename).

    The graph is an acceleration structure — the canonical data always lives
    in the host store — so this is a cache format, not a durability format:
    rebuilding from canonical records gives an equivalent graph.
    ``include_x=False`` omits the ``[n, d]`` vector block for callers that
    already hold the same vectors on the device (pass ``x_device`` at load).
    A graph with tombstoned slots (one loaded from such a file) writes its
    ``valid`` mask, as the JAX package's mutated graphs do."""
    n = graph.n
    payload = {
        "magic": np.array(GRAPH_MAGIC),
        "ids": np.array(graph.ids, dtype=str),
        "n": np.int64(n),
        "m": np.int64(graph.m),
        "m0": np.int64(graph.m0),
        "lmax": np.int64(graph.lmax),
        "metric": np.array(graph.metric),
        "a0": _np32(graph.a0[:n]),
        "up_index": _np32(graph.up_index[:n]),
        "up_adj": _np32(graph.up_adj),
        "lex_rank": _np32(graph.lex_rank[:n]),
        "entry_slot": np.int64(graph.entry_slot),
        "entry_level": np.int64(graph.entry_level),
        "levels": np.asarray(graph.levels, dtype=np.int32)[:n],
        "lex_spacing": np.int64(graph.lex_spacing),
    }
    if graph.valid is not None and not bool(graph.valid[:n].all()):
        payload["valid"] = graph.valid[:n].cpu().numpy()
    if include_x:
        payload["x"] = graph.x[:n].float().cpu().numpy()
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_graph(path: str, *, x_device=None, device="cuda") -> BulkGraph:
    """Loads a graph saved by :func:`save_graph` (of either package) onto
    ``device``. ``x_device`` supplies the ``[n, d]`` f32 vector block, in
    graph slot order and on ``device``, when the file was written with
    ``include_x=False`` (or to share one device copy). The file is read
    with ``allow_pickle=False``."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != GRAPH_MAGIC:
            raise ValueError(f"not a vettore graph file: {path}")
        ids = [str(i) for i in z["ids"]]
        n = int(z["n"])
        if x_device is not None:
            x = x_device
            if x.shape[0] != n:
                raise ValueError("x_device row count does not match graph")
            if x.device.type != dev.type:
                raise ValueError(f"x_device is on {x.device}, the graph loads onto {dev}")
        elif "x" in z:
            x = torch.from_numpy(np.asarray(z["x"], dtype=np.float32)).to(dev)
        else:
            raise ValueError("graph file has no vector block; pass x_device")

        def tensor(key, dtype=np.int32):
            return torch.from_numpy(np.asarray(z[key], dtype=dtype)).to(dev)

        valid = None
        if "valid" in z and not bool(z["valid"].all()):
            valid = tensor("valid", bool)
        return BulkGraph(
            ids=ids, n=n, m=int(z["m"]), m0=int(z["m0"]), lmax=int(z["lmax"]),
            metric=str(z["metric"]), x=x, a0=tensor("a0"), up_index=tensor("up_index"),
            up_adj=tensor("up_adj"), lex_rank=tensor("lex_rank"),
            entry_slot=int(z["entry_slot"]), entry_level=int(z["entry_level"]),
            levels=np.asarray(z["levels"], dtype=np.int32), valid=valid,
            lex_spacing=int(z["lex_spacing"]) if "lex_spacing" in z else 1,
        )


def _prep_order(ids, max_level: int, n: int):
    """Shared build preamble: deterministic FNV-1a levels, (level desc, id)
    slot order, lex tie-break ranks, and the upper-layer row map. Returns
    ``(ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up)``."""
    str_ids = [str(i) for i in ids]
    levels = levels_batch(str_ids, max_level)
    id_arr = np.array(str_ids, dtype=str)
    order = np.lexsort((id_arr, -levels))  # (level desc, id asc)
    ids_sorted = [str(id_arr[i]) for i in order]
    levels = levels[order]

    lex = np.argsort(np.array(ids_sorted, dtype=str), kind="stable")
    lex_rank = np.zeros(n, dtype=np.int32)
    lex_rank[lex] = np.arange(n, dtype=np.int32)

    lmax = int(levels.max()) if n else 0
    upper = np.flatnonzero(levels >= 1)
    up_index = np.full(n, -1, dtype=np.int32)
    up_index[upper] = np.arange(len(upper), dtype=np.int32)
    return ids_sorted, order, levels, lex_rank, lmax, up_index, len(upper)


#: graphs at least this large bulk-build through the kNN-block construction
#: (hnsw_knn_build.py) by default; below it ``"auto"`` would take the wave
#: build, which is not ported yet. ``build="knn"`` takes the kNN build at any
#: size.
KNN_BUILD_MIN = 20_000


def bulk_build(metric: str, params: dict, ids, vectors, *, device) -> BulkGraph:
    """Builds a full graph from scratch on ``device`` from ``vectors`` (host
    [n, d] f32, uploaded once) in ``ids`` order; returns a BulkGraph."""
    n = vectors.shape[0]
    algo = params.get("build", "auto")
    if algo == "auto":
        algo = "knn" if n >= KNN_BUILD_MIN else "wave"
    if algo != "knn":
        raise InvalidIndex(
            f"the wave build of HNSW graphs is not ported yet (build={params.get('build')!r} "
            f"with {n} rows; build='knn' takes the kNN build)")
    from . import hnsw_knn_build

    return hnsw_knn_build.bulk_build_knn(metric, params, ids, vectors, device=device)
