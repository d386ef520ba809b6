"""Bulk HNSW construction on the device: the parts the default build needs.

The port of the default path of ``vettore_tpu/index/hnsw_build.py``: the
shared build preamble (:func:`_prep_order`: deterministic FNV-1a levels,
(level desc, id) slot order, lexicographic tie-break ranks, the upper-layer
row map), Malkov's diversity heuristic (:func:`_heuristic_select`), the
:class:`BulkGraph` every bulk build produces, and :func:`bulk_build`, which
routes ``build="auto"`` / ``"knn"`` to the cluster-blocked kNN build
(``hnsw_knn_build.py``).

Not ported yet, and refused with a message that says so: the wave build
(``build="wave"``, and ``"auto"`` below ``KNN_BUILD_MIN`` rows), which also
carries incremental mutation and compaction of bulk graphs, and
``save_graph`` / ``load_graph``. The build reads ``params["build"]`` only;
the JAX package's ``VETTORE_HNSW_BUILD`` / ``VETTORE_BUILD_*`` environment
overrides are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidIndex
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
