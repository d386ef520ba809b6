"""Bulk HNSW construction on the device: wave insertion, and the
incremental mutation of bulk graphs.

The port of ``vettore_tpu/index/hnsw_build.py``, in plain PyTorch. The
reference builds its graph one sequential insert at a time (hnsw.rs:152-244);
here nodes are inserted in *waves*:

* nodes are ordered by (level desc, id) — deterministic FNV-1a levels mean
  the first node is the entry for the whole build, and "already inserted"
  is simply ``slot < wave_start`` (:func:`_prep_order`);
* each wave runs the reference's insert search for all its nodes together
  (:func:`_wave_step`): greedy descent to the node's level, an
  ``ef_construction`` beam per layer (the search's descent and step,
  ``hnsw_device.py``), and Malkov's diversity heuristic
  (:func:`_heuristic_select`) down to m/m0 neighbours;
* nodes inside a wave cannot see each other through the frozen graph, so
  intra-wave candidates come from a ``[B, B]`` distance matrix merged into
  each layer's beam results;
* reciprocal edges apply as one sort/segment program per layer: edges sort by
  (dst, dist, src lex), incoming edges are capped per node, unioned with the
  node's existing row, rescored, deduplicated and pruned — the batched
  equivalent of hnsw.rs:220-236's add-then-prune.

:func:`bulk_build` routes ``build="auto"`` to the cluster-blocked kNN build
(``hnsw_knn_build.py``) from ``KNN_BUILD_MIN`` rows and to the wave build
below it; ``build="knn"`` / ``"wave"`` choose one at any size.

A bulk graph takes writes after its build (:func:`incremental_put`,
:func:`incremental_delete`, :func:`compact`): its device arrays are padded
to a capacity beyond ``n``, new records take fresh slots linked by one
:func:`_wave_step` per 8,192 records, deletes tombstone a slot (it keeps
routing the beam but never appears in results), and a graph whose
tombstones pass ``REBUILD_FRACTION`` is rebuilt from its live rows. The host
bookkeeping (:class:`_MutState`) is numpy, as the JAX package keeps it.

:func:`save_graph` / :func:`load_graph` write and read a bulk graph as the
JAX package's ``.npz`` file (the same keys, dtypes and ``GRAPH_MAGIC``), so
either package loads the other's files, mutated ones included.

The graphs equal the JAX package's: every selection is a stable sort
(``jax.lax.top_k`` and ``jax.lax.sort`` keep the lowest index among ties),
multi-key sorts are stable passes from the last key to the first, and the
wave sizes are the JAX package's, since they decide which nodes are wave
peers. The build reads ``params["build"]`` only; the JAX package's
``VETTORE_HNSW_BUILD`` / ``VETTORE_BUILD_*`` environment overrides are not
carried over.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops.topk import lex_sort, smallest
from .flat import resolve_device
from .hnsw import levels_batch
from .hnsw_device import (_BIG32, _DONE_EVERY, DeviceGraph, _adjacency, _Beam, _descend, _frontier,
                          _pairwise_rank, _rank_matrix, _rank_rows, _seed, _step, hub_count)

_INF = float("inf")


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
    dist = cand_dists.masked_fill(~valid, _INF)
    mdk = torch.full(cand_dists.shape, _INF, device=cand_dists.device)
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
            torch.where(ok, sel_d, torch.full_like(sel_d, _INF)))


class BulkGraph(DeviceGraph):
    """:class:`DeviceGraph` produced by a bulk build. Slots are (level
    desc, id) ordered, so the hub set is simply the first H slots, the upper
    layers' nodes are slot prefixes, and slot 0 is the entry. ``levels``
    ([n] int32 numpy, slot order) and ``lex_spacing`` (1: ranks are dense)
    are kept as the JAX package keeps them.

    Once mutated (:func:`incremental_put` / :func:`incremental_delete`) the
    arrays are capacity-padded past ``n``: ``n`` is the slot high-water
    mark, ``valid`` (bool [cap] or None) masks tombstoned slots out of
    results, and ``live`` is the record count. The hub set stays the first
    ``hub_count(n)`` slots as ``n`` grows."""

    def __init__(self, *, ids, n, m, m0, lmax, metric, x, a0, up_index, up_adj, lex_rank,
                 entry_slot, entry_level, levels, valid=None, lex_spacing=1):
        super().__init__(ids=ids, n=n, m=m, m0=m0, lmax=lmax, metric=metric, x=x, a0=a0,
                         up_index=up_index, up_adj=up_adj, lex_rank=lex_rank,
                         entry_slot=entry_slot, entry_level=entry_level, hub_slots=(),
                         valid=valid)
        self.levels = levels
        self.lex_spacing = lex_spacing
        self._mut = None  # _MutState once incrementally mutated

    def _hub_slots(self) -> np.ndarray:
        return np.arange(hub_count(self.n), dtype=np.int32)

    @property
    def live(self) -> int:
        """Records in the graph (slots not tombstoned)."""
        return self.n - (self._mut.dead if self._mut is not None else 0)


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
    A mutated graph writes its used upper-layer rows and, when it holds
    tombstones, its ``valid`` mask, as the JAX package's do."""
    n = graph.n
    st = graph._mut
    up_adj = graph.up_adj if st is None else graph.up_adj[: max(st.up_used, 1)]
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
        "up_adj": _np32(up_adj),
        "lex_rank": _np32(graph.lex_rank[:n]),
        "entry_slot": np.int64(graph.entry_slot),
        "entry_level": np.int64(graph.entry_level),
        "levels": np.asarray(graph.levels, dtype=np.int32)[:n],
        "lex_spacing": np.int64(graph.lex_spacing),
    }
    if st is not None and st.dead:
        payload["valid"] = st.valid_np[:n].copy()
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
    ``include_x=False`` (or to share one device copy). A file with
    tombstones rebuilds the mutation bookkeeping, so live counts, compaction
    and re-inserts stay right. The file is read with ``allow_pickle=False``."""
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
        graph = BulkGraph(
            ids=ids, n=n, m=int(z["m"]), m0=int(z["m0"]), lmax=int(z["lmax"]),
            metric=str(z["metric"]), x=x, a0=tensor("a0"), up_index=tensor("up_index"),
            up_adj=tensor("up_adj"), lex_rank=tensor("lex_rank"),
            entry_slot=int(z["entry_slot"]), entry_level=int(z["entry_level"]),
            levels=np.asarray(z["levels"], dtype=np.int32), valid=valid,
            lex_spacing=int(z["lex_spacing"]) if "lex_spacing" in z else 1,
        )
        if valid is not None:
            _ensure_mutable(graph, valid_np=np.asarray(z["valid"], dtype=bool))
        return graph


# ---------------------------------------------------------------------------
# the wave build
# ---------------------------------------------------------------------------

#: beam entries expanded per construct-search iteration (the query beam's
#: widened scheme: exploration only grows at a given ef, sequential depth
#: drops ~W-fold)
BUILD_EXPAND_W = 4

#: bytes of per-lane working memory (visited bitset, one step's gathered
#: rows, the heuristic's candidate block) one chunk of a wave's lanes may
#: take; lanes search independently, so the chunk size cannot change the graph
_WAVE_CHUNK_BYTES = 8 << 30

#: rows pruned per chunk of the reciprocal pass
_PRUNE_CHUNK = 4096


def build_step_bound(efc: int, w: int = BUILD_EXPAND_W) -> int:
    """Bound on construct-beam iterations (~efc expansions at W per step,
    plus exploration slack)."""
    return max(3 * efc // max(w, 1), 24) + 16


def _beam_layer(xt, adj, q, g, *, metric, ef, words, max_steps, seeds=None):
    """The construct beam over one layer for the lanes of ``q`` [b, d],
    from the entry slots ``g`` [b] or, with ``seeds`` (``(dists [b, S],
    slots [b, S])``, ascending, slot -1 where absent), from hub seeds.
    ``adj`` gives the layer's inserted neighbours only (``_adjacency`` with
    ``start``). Each step is the search's (``hnsw_device._step``) with
    full-f32 ranks: it expands the W best unexpanded entries, scores their
    neighbours not yet visited and keeps the best ``ef`` by a stable merge
    (``jax.lax.top_k``'s order). Returns ``(dists [b, ef], slots [b,
    ef])``, ascending, +inf / -1 padded.

    The JAX package runs each lane's beam as a ``while_loop`` under
    ``vmap``; here the lanes take each step together. A converged lane's
    step changes nothing (it expands no node and the stable merge leaves its
    sorted beam in place), so stepping it on is the same as stopping it: the
    convergence flags are read on the host every ``_DONE_EVERY`` steps, and
    the converged lanes then leave the working set (the build's steps run
    eagerly, so a converged lane would cost its full step)."""
    b, dev = q.shape[0], q.device
    W = min(BUILD_EXPAND_W, ef)
    beam = _Beam(b, ef, words, q.shape[1], q.dtype, dev)
    beam.reset()
    beam.qt = q
    if seeds is None:
        seeds = (_rank_rows(xt[g][:, None, :], q, metric), g[:, None])
    _seed(beam, *seeds)

    def neighbours(nodes, expand):
        return torch.where(expand[..., None], adj(nodes.clamp_min(0)), -1).flatten(1)

    final_d, final_id = torch.empty_like(beam.d), torch.empty_like(beam.id)
    lanes = torch.arange(b, device=dev)
    for step in range(0, max_steps, _DONE_EVERY):
        if step:
            done = _frontier(beam, W)[2]
            n_done = int(done.sum())  # a sync
            if n_done:
                order = torch.sort(done.to(torch.int8), stable=True).indices
                keep, gone = order[:done.numel() - n_done], order[done.numel() - n_done:]
                final_d[lanes[gone]], final_id[lanes[gone]] = beam.d[gone], beam.id[gone]
                if not keep.numel():
                    break
                lanes = lanes[keep]
                for name in ("d", "id", "exp", "visited", "qt", "scored"):
                    setattr(beam, name, getattr(beam, name)[keep])
        for _ in range(min(_DONE_EVERY, max_steps - step)):
            _step(beam, xt, neighbours, _rank_rows, metric, W)
    final_d[lanes], final_id[lanes] = beam.d, beam.id
    return final_d, final_id


def _lane_chunk(n_lanes, *, words, ef, deg_max, d, peers):
    """Lanes per chunk of a wave's construct search, from the bytes one lane
    holds: its bitset, one step's gathered rows (bf16, widened to f32), its
    candidate block for the heuristic and its row of the peer matrix."""
    e = BUILD_EXPAND_W * deg_max
    c = ef + deg_max
    per_lane = 8 * words + 6 * e * d + 6 * c * d + 4 * c * c + 16 * peers
    return max(1, min(n_lanes, _WAVE_CHUNK_BYTES // per_lane))


def _construct_search(xt, a0, up_adj, up_index, lex_rank, lv, slots, peer, wave_slots,
                      wave_levels, start, entry_slot, entry_level, *, metric, efc, m, m0,
                      lmax, lmax_wave, beam_steps, hub_cap):
    """The insert search of the wave's lanes ``slots`` [b] (levels ``lv``
    [b], rows ``peer`` [b, B] of the masked peer matrix): per layer
    ``lmax_wave..0``, a graph beam merged with the wave peers of sufficient
    level, ordered by (dist, lex) and diversity-pruned. Returns
    ``(sel_ids [b, lmax_wave + 1, max(m, m0)], sel_d)``, -1 / +inf where a
    lane holds no neighbour on a layer."""
    b, dev = slots.shape[0], xt.device
    B = wave_slots.shape[0]
    words = (xt.shape[0] + 31) // 32
    qt = xt[slots]
    has_graph = start > 0
    g = torch.full((b,), entry_slot if has_graph else 0, dtype=torch.int64, device=dev)
    all_lanes = torch.ones(b, dtype=torch.bool, device=dev)

    hub_seeds = None
    if hub_cap:
        # hub seeding for the layer-0 construct beam: a dense scan of the
        # top-by-level prefix (only inserted slots < start are eligible);
        # few seeds, since construct beams refine around each seed's basin
        hd = _rank_matrix(qt, xt[:hub_cap], metric)
        hd[:, start:] = _INF
        seed_d, hpos = smallest(hd, min(4, hub_cap))
        hub_seeds = (seed_d, torch.where(torch.isfinite(seed_d), hpos, -1))

    deg_max = max(m, m0)
    sel_ids = torch.full((b, lmax_wave + 1, deg_max), -1, dtype=torch.int64, device=dev)
    sel_d = torch.full((b, lmax_wave + 1, deg_max), _INF, device=dev)

    # layers above every wave node's level: pure greedy descent
    for layer in range(lmax, lmax_wave, -1):
        if has_graph and layer <= entry_level:
            g = _descend(xt, _adjacency(a0, up_adj, up_index, layer, start), qt, g, all_lanes,
                         metric)

    for layer in range(lmax_wave, -1, -1):
        deg = m0 if layer == 0 else m
        adj = _adjacency(a0, up_adj, up_index, layer, start)
        in_graph_layer = has_graph and layer <= entry_level
        active = layer <= lv
        bd = torch.full((b, efc), _INF, device=dev)
        bi = torch.full((b, efc), -1, dtype=torch.int64, device=dev)
        if in_graph_layer:
            if layer >= 1:
                g = _descend(xt, adj, qt, g, ~active, metric)
            beam = active.nonzero()[:, 0]
            if beam.numel():
                seeds = None
                if layer == 0 and hub_seeds is not None:
                    seeds = (hub_seeds[0][beam], hub_seeds[1][beam])
                bd[beam], bi[beam] = _beam_layer(
                    xt, adj, qt[beam], g[beam], metric=metric, ef=efc, words=words,
                    max_steps=beam_steps, seeds=seeds)
                # next layer's entry = closest GRAPH candidate (a wave peer
                # has no adjacency row yet and would stall the next beam)
                g = torch.where(active & (bi[:, 0] >= 0), bi[:, 0], g)

        act = active.nonzero()[:, 0]
        if not act.numel():
            continue
        # merge the graph beam with intra-wave peers of sufficient level
        pd = peer[act].masked_fill(~(wave_levels >= layer)[None, :], _INF)
        top_pd, ppos = smallest(pd, min(deg, B))
        pids = torch.where(torch.isfinite(top_pd), wave_slots[ppos], -1)
        cat_d = torch.cat([bd[act], top_pd], dim=1)
        cat_id = torch.cat([bi[act], pids], dim=1)
        cat_lex = torch.where(cat_id >= 0, lex_rank[cat_id.clamp_min(0)].long(), _BIG32)
        order = lex_sort(cat_d, cat_lex)
        cat_d, cat_id = cat_d.gather(1, order), cat_id.gather(1, order)
        P = _pairwise_rank(xt[cat_id.clamp_min(0)], metric)
        chosen, chosen_d = _heuristic_select(cat_id, cat_d, P, deg)
        sel_ids[act, layer, :deg] = chosen
        sel_d[act, layer, :deg] = chosen_d
    return sel_ids, sel_d


def _reciprocal(x, xt, a0, up_adj, up_index, lex_rank, wave_slots, sel_ids, sel_d, layer, *,
                metric, deg):
    """Reciprocal edges and prune of one layer, in place: the wave's edges
    sort by (dst, dist, src lex), each destination takes its first ``deg``
    incoming sources, unions them with its existing row, and the union is
    rescored, deduplicated and diversity-pruned back to ``deg``."""
    n, dev = x.shape[0], x.device
    src = wave_slots.repeat_interleave(deg)
    dst = sel_ids[:, layer, :deg].reshape(-1)
    valid = dst >= 0
    E = dst.shape[0]
    dkey = torch.where(valid, dst, n)
    dist = sel_d[:, layer, :deg].reshape(-1).masked_fill(~valid, _INF)
    slex = torch.where(valid, lex_rank[src].long(), _BIG32)
    # stable sort by (dkey, dist, slex): the least significant key first
    order = torch.sort(slex, stable=True).indices
    order = order.gather(0, torch.sort(dist[order], stable=True).indices)
    order = order.gather(0, torch.sort(dkey[order], stable=True).indices)
    dkey, src_s = dkey[order], src[order]
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = dkey[1:] != dkey[:-1]
    head = (first & (dkey < n)).nonzero()[:, 0]  # one entry per destination
    rows = dkey[head]
    # a destination's incoming sources: the first ``deg`` of its segment
    idx = head[:, None] + torch.arange(deg, device=dev)
    in_seg = (idx < E) & (dkey[idx.clamp_max(E - 1)] == rows[:, None])
    inc = torch.where(in_seg, src_s[idx.clamp_max(E - 1)], -1)
    exist = _adjacency(a0, up_adj, up_index, layer)(rows)
    cand = torch.cat([exist, inc], dim=1)  # [rows, 2 * deg]

    pruned = torch.empty((rows.shape[0], deg), dtype=torch.int64, device=dev)
    for s in range(0, rows.shape[0], _PRUNE_CHUNK):
        rows_c, cand_c = rows[s:s + _PRUNE_CHUNK], cand[s:s + _PRUNE_CHUNK]
        cvalid = (cand_c >= 0) & (cand_c != rows_c[:, None])
        csafe = cand_c.clamp_min(0)
        cd = _rank_rows(xt[csafe], xt[rows_c], metric).masked_fill(~cvalid, _INF)
        clex = torch.where(cvalid, lex_rank[csafe].long(), _BIG32)
        order = lex_sort(cd, clex)
        cd = cd.gather(1, order)
        cand_s = cand_c.masked_fill(~cvalid, -1).gather(1, order)
        dup = torch.zeros_like(cvalid)
        dup[:, 1:] = (cand_s[:, 1:] == cand_s[:, :-1]) & (cand_s[:, 1:] >= 0)
        cd = cd.masked_fill(dup, _INF)
        cand_s = cand_s.masked_fill(dup, -1)
        # valid entries stay ascending after the dup masking, and +inf is
        # never kept, so the heuristic needs no second sort
        P = _pairwise_rank(xt[cand_s.clamp_min(0)], metric)
        pruned[s:s + _PRUNE_CHUNK] = _heuristic_select(cand_s, cd, P, deg)[0]
    if layer == 0:
        a0[rows] = pruned.to(a0.dtype)
    else:
        up_adj[up_index[rows].long(), layer - 1] = pruned.to(up_adj.dtype)


def _wave_step(x, xt, a0, up_adj, up_index, lex_rank, levels, wave_slots, start, entry_slot,
               entry_level, *, metric, efc, m, m0, lmax, lmax_wave, beam_steps, hub_cap=0):
    """Inserts one wave, updating ``a0`` [cap + 1, m0] and ``up_adj``
    [cap_up + 1, max(lmax, 1), m] in place: the batched construct search,
    forward edges and the reciprocal prune. ``wave_slots`` [B] int64 are
    the wave's slots (each >= ``start``, the number of slots already in the
    graph); ``levels`` [cap] is on the device.

    ``lmax`` is the global top layer (the descent traverses it);
    ``lmax_wave`` is at least the highest level of any node in this wave:
    selection and reciprocal work runs for the layers up to it only. The
    JAX package rounds it up to a power of two to bound its compiled
    variants; the layers above the wave's own top are fully masked, so the
    graph does not depend on it.

    The JAX package pads a wave to a fixed width with masked lanes, which
    take part in nothing; here a wave holds its real lanes only."""
    B = wave_slots.shape[0]

    # ---- intra-wave candidate matrix (peers cannot be reached through the
    # frozen graph, so they compete through a dense [B, B] distance block)
    peer_rank = _pairwise_rank(x[wave_slots], metric)
    peer_rank.fill_diagonal_(_INF)
    wave_levels = levels[wave_slots].long()

    # ---- per-lane construct search, in chunks of lanes
    deg_max = max(m, m0)
    chunk = _lane_chunk(B, words=(x.shape[0] + 31) // 32, ef=efc, deg_max=deg_max,
                        d=x.shape[1], peers=B)
    parts = [
        _construct_search(
            xt, a0, up_adj, up_index, lex_rank, wave_levels[s:s + chunk],
            wave_slots[s:s + chunk], peer_rank[s:s + chunk], wave_slots, wave_levels, start,
            entry_slot, entry_level, metric=metric, efc=efc, m=m, m0=m0, lmax=lmax,
            lmax_wave=lmax_wave, beam_steps=beam_steps, hub_cap=hub_cap)
        for s in range(0, B, chunk)]
    del peer_rank
    sel_ids = torch.cat([p[0] for p in parts])
    sel_d = torch.cat([p[1] for p in parts])

    # ---- forward edges
    a0[wave_slots] = sel_ids[:, 0, :m0].to(a0.dtype)
    up_rows = up_index[wave_slots].long()
    for layer in range(1, lmax_wave + 1):
        on = ((up_rows >= 0) & (wave_levels >= layer)).nonzero()[:, 0]
        up_adj[up_rows[on], layer - 1] = sel_ids[on, layer, :m].to(up_adj.dtype)

    # ---- reciprocal edges + prune, one segment program per layer
    for layer in range(0, lmax_wave + 1):
        _reciprocal(x, xt, a0, up_adj, up_index, lex_rank, wave_slots, sel_ids, sel_d, layer,
                    metric=metric, deg=m0 if layer == 0 else m)


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
#: (hnsw_knn_build.py) by default; below it the wave build. ``build="wave"``
#: / ``"knn"`` overrides per index.
KNN_BUILD_MIN = 20_000


def _wave_width(n: int) -> int:
    """The JAX package's wave width for an ``n``-row build (it decides
    which nodes are wave peers, so it is kept as is)."""
    if n >= 2**19:
        return 8192
    return 4096 if n >= 2**17 else (2048 if n >= 2**14 else 1024)


def bulk_build(metric: str, params: dict, ids, vectors=None, *, device="cuda",
               x_device=None) -> BulkGraph:
    """Builds a full graph from scratch; returns a BulkGraph.

    Vectors come from ``vectors`` (host [n, d] f32, uploaded once to
    ``device``) or ``x_device`` (a device-resident [n, d] f32 block in
    ``ids`` order — e.g. a compacted graph's live rows — permuted on its
    device, no re-transfer). ``build="auto"`` takes the kNN build
    (``hnsw_knn_build.py``) from ``KNN_BUILD_MIN`` rows and the wave build
    below it."""
    n = int(x_device.shape[0]) if x_device is not None else vectors.shape[0]
    algo = params.get("build", "auto")
    if algo == "auto":
        algo = "knn" if n >= KNN_BUILD_MIN else "wave"
    if algo == "knn":
        from . import hnsw_knn_build

        return hnsw_knn_build.bulk_build_knn(metric, params, ids, vectors, device=device,
                                             x_device=x_device)
    m, m0, efc = params["m"], params["m0"], params["ef_construction"]
    ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up = _prep_order(
        ids, params["max_level"], n)
    xd = _slot_block(order, vectors, device, x_device)
    dev = xd.device
    xt = xd.to(torch.bfloat16)  # selection-only traversal block
    a0 = torch.full((n + 1, m0), -1, dtype=torch.int32, device=dev)  # + trash row
    up_adj = torch.full((cap_up + 1, max(lmax, 1), m), -1, dtype=torch.int32, device=dev)
    up_index_d = torch.from_numpy(up_index).to(dev)
    lex_d = torch.from_numpy(lex_rank).to(dev)
    levels_d = torch.from_numpy(levels).to(dev)

    beam_steps = build_step_bound(efc)
    wave = _wave_width(n)
    hub_cap = hub_count(n)
    for start in range(0, n, wave):
        # insertion order is level-descending: the wave's top level is its
        # first member's
        _wave_step(xd, xt, a0, up_adj, up_index_d, lex_d, levels_d,
                   torch.arange(start, min(start + wave, n), device=dev), start, 0,
                   int(levels[0]), metric=metric, efc=efc, m=m, m0=m0, lmax=lmax,
                   lmax_wave=int(levels[start]), beam_steps=beam_steps, hub_cap=hub_cap)
    graph = BulkGraph(
        ids=ids_sorted, n=n, m=m, m0=m0, lmax=lmax, metric=metric, x=xd, a0=a0[:n],
        up_index=up_index_d, up_adj=up_adj[:cap_up] if cap_up else up_adj[:1],
        lex_rank=lex_d, entry_slot=0, entry_level=int(levels[0]) if n else 0, levels=levels,
    )
    graph._xb = xt
    return graph


def _slot_block(order, vectors, device, x_device):
    """The f32 [n, d] block in slot order: ``x_device`` permuted on its
    device, or ``vectors`` uploaded once to ``device`` and permuted there."""
    if x_device is None:
        x_device = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32)).to(
            resolve_device(device))
    return x_device[torch.from_numpy(order).to(x_device.device)].float()


# ---------------------------------------------------------------------------
# incremental mutation of a bulk-built graph
# ---------------------------------------------------------------------------
#
# The reference mutates its graph one record at a time in O(ef·m) per insert
# (hnsw.rs:152-289). Here the bulk graph stays on the device and takes
# appends through the same ``_wave_step`` that built it:
#
# * device arrays are padded to a CAPACITY beyond ``n`` so most puts
#   reallocate nothing;
# * inserts land in fresh slots and one wave per 8,192 records links them
#   (intra-batch candidates through the wave's peer matrix, reciprocal edges
#   through the same segment program as the bulk build);
# * deletes SOFT-delete: the slot's validity bit flips, the node keeps
#   routing traffic through its edges (the graph stays connected — the
#   reference instead rewires, hnsw.rs:263-289) but never appears in results;
#   compaction rebuilds once tombstones pass ``REBUILD_FRACTION`` of the
#   slots;
# * lexicographic tie-break ranks are SPACED at the migration so a new id
#   takes a rank between its neighbours without renumbering every slot; an
#   exhausted gap (~1k inserts between two adjacent ids) respaces them all.

#: the JAX package's wave widths for incremental batches; a batch inserts in
#: waves of at most the last (its waves pad to one of these with masked
#: lanes, which take part in nothing)
INCR_WAVE_BUCKETS = (256, 2048, 8192)

#: slot-capacity growth granularity
GROW_CHUNK = 8192

#: rebuild the graph once tombstones exceed this fraction of slots
REBUILD_FRACTION = 0.25

#: minimum free-slot headroom kept beyond n (tests shrink this to exercise
#: the growth path cheaply)
CAP_SLACK_MIN = 4096


def _round_up(v: int, to: int) -> int:
    return ((v + to - 1) // to) * to


def _capacity(n: int) -> int:
    return _round_up(n + max(CAP_SLACK_MIN, n // 8), min(GROW_CHUNK, max(CAP_SLACK_MIN, 8)))


class _MutState:
    """Host bookkeeping of an incrementally mutated BulkGraph: the live
    slot of each id, per-slot levels, validity and lex ranks (numpy, at
    capacity), the tombstone count, every id ever inserted with its rank
    (sorted), the used upper-layer rows, and the levels on the device."""

    __slots__ = ("slot_of", "levels_np", "valid_np", "lex_np", "dead",
                 "sorted_ids", "sorted_ranks", "up_used", "levels_d")


def _pad_rows(t, rows, fill):
    """``t`` with ``rows`` more rows of ``fill`` (a new tensor)."""
    return torch.cat([t, t.new_full((rows, *t.shape[1:]), fill)])


def _ensure_mutable(graph: BulkGraph, valid_np=None) -> _MutState:
    """One-time migration of a frozen bulk graph into mutable form: pads the
    device arrays to capacity, respaces lex ranks, and builds the host-side
    slot/rank maps. O(n log n) host work and one device reallocation; every
    later put or delete is O(batch)."""
    if graph._mut is not None:
        return graph._mut
    n = graph.n
    cap = _capacity(n)
    st = _MutState()

    # ---- lex ranks: respace so ids can insert between neighbours
    lex_np = graph.lex_rank[:n].cpu().numpy().astype(np.int64)
    if graph.lex_spacing == 1:
        spacing = max(1, min(1024, (_BIG32 - 2) // max(cap, 1)))
        lex_np = lex_np * spacing
        graph.lex_spacing = spacing
    st.lex_np = np.zeros(cap, np.int64)
    st.lex_np[:n] = lex_np
    ids_np = np.asarray(graph.ids, dtype=str)
    uniq, first = np.unique(ids_np, return_index=True)
    st.sorted_ids = uniq
    st.sorted_ranks = lex_np[first]

    # ---- slot map + levels + validity
    st.valid_np = np.zeros(cap, bool)
    if valid_np is None:
        valid_np = (np.ones(n, bool) if graph.valid is None
                    else graph.valid[:n].cpu().numpy())
    st.valid_np[:n] = valid_np
    st.dead = int(n - st.valid_np[:n].sum())
    live = np.flatnonzero(st.valid_np[:n])
    st.slot_of = dict(zip(ids_np[live].tolist(), live.tolist()))
    st.levels_np = np.zeros(cap, np.int32)
    st.levels_np[:n] = np.asarray(graph.levels)[:n]
    st.up_used = int((graph.up_index[:n] >= 0).sum())

    # ---- device capacity padding
    pad = cap - graph.x.shape[0]
    if pad > 0:
        graph.x = _pad_rows(graph.x, pad, 0)
        if graph._xb is not None:
            graph._xb = _pad_rows(graph._xb, pad, 0)
    a0_rows = cap + 1 - graph.a0.shape[0]  # + 1 trash row for _wave_step
    if a0_rows > 0:
        graph.a0 = _pad_rows(graph.a0, a0_rows, -1)
    up_rows = st.up_used + max(256, st.up_used // 8) + 1 - graph.up_adj.shape[0]
    if up_rows > 0:
        graph.up_adj = _pad_rows(graph.up_adj, up_rows, -1)
    idx_pad = cap - graph.up_index.shape[0]
    if idx_pad > 0:
        graph.up_index = _pad_rows(graph.up_index, idx_pad, -1)
    dev = graph.x.device
    graph.lex_rank = torch.from_numpy(st.lex_np.astype(np.int32)).to(dev)
    st.levels_d = torch.from_numpy(st.levels_np).to(dev)
    if graph.valid is not None or st.dead:
        graph.valid = torch.from_numpy(st.valid_np.copy()).to(dev)
    graph.levels = st.levels_np
    graph.forget()
    graph._mut = st
    return st


def _grow_slots(graph: BulkGraph, st: _MutState, need: int) -> None:
    """Grows slot capacity to hold ``need`` slots (a device reallocation)."""
    pad = _capacity(need) - graph.x.shape[0]
    if pad <= 0:
        return
    graph.x = _pad_rows(graph.x, pad, 0)
    if graph._xb is not None:
        graph._xb = _pad_rows(graph._xb, pad, 0)
    graph.a0 = _pad_rows(graph.a0, pad, -1)
    graph.up_index = _pad_rows(graph.up_index, pad, -1)
    graph.lex_rank = _pad_rows(graph.lex_rank, pad, 0)
    st.levels_d = _pad_rows(st.levels_d, pad, 0)
    if graph.valid is not None:
        graph.valid = _pad_rows(graph.valid, pad, False)
    st.lex_np = np.concatenate([st.lex_np, np.zeros(pad, np.int64)])
    st.levels_np = np.concatenate([st.levels_np, np.zeros(pad, np.int32)])
    st.valid_np = np.concatenate([st.valid_np, np.zeros(pad, bool)])
    graph.levels = st.levels_np


def _grow_upper(graph: BulkGraph, need: int) -> None:
    pad = need + max(256, need // 8) + 1 - graph.up_adj.shape[0]
    if pad > 0:
        graph.up_adj = _pad_rows(graph.up_adj, pad, -1)


def _grow_layers(graph: BulkGraph, new_lmax: int) -> None:
    add = new_lmax - graph.up_adj.shape[1]
    if add > 0:
        graph.up_adj = torch.cat([graph.up_adj, graph.up_adj.new_full(
            (graph.up_adj.shape[0], add, graph.m), -1)], dim=1)
    graph.lmax = max(graph.lmax, new_lmax)


def _assign_lex(st: _MutState, graph: BulkGraph, ids: list) -> np.ndarray:
    """Ranks for a batch of ids: existing ids (replaces/re-inserts) reuse
    their rank; new ids get evenly-spaced ranks inside their lex gap (full
    respace when a gap is exhausted). Returns np.int64 [B]."""
    ids_np = np.array(ids, dtype=str)
    out = np.zeros(len(ids), np.int64)
    ns = len(st.sorted_ids)
    pos = np.searchsorted(st.sorted_ids, ids_np)
    if ns:
        exists = (pos < ns) & (st.sorted_ids[np.minimum(pos, ns - 1)] == ids_np)
        out[exists] = st.sorted_ranks[pos[exists]]
    else:
        exists = np.zeros(len(ids), bool)
    fresh = np.flatnonzero(~exists)
    if not len(fresh):
        return out

    order = fresh[np.argsort(ids_np[fresh], kind="stable")]
    gap_pos = pos[order]
    insert_ids = ids_np[order]
    new_ranks = np.zeros(len(order), np.int64)
    i = 0
    need_respace = False
    while i < len(order):
        j = i
        while j < len(order) and gap_pos[j] == gap_pos[i]:
            j += 1
        k = j - i  # ids landing in this gap
        left = st.sorted_ranks[gap_pos[i] - 1] if gap_pos[i] > 0 else -(
            graph.lex_spacing * (k + 1))
        right = st.sorted_ranks[gap_pos[i]] if gap_pos[i] < ns else (
            left + graph.lex_spacing * (k + 1))
        if right - left <= k:
            need_respace = True
            break
        step = (right - left) / (k + 1)
        new_ranks[i:j] = left + (np.arange(1, k + 1) * step).astype(np.int64)
        i = j
    if insert_ids.dtype.itemsize > st.sorted_ids.dtype.itemsize:
        # widen first: np.insert silently TRUNCATES longer strings to the
        # target array's fixed width
        st.sorted_ids = st.sorted_ids.astype(insert_ids.dtype)
    st.sorted_ids = np.insert(st.sorted_ids, gap_pos, insert_ids)
    st.sorted_ranks = np.insert(st.sorted_ranks, gap_pos, new_ranks)
    if need_respace:
        spacing = max(1, min(1024, (_BIG32 - 2) // max(
            graph.x.shape[0], len(st.sorted_ids))))
        graph.lex_spacing = spacing
        st.sorted_ranks = np.arange(len(st.sorted_ids), dtype=np.int64) * spacing
        _respace_slots(st, graph)
    rank_of = dict(zip(insert_ids.tolist(),
                       st.sorted_ranks[np.searchsorted(st.sorted_ids, insert_ids)].tolist()))
    for idx in fresh:
        out[idx] = rank_of[ids_np[idx]]
    if need_respace:
        # existing ids' ranks moved too — refresh the whole batch
        out = st.sorted_ranks[np.searchsorted(st.sorted_ids, ids_np)]
    return out


def _respace_slots(st: _MutState, graph: BulkGraph) -> None:
    rank_of = dict(zip(st.sorted_ids.tolist(), st.sorted_ranks.tolist()))
    for id, slot in st.slot_of.items():
        st.lex_np[slot] = rank_of[id]
    graph.lex_rank = torch.from_numpy(st.lex_np.astype(np.int32)).to(graph.x.device)


def _tombstone(graph: BulkGraph, st: _MutState, ids: list) -> int:
    slots = [st.slot_of.pop(i) for i in ids if i in st.slot_of]
    if not slots:
        return 0
    sl = np.asarray(slots, np.int64)
    st.valid_np[sl] = False
    st.dead += len(slots)
    if graph.valid is None:
        graph.valid = torch.from_numpy(st.valid_np.copy()).to(graph.x.device)
    else:
        graph.valid[torch.from_numpy(sl).to(graph.x.device)] = False
    graph.forget()
    if not st.valid_np[graph.entry_slot]:
        _reelect_entry(graph, st)
    return len(slots)


def _reelect_entry(graph: BulkGraph, st: _MutState) -> None:
    """Deterministic entry re-election: (level desc, id asc) — the soft-
    deleted old entry keeps routing but no longer anchors descent
    (hnsw.rs:263-289 semantics on the live set)."""
    live = st.valid_np[: graph.n]
    if not live.any():
        return
    lv = np.where(live, st.levels_np[: graph.n], -1)
    top = int(lv.max())
    cands = np.flatnonzero(lv == top)
    graph.entry_slot = int(cands[np.argmin(st.lex_np[cands])])
    graph.entry_level = top


def incremental_put(graph: BulkGraph, params: dict, ids: list, vecs: np.ndarray) -> None:
    """Inserts/replaces a batch into a bulk-built graph without host
    hydration. Replace semantics match the reference (existing id → delete
    then insert, hnsw.rs:152-160): the old slot tombstones and the new vector
    takes a fresh slot. Device work is one wave per 8,192 records; host work
    is O(B log n)."""
    st = _ensure_mutable(graph)
    last = {}
    for i, id in enumerate(ids):
        last[id] = i
    keep = sorted(last.values())
    ids = [ids[i] for i in keep]
    vecs = vecs[keep]
    _tombstone(graph, st, [i for i in ids if i in st.slot_of])

    B = len(ids)
    if not B:
        return
    levels = levels_batch(ids, params["max_level"])
    if graph.n + B > graph.x.shape[0]:
        _grow_slots(graph, st, graph.n + B)
    batch_lmax = int(levels.max())
    if batch_lmax > graph.up_adj.shape[1]:
        _grow_layers(graph, batch_lmax)
    graph.lmax = max(graph.lmax, batch_lmax)
    n_upper = int((levels >= 1).sum())
    if st.up_used + n_upper + 1 > graph.up_adj.shape[0]:
        _grow_upper(graph, st.up_used + n_upper)

    slots = np.arange(graph.n, graph.n + B, dtype=np.int64)
    ranks = _assign_lex(st, graph, ids)
    up_rows = np.full(B, -1, np.int32)
    upb = np.flatnonzero(levels >= 1)
    up_rows[upb] = st.up_used + np.arange(len(upb), dtype=np.int32)
    st.up_used += len(upb)

    for i, id in enumerate(ids):
        st.slot_of[id] = int(slots[i])
    graph.ids.extend(ids)
    st.levels_np[slots] = levels
    st.valid_np[slots] = True
    st.lex_np[slots] = ranks

    dev = graph.x.device
    sl = torch.from_numpy(slots).to(dev)
    xin = torch.from_numpy(np.ascontiguousarray(vecs, dtype=np.float32)).to(dev)
    graph.x[sl] = xin
    if graph._xb is not None:
        graph._xb[sl] = xin.to(torch.bfloat16)
    graph.lex_rank[sl] = torch.from_numpy(ranks.astype(np.int32)).to(dev)
    graph.up_index[sl] = torch.from_numpy(up_rows).to(dev)
    st.levels_d[sl] = torch.from_numpy(levels).to(dev)
    if graph.valid is not None:
        graph.valid[sl] = True

    # ---- link the new slots through the build's wave step; the hub set is
    # sized by the capacity, as the JAX package sizes it
    efc = params["ef_construction"]
    xt = graph.xb
    for off in range(0, B, INCR_WAVE_BUCKETS[-1]):
        size = min(B - off, INCR_WAVE_BUCKETS[-1])
        _wave_step(graph.x, xt, graph.a0, graph.up_adj, graph.up_index, graph.lex_rank,
                   st.levels_d, sl[off:off + size], graph.n + off, graph.entry_slot,
                   graph.entry_level, metric=graph.metric, efc=efc, m=graph.m, m0=graph.m0,
                   lmax=graph.lmax, lmax_wave=int(levels[off:off + size].max()),
                   beam_steps=build_step_bound(efc), hub_cap=hub_count(graph.x.shape[0]))
    graph.n += B
    graph.levels = st.levels_np

    bi = int(np.argmax(levels))
    if int(levels[bi]) > graph.entry_level:
        graph.entry_slot = int(slots[bi])
        graph.entry_level = int(levels[bi])
    graph.forget()


def incremental_delete(graph: BulkGraph, ids: list) -> int:
    """Tombstones ids (validity-bit flips on the device); returns the number
    removed. The slots keep routing beam traffic (soft delete) but are
    masked out of every result set."""
    st = _ensure_mutable(graph)
    return _tombstone(graph, st, [str(i) for i in ids])


def should_compact(graph: BulkGraph) -> bool:
    st = graph._mut
    if st is None or not st.dead:
        return False
    return st.dead > max(64, REBUILD_FRACTION * graph.n)


def compact(graph: BulkGraph, params: dict):
    """Rebuilds the graph from its live slots (a gather on the device, no
    host round trip). Returns the fresh BulkGraph, or None when no live
    records remain."""
    st = _ensure_mutable(graph)
    live_slots = np.flatnonzero(st.valid_np[: graph.n])
    if not len(live_slots):
        return None
    ids_live = [graph.ids[s] for s in live_slots]
    x_live = graph.x[torch.from_numpy(live_slots).to(graph.x.device)]
    return bulk_build(graph.metric, params, ids_live, x_device=x_live)
