"""Batched HNSW beam search on the index's device.

The port of ``vettore_tpu/index/hnsw_device.py``, in plain PyTorch. The
graph lives in fixed-degree adjacency tensors (``[N, m0]`` int32, -1 padded;
compacted ``[U, L, m]`` for upper layers), and a query batch traverses it
together:

* **hub seeding instead of greedy descent**: one dense ``[B, H]`` product of
  the queries against the top-H nodes by level gives each query S
  independent seeds at once, where a descent is a chain of dependent
  gathers. The descent stays for callers that pass no hubs;
* a widened beam at layer 0: each step expands the ``W`` best unexpanded
  beam entries, gathers their ``W*m0`` neighbour vectors, scores them, masks
  visited nodes with a per-query bitset, and keeps the best ``ef`` by a
  stable single-key merge — the array equivalent of the reference's
  candidate/result heap pair;
* **selection in bf16, ordering in f32**: traversal gathers and scores a
  bfloat16 copy of the vectors (half the bytes of the random gathers; the
  products are widened to f32 and summed in f32, as the JAX package's
  ``preferred_element_type``); the final result set re-scores every
  surviving beam entry from the f32 block and orders by exact (rank, lex
  id), so bf16 affects only which nodes reach the beam, never how results
  rank.

Ties resolve as the JAX package resolves them: its ``top_k`` picks the
lowest index among equals and its sorts are stable, so every selection here
is a stable ``torch.sort`` (``ops/topk.py``), never ``torch.topk``.

The JAX package runs each query's beam as a ``while_loop`` under ``vmap``.
Here the queries still searching take each step together. A step of a
query that has converged changes nothing (it expands no node, adds no
candidate, and the stable merge leaves its sorted beam in place), so
running it on is the same as stopping it: the convergence flags are read on
the host only every ``_DONE_EVERY`` steps, and then the converged queries
leave the working set. The loop ends when every query has converged or
after ``step_bound`` steps.

The visited bitset keeps 32 bits in each int64 word (torch has no shifts for
uint32): a bit is added by a scatter-add, which stays exact because the
positions of one step are unique (duplicates are masked first) and never
already set. Queries run in chunks sized by the bitset's and the gathered
rows' bytes; results are per query, so the chunk size cannot change them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..observability import count, span, tracing
from ..ops.distance import no_tf32
from ..ops.topk import lex_sort, smallest

#: beam entries expanded per iteration (sequential depth against redundant
#: work; widening only adds exploration at a given ef)
EXPAND_W = 8

#: bytes of per-query working memory (bitset and one step's gathered rows)
#: one chunk of queries may take
_CHUNK_BYTES = 2 << 30

#: beam steps between two reads of the convergence flags on the host
_DONE_EVERY = 2

_BIG32 = 2**31 - 1


def hub_count(n: int) -> int:
    """Size of the hub set (entry candidates scored densely). Scales with n
    so seed quality holds as the graph grows."""
    return min(max(1024, n // 64), 16384, n)


def step_bound(ef: int, w: int = EXPAND_W) -> int:
    """Upper bound on beam iterations. Hub seeds start the beam near the
    target, so convergence is ~ef/W expansions plus slack; the bound caps
    runaway traversals without biting on converged searches."""
    return max(2 * ef // max(w, 1), 8) + 8


def _dots(rows, q):
    """f32 dot products of ``rows`` [..., k, d] with ``q`` [..., d]: both
    widened to f32 (bf16 products are exact there) and multiplied as a
    batch of matrix-vector products in full f32 (``no_tf32``)."""
    rows = rows.float()
    no_tf32(rows)
    return torch.matmul(rows, q.float().unsqueeze(-1)).squeeze(-1)


def _rank_rows(rows, q, metric):
    """Ascending rank distance of gathered rows [..., k, d] against q
    [..., d]. Inputs may be bf16 (traversal mode); accumulation is f32."""
    if metric == "l2":
        diff = rows.float() - q.float().unsqueeze(-2)
        return (diff * diff).sum(dim=-1).clamp_min(0.0).sqrt()
    dots = _dots(rows, q)
    return 1.0 - dots if metric == "cosine" else -dots


def _rank_matrix(q, rows, metric):
    """Rank of every row of ``rows`` [H, d] against every query of ``q``
    [B, d] (the hub scan), accumulated in f32 from the widened operands:
    one full-f32 product (``no_tf32``) for the dot metrics; l2 takes the
    differences, as ``_rank_rows``, a few queries at a time."""
    q, rows = q.float(), rows.float()
    no_tf32(rows)
    if metric != "l2":
        dots = q @ rows.T
        return 1.0 - dots if metric == "cosine" else -dots
    step = max(1, (1 << 26) // max(1, rows.numel()))
    return torch.cat([_rank_rows(rows.expand(q[s:s + step].shape[0], -1, -1), q[s:s + step], "l2")
                      for s in range(0, q.shape[0], step)])


class DeviceGraph:
    """Device-resident snapshot of an HNSW graph: the vector block, the
    adjacency, the lexicographic id ranks and the hub slots (the top-H slots
    by (level desc, slot)). :meth:`from_host` snapshots a host graph;
    ``hnsw_build.BulkGraph`` is the bulk build's."""

    def __init__(self, *, ids, n, m, m0, lmax, metric, x, a0, up_index, up_adj, lex_rank,
                 entry_slot, entry_level, hub_slots, valid=None):
        self.ids = ids
        self.n = n
        self.m = m
        self.m0 = m0
        self.lmax = lmax
        self.metric = metric
        self.x = x
        self.a0 = a0
        self.up_index = up_index
        self.up_adj = up_adj
        self.lex_rank = lex_rank
        self.entry_slot = int(entry_slot)
        self.entry_level = int(entry_level)
        #: tombstoned slots masked out of results (None: every slot live)
        self.valid = valid
        self._hub_slots_np = np.asarray(hub_slots, dtype=np.int32)
        self._xb = None
        self._hubs = {}

    @classmethod
    def from_host(cls, host) -> "DeviceGraph":
        internals = sorted(host._vectors.keys())
        n = len(internals)
        slot_of = {internal: i for i, internal in enumerate(internals)}
        x = np.zeros((n, host._dim), dtype=np.float32)
        levels = np.zeros(n, dtype=np.int32)
        for internal, slot in slot_of.items():
            x[slot] = host._vectors[internal]
            levels[slot] = host._levels[internal]
        ids = [host._external[i] for i in internals]
        m0, m = host.params["m0"], host.params["m"]
        a0 = np.full((n, m0), -1, dtype=np.int32)
        for internal, slot in slot_of.items():
            conns = host._connections[internal][0] if host._connections[internal] else []
            conns = [slot_of[c] for c in conns if c in slot_of][:m0]
            a0[slot, : len(conns)] = conns

        lmax = int(levels.max()) if n else 0
        upper_slots = np.flatnonzero(levels >= 1)
        up_index = np.full(n, -1, dtype=np.int32)
        up_index[upper_slots] = np.arange(len(upper_slots), dtype=np.int32)
        up_adj = np.full((max(len(upper_slots), 1), max(lmax, 1), m), -1, dtype=np.int32)
        for u, slot in enumerate(upper_slots):
            conns = host._connections[internals[slot]]
            for layer in range(1, len(conns)):
                row = [slot_of[c] for c in conns[layer] if c in slot_of][:m]
                up_adj[u, layer - 1, : len(row)] = row

        order = np.argsort(np.array(ids, dtype=str), kind="stable")
        lex_rank = np.zeros(n, dtype=np.int32)
        lex_rank[order] = np.arange(n, dtype=np.int32)
        hub_slots = np.lexsort((np.arange(n), -levels))[: hub_count(n)]
        dev = host.device
        return cls(
            ids=ids, n=n, m=m, m0=m0, lmax=lmax, metric=host.metric,
            x=torch.from_numpy(x).to(dev), a0=torch.from_numpy(a0).to(dev),
            up_index=torch.from_numpy(up_index).to(dev), up_adj=torch.from_numpy(up_adj).to(dev),
            lex_rank=torch.from_numpy(lex_rank).to(dev),
            entry_slot=slot_of[host._entry], entry_level=levels[slot_of[host._entry]],
            hub_slots=hub_slots,
        )

    @property
    def xb(self):
        """bf16 traversal copy of the vector block (lazy)."""
        if self._xb is None:
            self._xb = self.x.to(torch.bfloat16)
        return self._xb

    def _hub_slots(self) -> np.ndarray:
        return self._hub_slots_np

    def hubs(self, dtype=torch.bfloat16):
        """(hub_slots [H] int64, hub_x [H, d]) in the traversal dtype (lazy)."""
        if dtype not in self._hubs:
            slots = torch.from_numpy(self._hub_slots().astype(np.int64)).to(self.x.device)
            block = self.xb if dtype == torch.bfloat16 else self.x
            self._hubs[dtype] = (slots, block[slots])
        return self._hubs[dtype]

    def hub_validity(self):
        """Liveness of the hub rows (None when nothing is dead)."""
        if self.valid is None:
            return None
        return self.valid[torch.from_numpy(self._hub_slots().astype(np.int64)).to(self.x.device)]


def _any_on_host(flags) -> bool:
    """Whether any of ``flags`` holds: a host read (a wait for the device)."""
    with span("index.wait"):
        return bool(flags.any())


def _on_host(t):
    """``t`` copied to the host: a wait for its device."""
    with span("index.wait"):
        return t.cpu()


def _set_bits(visited, slots, mask):
    """Adds the bits of ``slots`` [B, k] (int64, >= 0) where ``mask`` holds
    to ``visited`` [B, words] (elsewhere it adds 0). Exact only for
    positions that are unique and not yet set."""
    visited.scatter_add_(1, slots >> 5, mask.long() << (slots & 31))


def search_impl(x, a0, up_index, up_adj, lex_rank, entry_slot, entry_level, queries, *,
                metric, lmax, ef, limit, max_steps, xb=None, expand_w=None, hub_slots=None,
                hub_x=None, hub_valid=None, valid=None):
    """Batched beam search of ``queries`` [B, d] f32 (the JAX package's
    ``_search_impl``). ``xb`` is the optional bf16 traversal block (defaults
    to ``x``: full-f32 mode). With ``hub_slots`` / ``hub_x`` the beam seeds
    from a dense hub scan instead of the greedy upper-layer descent;
    ``hub_valid`` masks hub rows that are not live. ``valid`` (bool [n])
    masks tombstoned slots out of the results only. Returns ``(ids [B,
    limit] int64, raws [B, limit] f32, ranks [B, limit] f32)``; missing
    results are id -1, raw and rank +inf."""
    n, m0 = a0.shape
    dev = x.device
    B = queries.shape[0]
    words = (n + 31) // 32
    xt = x if xb is None else xb
    W = min(expand_w or EXPAND_W, ef)
    use_hubs = hub_slots is not None
    S = min(ef, max(W, 8), hub_x.shape[0]) if use_hubs else 1
    q = queries.float()
    qt = q.to(xt.dtype)

    beam_d = torch.full((B, ef), float("inf"), device=dev)
    beam_id = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    beam_exp = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((B, words), dtype=torch.int64, device=dev)

    if use_hubs:
        # ---- hub seeding: one dense scan of the top-H-by-level nodes
        hd = _rank_matrix(qt, hub_x, metric)
        if hub_valid is not None:
            hd = hd.masked_fill(~hub_valid[None, :], float("inf"))
        seed_d, hpos = smallest(hd, S)
        ok_seed = torch.isfinite(seed_d)
        seeds = torch.where(ok_seed, hub_slots[hpos], -1)
        beam_d[:, :S] = seed_d  # ascending, +inf where no seed
        beam_id[:, :S] = seeds
        # hub positions are distinct, so the scatter-add stays exact
        _set_bits(visited, seeds.clamp_min(0), ok_seed)
    else:
        # ---- greedy descent over the upper layers (hnsw.rs:302-305,336-372)
        g = torch.full((B,), int(entry_slot), dtype=torch.int64, device=dev)
        for layer in range(min(lmax, int(entry_level)), 0, -1):
            gd = _rank_rows(xt[g][:, None, :], qt, metric)[:, 0]
            moved = torch.ones(B, dtype=torch.bool, device=dev)
            while _any_on_host(moved):
                u = up_index[g].long()
                row = up_adj[u.clamp_min(0), layer - 1].long()
                row = torch.where((u >= 0)[:, None], row, torch.full_like(row, -1))
                ok = row >= 0
                dists = torch.where(ok, _rank_rows(xt[row.clamp_min(0)], qt, metric),
                                    torch.full(row.shape, float("inf"), device=dev))
                j = dists.argmin(dim=1, keepdim=True)
                best = dists.gather(1, j)[:, 0]
                moved = best < gd  # a lane that stopped stays stopped
                g = torch.where(moved, row.gather(1, j)[:, 0], g)
                gd = torch.where(moved, best, gd)
        beam_d[:, 0] = _rank_rows(xt[g][:, None, :], qt, metric)[:, 0]
        beam_id[:, 0] = g
        _set_bits(visited, g[:, None], torch.ones((B, 1), dtype=torch.bool, device=dev))

    # ---- layer-0 beam (hnsw.rs:375-434), widened: the W best unexpanded
    # entries expand per step. ``live`` holds the batch positions of the
    # queries still searching; a converged query's beam goes to ``final_*``
    # and leaves the working set at the next check. The loop is bound by
    # the host's launches, so each step is written with few tensor calls:
    # the beam stays sorted (its worst entry is its last), a row of -1
    # appended to ``a0`` (row n) makes an unexpanded node's neighbours -1,
    # rows are gathered by ``index_select`` and the bit arithmetic reuses
    # its shifts
    E = W * m0
    inf = float("inf")
    earlier = torch.ones((E, E), dtype=torch.bool, device=dev).tril(-1)  # [i, j]: j < i
    a0x = torch.cat([a0, a0.new_full((1, m0), -1)])  # row n: no neighbours
    final_d, final_id = beam_d.clone(), beam_id.clone()
    live = torch.arange(B, device=dev)
    # while a profiler records: the fresh neighbours scored, summed on the
    # device (observability.snapshot reads the sum, not the search)
    scored = torch.zeros((), dtype=torch.int64, device=dev) if tracing() else None
    steps = 0
    for step in range(max_steps):
        top_d, jpos = smallest(beam_d.masked_fill(beam_exp | (beam_id < 0), inf), W)
        # reference termination: stop when the best unexpanded entry cannot
        # improve the result set (beam not full => worst = inf)
        best = top_d[:, 0]
        done = torch.isinf(best) | (best > beam_d[:, -1])
        n_done = 0
        if step and step % _DONE_EVERY == 0:
            with span("index.wait"):
                n_done = int(done.sum())
        if n_done:
            # converged rows last, each group in batch order; index tensors,
            # not boolean masks, so that this check syncs once
            order = torch.sort(done.to(torch.int8), stable=True).indices
            keep, gone = order[:done.numel() - n_done], order[done.numel() - n_done:]
            final_d[live[gone]], final_id[live[gone]] = beam_d[gone], beam_id[gone]
            if not keep.numel():
                break
            live, beam_d, beam_id, beam_exp = live[keep], beam_d[keep], beam_id[keep], beam_exp[keep]
            visited, qt, top_d, jpos, done = (visited[keep], qt[keep], top_d[keep],
                                              jpos[keep], done[keep])
        expand_ok = torch.isfinite(top_d.masked_fill(done[:, None], inf))

        nodes = torch.where(expand_ok, beam_id.gather(1, jpos), n)
        nbrs = a0x.index_select(0, nodes.reshape(-1)).reshape(-1, E).long()
        # two expanded nodes can share a neighbour: keep its first place in
        # the step (the bitset's scatter-add needs unique bits)
        dup = ((nbrs[:, None, :] == nbrs[:, :, None]) & earlier).any(dim=2)
        safe = nbrs.clamp_min(0)
        word, shift = safe >> 5, safe & 31
        seen = (visited.gather(1, word) >> shift) & 1
        fresh = (nbrs >= 0) & ~dup & (seen == 0)
        # bits of fresh positions only (unique, unset); the rest add 0
        visited.scatter_add_(1, word, fresh.long() << shift)
        rows = xt.index_select(0, safe.reshape(-1)).reshape(*safe.shape, -1)
        nd = _rank_rows(rows, qt, metric).masked_fill(~fresh, inf)
        steps += 1
        if scored is not None:
            scored += fresh.sum()
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_id = torch.cat([beam_id, nbrs.masked_fill(~fresh, -1)], dim=1)
        cat_exp = torch.cat([beam_exp.scatter(1, jpos, beam_exp.gather(1, jpos) | expand_ok),
                             torch.zeros_like(fresh)], dim=1)
        # single-key distance merge, stable: interior ties keep their
        # concatenation order; the exact epilogue restores (f32 rank, lex id)
        beam_d, order = smallest(cat_d, ef)
        beam_id = cat_id.gather(1, order)
        beam_exp = cat_exp.gather(1, order)
    final_d[live], final_id[live] = beam_d, beam_id
    beam_d, beam_id = final_d, final_id
    count("hnsw.steps", steps)
    if scored is not None:
        count("hnsw.nodes", scored)

    # ---- exact epilogue: re-score every surviving beam entry from the f32
    # block and order by (f32 rank, lex id) — hnsw.rs:322-333's (dist,
    # external_id) sort — so bf16 traversal never affects ranking
    ok = beam_id >= 0
    safe = beam_id.clamp_min(0)
    if valid is not None:
        ok = ok & valid[safe]
        beam_id = torch.where(ok, beam_id, -1)
    rank32 = _rank_rows(x[safe], q, metric).masked_fill(~ok, float("inf"))
    lex = torch.where(ok, lex_rank[safe].long(), _BIG32)
    order = lex_sort(rank32, lex)
    top_id = beam_id.gather(1, order)[:, :limit]
    top_d = rank32.gather(1, order)[:, :limit]
    if metric == "l2":
        raw = top_d
    else:
        raw = _dots(x[top_id.clamp_min(0)], q)
    return top_id, raw.masked_fill(top_id < 0, float("inf")), top_d


def _graph(host):
    """The host index's device graph, rebuilt when the index changed."""
    if host._device is None or host._device_version != host._version:
        host._device = host._bulk if host._bulk is not None else DeviceGraph.from_host(host)
        host._device_version = host._version
    return host._device


def search_tensors(host, queries, limit: int):
    """Beam search of ``queries`` ([B, d] tensor, or anything
    ``torch.as_tensor`` takes) over the host index's device graph; returns
    ``(slots [B, k] int64, raws [B, k] f32)`` on the index's device, ``k =
    min(limit, n)``, slot -1 and raw +inf where a query found fewer hits.

    A mutated bulk graph is capacity-padded past ``n`` (its slot high-water
    mark, tombstones included) and masks its tombstones by ``valid``: as in
    the JAX package, ``ef`` and ``k`` are bounded by ``n``, the beam never
    reaches a padded slot (no edge leads there), and a tombstoned slot routes
    the beam but never appears in the results."""
    graph = _graph(host)
    queries = torch.as_tensor(queries, dtype=torch.float32).to(graph.x.device)
    ef = min(max(host.params["ef_search"], limit), graph.n)
    k = min(limit, graph.n)
    bf16 = host.traversal == "bf16"
    hub_slots, hub_x = graph.hubs(torch.bfloat16 if bf16 else torch.float32)
    w = host.params.get("expand_w") or EXPAND_W
    d = graph.x.shape[1]
    # the bitset's int64 words; a step's rows gathered (bf16) and widened
    # (f32), with headroom
    per_query = 8 * ((graph.a0.shape[0] + 31) // 32) + 10 * min(w, ef) * graph.m0 * d
    chunk = max(1, _CHUNK_BYTES // per_query)
    outs = [
        search_impl(
            graph.x, graph.a0, graph.up_index, graph.up_adj, graph.lex_rank,
            graph.entry_slot, graph.entry_level, queries[start:start + chunk],
            metric=graph.metric, lmax=graph.lmax, ef=ef, limit=k,
            max_steps=step_bound(ef, w), xb=graph.xb if bf16 else None,
            hub_slots=hub_slots, hub_x=hub_x, hub_valid=graph.hub_validity(),
            valid=graph.valid, expand_w=w,
        )[:2]
        for start in range(0, queries.shape[0], chunk)
    ]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def search(host, queries: np.ndarray, limit: int) -> list:
    """Batched device search over a host HNSW graph; returns per-query
    ``[(external_id, raw)]`` hit lists."""
    slots, raws = search_tensors(host, np.asarray(queries, dtype=np.float32), limit)
    slots, raws = _on_host(slots), _on_host(raws)
    ids = host._device.ids
    out = []
    with span("index.assemble"):
        for row_slots, row_raws in zip(slots.tolist(), raws.tolist()):
            out.append([(ids[s], r) for s, r in zip(row_slots, row_raws) if s >= 0])
    return out
