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
  products are exact in f32 and summed in f32, as the JAX package's
  ``preferred_element_type``: on a CUDA device a bf16 product with f32
  output, on the CPU a product of the widened operands); the final result
  set re-scores every surviving beam entry from the f32 block and orders by
  exact (rank, lex id), so bf16 affects only which nodes reach the beam,
  never how results rank.

Ties resolve as the JAX package resolves them: its ``top_k`` picks the
lowest index among equals and its sorts are stable, so every selection here
is a stable ``torch.sort`` (``ops/topk.py``), never ``torch.topk``.

The JAX package runs each query's beam as a ``while_loop`` under ``vmap``.
Here every query of the batch takes each step together. A step of a query
that has converged changes nothing (it expands no node, adds no candidate,
and the stable merge leaves its sorted beam in place), so running it on is
the same as stopping it: the batch keeps its shape, and the host reads the
count of converged queries only every ``_DONE_EVERY`` steps. The loop ends
when every query has converged or after ``step_bound`` steps.

Because the shapes stay fixed, on a CUDA device the ``_DONE_EVERY`` steps
between two reads are one captured CUDA graph (:class:`BeamGraphs`): the
host replays it instead of launching each step's ~70 kernels. The batch is
padded to its bucket (a power of two up to 64 rows, a multiple of 64 above)
by repeats of its first query, so a graph serves every batch size of its
bucket; a graph keeps only the few most recently used captures. CPU
tensors run the same steps eagerly.

The visited bitset keeps 32 bits in each int64 word (torch has no shifts for
uint32): a bit is added by a scatter-add, which stays exact because the
positions of one step are unique (duplicates are masked first) and never
already set. Queries run in chunks sized by the bitset's and the gathered
rows' bytes; results are per query, so the chunk size cannot change them.

The search and the bulk builds (``hnsw_build.py``, ``hnsw_knn_build.py``)
share the traversal defined here: :func:`_step`, :func:`_descend`,
:func:`_seed`, :func:`_repeats` and :func:`_pairwise_rank`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

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

#: batches above this many rows are padded to a multiple of it (smaller
#: ones to a power of two), so a padded batch runs less than 64 rows more
_BUCKET = 64

#: captured beams a device graph keeps (the least recently used go first):
#: each holds its buffers and its graph's memory on the card
_BEAMS_KEPT = 4

#: per device, the one side stream every capture runs on (cuBLAS keeps a
#: workspace for each stream it has run on), and the lock that gives it to
#: one capture at a time
_CAPTURE_STREAMS = {}
_CAPTURE_LOCK = threading.Lock()

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


def _pairwise_rank(cvecs, metric):
    """Candidate-to-candidate rank distances ``[..., C, C]`` of ``cvecs``
    ``[..., C, d]`` (selection only): the rows widened to f32 (bf16 products
    are exact there) and multiplied in full f32, as the JAX package's
    ``preferred_element_type=f32``."""
    v = cvecs.float()
    no_tf32(v)
    dots = torch.matmul(v, v.transpose(-1, -2))
    if metric == "l2":
        sq = (v * v).sum(dim=-1)
        return (sq[..., :, None] + sq[..., None, :] - 2 * dots).clamp_min(0.0).sqrt()
    return 1.0 - dots if metric == "cosine" else -dots


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
        #: the beam's reusable parts over these arrays (its captured steps)
        self.beams = BeamGraphs()

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

    def forget(self) -> None:
        """Drops what was derived from the arrays (the hub rows, the beam's
        adjacency copy and captured steps): every write to them calls it."""
        self._hubs = {}
        self.beams = BeamGraphs()


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


def _bucket(b: int) -> int:
    """The batch a captured beam runs at: ``b`` rounded up to a power of two
    up to ``_BUCKET`` rows, to a multiple of ``_BUCKET`` above."""
    if b > _BUCKET:
        return -(-b // _BUCKET) * _BUCKET
    return 1 << (b - 1).bit_length()


def _chunk(fit: int) -> int:
    """The largest bucket of at most ``fit`` rows (at least 1): a chunk of
    queries padded to its bucket stays within the bytes that sized it."""
    if fit >= _BUCKET:
        return fit // _BUCKET * _BUCKET
    return 1 << (max(1, fit).bit_length() - 1)


class _Beam:
    """The beam of ``rows`` queries (a build's: lanes), in tensors that keep
    their storage from step to step (a captured graph reads and writes them
    in place): the sorted beam (rank, slot, expanded flag), the visited
    bitset, the traversal queries, each row's count of fresh neighbours
    scored, and the count of converged rows after the last block of steps."""

    def __init__(self, rows, ef, words, d, dtype, dev):
        self.d = torch.empty((rows, ef), device=dev)
        self.id = torch.empty((rows, ef), dtype=torch.int64, device=dev)
        self.exp = torch.empty((rows, ef), dtype=torch.bool, device=dev)
        self.visited = torch.empty((rows, words), dtype=torch.int64, device=dev)
        self.qt = torch.empty((rows, d), dtype=dtype, device=dev)
        self.scored = torch.empty(rows, dtype=torch.int64, device=dev)
        self.n_done = torch.empty((), dtype=torch.int64, device=dev)
        #: the captured block of ``_DONE_EVERY`` steps (CUDA), once made
        self.graph = None
        #: held by the call that uses the buffers; the stream it used them on
        self.lock = threading.Lock()
        self.stream = None

    def reset(self) -> None:
        self.d.fill_(float("inf"))
        self.id.fill_(-1)
        self.exp.zero_()
        self.visited.zero_()
        self.scored.zero_()


class BeamGraphs:
    """The parts of the layer-0 beam that outlive a call, for one device
    graph (``DeviceGraph.beams``; ``parallel.hnsw_mesh`` keeps one a shard):
    per device, the adjacency with a row of -1 appended (row ``n``: the
    neighbours of a node not expanded); on a CUDA device, per (device,
    padded batch, ef, W, traversal dtype, metric), the beam's buffers and
    its captured steps, the ``_BEAMS_KEPT`` most recently used only. The
    loop reads neither ``valid`` nor the hubs, so they are no part of the
    key. A write to the graph's arrays drops the whole object
    (``DeviceGraph.forget``)."""

    def __init__(self):
        self._a0x = {}
        self._beams = OrderedDict()
        self._lock = threading.Lock()

    def __deepcopy__(self, memo):
        # what a copy of the graph needs is remade on its first search
        return BeamGraphs()

    def adjacency(self, a0):
        if a0.device not in self._a0x:
            self._a0x[a0.device] = torch.cat([a0, a0.new_full((1, a0.shape[1]), -1)])
        return self._a0x[a0.device]

    def beam(self, key, make):
        """The beam kept under ``key``, made by ``make`` on first use. Beyond
        ``_BEAMS_KEPT`` the least recently used is dropped: its buffers and
        its graph's memory are freed once no call holds it (every limit
        above ``ef_search`` is an ``ef`` of its own, so the keys a service
        asks for are not bounded)."""
        with self._lock:
            beam = self._beams.pop(key, None)
            if beam is None:
                beam = make()
            self._beams[key] = beam
            while len(self._beams) > _BEAMS_KEPT:
                self._beams.popitem(last=False)
        return beam


def _frontier(beam, w):
    """The ``w`` best unexpanded entries of each beam (ranks ascending, +inf
    where there are fewer; their positions), and whether the beam has
    converged: the reference's stop, when its best unexpanded entry cannot
    improve the result set (a beam not yet full has a worst entry of +inf)."""
    top_d, jpos = smallest(beam.d.masked_fill(beam.exp | (beam.id < 0), float("inf")), w)
    best = top_d[:, 0]
    return top_d, jpos, torch.isinf(best) | (best > beam.d[:, -1])


def _traversal_rank(rows, q, metric):
    """``_rank_rows`` of a step's gathered rows [B, E, d] against ``q`` [B,
    d]. On a CUDA device bf16 rows of a dot metric multiply as bf16 with f32
    accumulation and output, reading the rows once where widening them
    first writes and reads an f32 copy twice their size; the products are
    exact in f32 either way, only the order of the f32 sums differs. The
    CPU has no such product (``torch.bmm`` takes no ``out_dtype`` there),
    so it keeps the widened one: that is the reference the JAX comparisons
    hold, and the card tests hold the card's traversal against it."""
    if metric != "l2" and rows.is_cuda and rows.dtype == torch.bfloat16:
        dots = torch.bmm(rows, q.unsqueeze(-1), out_dtype=torch.float32).squeeze(-1)
        return 1.0 - dots if metric == "cosine" else -dots
    return _rank_rows(rows, q, metric)


def _seed(beam, d, slots):
    """Seeds ``beam``'s first ``b`` rows with ranks ``d`` [b, s] and slots
    ``slots`` [b, s] (distinct in a row, so the bits' scatter-add is exact;
    -1 where ``d`` is +inf: no seed, written at +inf with no bit)."""
    b, s = slots.shape
    ok = slots >= 0
    beam.d[:b, :s] = torch.where(ok, d, float("inf"))
    beam.id[:b, :s] = slots
    _set_bits(beam.visited[:b], slots.clamp_min(0), ok)


def _adjacency(a0, up_adj, up_index, layer, start=None):
    """``nodes [...] -> neighbours [..., deg]`` (int64) of one layer: ``a0``
    at layer 0, above it the node's upper row (-1 for a node without one).
    With ``start`` (a build's count of inserted slots) the slots at or past
    it are -1 too: they are not in the graph yet."""
    def rows(nodes):
        if layer == 0:
            got = a0[nodes].long()
        else:
            u = up_index[nodes].long()
            got = up_adj[u.clamp_min(0), layer - 1].long()
            got = torch.where((u >= 0)[..., None], got, -1)
        return got if start is None else torch.where(got < start, got, -1)
    return rows


def _descend(xt, adj, q, g, moved, metric, read=lambda flags: bool(flags.any())):
    """Greedy descent on one upper layer (hnsw.rs:336-372) for the lanes of
    ``q`` [b, d] from the slots ``g`` [b]: while a lane where ``moved``
    holds has a neighbour (``adj``, -1 for none) closer than its slot, it
    moves to the closest; the other lanes keep ``g``. A lane that stopped
    stays stopped. ``read`` is the host read of whether any lane moved (the
    search's is an ``index.wait`` span)."""
    gd = _rank_rows(xt[g][:, None, :], q, metric)[:, 0]
    while read(moved):
        row = adj(g[:, None])[:, 0]
        dists = _rank_rows(xt[row.clamp_min(0)], q, metric).masked_fill(row < 0, float("inf"))
        j = dists.argmin(dim=1, keepdim=True)  # the first of equal minima
        best = dists.gather(1, j)[:, 0]
        moved = moved & (best < gd)
        g = torch.where(moved, row.gather(1, j)[:, 0], g)
        gd = torch.where(moved, best, gd)
    return g


def _repeats(keys):
    """Whether each of ``keys`` [..., k] repeats an earlier key of its row.
    A stable sort puts equal keys together in their order; all but the first
    of a run repeat."""
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    repeat = torch.zeros_like(keys, dtype=torch.bool)
    repeat[..., 1:] = sorted_keys[..., 1:] == sorted_keys[..., :-1]
    return torch.empty_like(repeat).scatter_(-1, perm, repeat)


def _step(beam, xt, neighbours, rank, metric, w):
    """One beam step (hnsw.rs:375-434, widened) on ``beam``'s buffers, in
    place: the ``w`` best unexpanded entries of each row expand, their fresh
    neighbours are scored by ``rank`` and marked visited, each row's count
    of them is added to ``scored``, and the best ``ef`` of beam and
    neighbours stay. A converged row expands nothing and keeps its beam.

    ``neighbours(nodes, expand)`` gives the neighbours [b, w * deg] of the
    entries ``nodes`` [b, w] (-1 where a beam holds fewer), -1 wherever a
    neighbour is not eligible: every position whose ``expand`` is false,
    and for a build the slots not yet inserted. The duplicate test runs on
    these keys, so an ineligible earlier copy of a slot cannot hide an
    eligible later one.

    The search captures this step in a CUDA graph: it reads nothing on the
    host, makes no shape from data and branches on no tensor value. The
    loop is bound by its launches (eagerly) or by the card, so a step is
    written with few tensor calls: the beam stays sorted (its worst entry is
    its last), rows are gathered by ``index_select`` and the bit arithmetic
    reuses its shifts."""
    inf = float("inf")
    top_d, jpos, done = _frontier(beam, w)
    expand_ok = torch.isfinite(top_d.masked_fill(done[:, None], inf))
    nbrs = neighbours(beam.id.gather(1, jpos), expand_ok)
    # two expanded nodes can share a neighbour: keep its first place in the
    # step (the bitset's scatter-add needs unique bits)
    dup = _repeats(nbrs)
    safe = nbrs.clamp_min(0)
    word, shift = safe >> 5, safe & 31
    seen = (beam.visited.gather(1, word) >> shift) & 1
    fresh = (nbrs >= 0) & ~dup & (seen == 0)
    # bits of fresh positions only (unique, unset); the rest add 0
    beam.visited.scatter_add_(1, word, fresh.long() << shift)
    rows = xt.index_select(0, safe.reshape(-1)).reshape(*safe.shape, -1)
    nd = rank(rows, beam.qt, metric).masked_fill(~fresh, inf)
    beam.scored += fresh.sum(dim=1)
    cat_d = torch.cat([beam.d, nd], dim=1)
    cat_id = torch.cat([beam.id, nbrs.masked_fill(~fresh, -1)], dim=1)
    cat_exp = torch.cat([beam.exp.scatter(1, jpos, beam.exp.gather(1, jpos) | expand_ok),
                         torch.zeros_like(fresh)], dim=1)
    # single-key distance merge, stable: interior ties keep their
    # concatenation order; the exact epilogue restores (f32 rank, lex id)
    best, order = smallest(cat_d, beam.d.shape[1])
    beam.d.copy_(best)
    torch.gather(cat_id, 1, order, out=beam.id)
    torch.gather(cat_exp, 1, order, out=beam.exp)


def _steps(beam, k, xt, neighbours, rank, metric, w):
    """``k`` steps, then the count of converged rows into ``beam.n_done``."""
    for _ in range(k):
        _step(beam, xt, neighbours, rank, metric, w)
    beam.n_done.copy_(_frontier(beam, w)[2].sum())


def _replay(beam, block, dev):
    """Runs ``block`` (``_DONE_EVERY`` steps) as ``beam``'s captured graph,
    capturing it on first use: that block runs eagerly on the device's side
    stream (the warm-up a capture needs, so that cuBLAS and the allocator
    are set up outside it), then the same block is captured, which runs
    nothing."""
    if beam.graph is not None:
        beam.graph.replay()
        count("hnsw.replays")
        return
    current = torch.cuda.current_stream(dev)
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK:
        side = _CAPTURE_STREAMS.get(dev)
        if side is None:
            side = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            block()
            graph.capture_begin()
            try:
                block()
            finally:
                graph.capture_end()
        current.wait_stream(side)
    beam.graph = graph
    count("hnsw.captures")


def search_impl(x, a0, up_index, up_adj, lex_rank, entry_slot, entry_level, queries, *,
                metric, lmax, ef, limit, max_steps, xb=None, expand_w=None, hub_slots=None,
                hub_x=None, hub_valid=None, valid=None, beams=None):
    """Batched beam search of ``queries`` [B, d] f32 (the JAX package's
    ``_search_impl``). ``xb`` is the optional bf16 traversal block (defaults
    to ``x``: full-f32 mode). With ``hub_slots`` / ``hub_x`` the beam seeds
    from a dense hub scan instead of the greedy upper-layer descent;
    ``hub_valid`` masks hub rows that are not live. ``valid`` (bool [n])
    masks tombstoned slots out of the results only. ``beams`` (a
    :class:`BeamGraphs` over these arrays) keeps the beam's parts between
    calls; on a CUDA device the steps then replay as captured graphs.
    Returns ``(ids [B, limit] int64, raws [B, limit] f32, ranks [B, limit]
    f32)``; missing results are id -1, raw and rank +inf."""
    n = a0.shape[0]
    dev = x.device
    B = queries.shape[0]
    words = (n + 31) // 32
    xt = x if xb is None else xb
    W = min(expand_w or EXPAND_W, ef)
    use_hubs = hub_slots is not None
    S = min(ef, max(W, 8), hub_x.shape[0]) if use_hubs else 1
    q = queries.float()
    qt = q.to(xt.dtype)

    parts = beams if beams is not None else BeamGraphs()
    a0x = parts.adjacency(a0)
    idle = a0x.shape[0] - 1  # a0x's row of -1: an entry that does not expand

    def neighbours(nodes, expand):
        nodes = torch.where(expand, nodes, idle)
        return a0x.index_select(0, nodes.reshape(-1)).reshape(nodes.shape[0], -1).long()

    rank = _traversal_rank  # looked up per call: the card tests replace it
    rows, beam = B, None
    if beams is not None and dev.type == "cuda":
        rows = _bucket(B)
        beam = beams.beam((dev, rows, ef, W, xt.dtype, metric),
                          lambda: _Beam(rows, ef, words, q.shape[1], xt.dtype, dev))
        if beam.lock.acquire(blocking=False):
            current = torch.cuda.current_stream(dev)
            if beam.stream is not None and beam.stream != current:
                current.wait_stream(beam.stream)
            beam.stream = current
        else:  # another thread's call holds the buffers: this one runs eagerly
            rows, beam = B, None
    cached = beam is not None
    if beam is None:
        beam = _Beam(B, ef, words, q.shape[1], xt.dtype, dev)
    try:
        beam.reset()
        if use_hubs:
            # ---- hub seeding: one dense scan of the top-H-by-level nodes
            hd = _rank_matrix(qt, hub_x, metric)
            if hub_valid is not None:
                hd = hd.masked_fill(~hub_valid[None, :], float("inf"))
            seed_d, hpos = smallest(hd, S)  # ascending, +inf where no seed
            _seed(beam, seed_d, torch.where(torch.isfinite(seed_d), hub_slots[hpos], -1))
        else:
            # ---- greedy descent over the upper layers (hnsw.rs:302-305,336-372)
            g = torch.full((B,), int(entry_slot), dtype=torch.int64, device=dev)
            for layer in range(min(lmax, int(entry_level)), 0, -1):
                g = _descend(xt, _adjacency(a0, up_adj, up_index, layer), qt, g,
                             torch.ones(B, dtype=torch.bool, device=dev), metric, _any_on_host)
            _seed(beam, _rank_rows(xt[g][:, None, :], qt, metric), g[:, None])
        beam.qt[:B] = qt
        if rows > B:  # pad rows repeat the first query: they converge with it
            for t in (beam.d, beam.id, beam.visited, beam.qt):
                t[B:] = t[:1]

        # ---- layer-0 beam: blocks of _DONE_EVERY steps at the full batch,
        # the count of converged rows read after each (the last block may be
        # shorter, and runs eagerly)
        def block(k=_DONE_EVERY):
            _steps(beam, k, xt, neighbours, rank, metric, W)

        steps = 0
        while steps < max_steps:
            k = min(_DONE_EVERY, max_steps - steps)
            if cached and k == _DONE_EVERY:
                _replay(beam, block, dev)
            else:
                block(k)
            steps += k
            if steps < max_steps:
                with span("index.wait"):
                    if int(beam.n_done) == rows:
                        break
        count("hnsw.steps", steps)
        # the step adds each row's fresh neighbours to ``scored`` whether or
        # not a trace runs (a captured step cannot branch on it)
        if tracing():
            count("hnsw.nodes", beam.scored[:B].sum())

        # ---- exact epilogue: re-score every surviving beam entry from the
        # f32 block and order by (f32 rank, lex id) — hnsw.rs:322-333's
        # (dist, external_id) sort — so bf16 traversal never affects ranking
        beam_id = beam.id[:B]
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
    finally:
        if cached:
            beam.lock.release()
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
    # the bitset's int64 words; a step's gathered rows (bf16, or f32 where
    # they are widened: l2, f32 traversal, the CPU) and the step's other
    # temporaries, with headroom
    per_query = 8 * ((graph.a0.shape[0] + 31) // 32) + 10 * min(w, ef) * graph.m0 * d
    chunk = _chunk(_CHUNK_BYTES // per_query)
    outs = [
        search_impl(
            graph.x, graph.a0, graph.up_index, graph.up_adj, graph.lex_rank,
            graph.entry_slot, graph.entry_level, queries[start:start + chunk],
            metric=graph.metric, lmax=graph.lmax, ef=ef, limit=k,
            max_steps=step_bound(ef, w), xb=graph.xb if bf16 else None,
            hub_slots=hub_slots, hub_x=hub_x, hub_valid=graph.hub_validity(),
            valid=graph.valid, expand_w=w, beams=graph.beams,
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
