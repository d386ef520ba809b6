"""Bulk HNSW construction as cluster-blocked kNN-graph assembly.

The port of ``vettore_tpu/index/hnsw_knn_build.py``, in plain PyTorch: the
default bulk build (``build="auto"`` at scale, or ``"knn"``). It builds the
same :class:`~.hnsw_build.BulkGraph` layout as any bulk build (levels, slot
order, lex tie-breaks, entry, layer layout) from dense matrix products:

1. every layer's node set is a slot PREFIX (slots are (level desc, id)
   ordered), so layer l is just ``slots[:nl]``;
2. k-means clusters the prefix (chunked products + argmax; the centroid
   update is a chunked segment sum), rows sort cluster-major, and 64-row
   windows become routing blocks;
3. each block scores its rows against the rows of its ``PROBES`` nearest
   blocks in one batched product — candidates are CONTIGUOUS by
   construction, so the only gathers move 64-row blocks, not single rows;
4. per row, the best ``2*deg`` candidates (plus each probed block's best
   row) pass through the diversity heuristic
   (:func:`~.hnsw_build._heuristic_select`), giving the forward adjacency;
5. one reciprocal pass per layer (sort edges by (dst, dist, src-lex), cap
   incoming, union with forward rows, rescore, heuristic-prune) — the
   batched equivalent of the reference's add-then-prune (hnsw.rs:220-236).

The graph is deterministic: k-means starts from strided rows, every sort is
stable, and the centroid sums (k-means and the blocks') are taken in
float64 and then rounded to f32: the rows are bf16 values, whose f64 sums
are exact in any order, so the card's atomic scatter-adds give the same
centroids on every run.

Precision follows the JAX package: where it multiplies bf16 rows with
``preferred_element_type=f32``, the rows are widened to f32 here (the
products of bf16 values are exact in f32) and summed in f32; no TF32
(``ops.distance.no_tf32``).

Like the JAX package, this build ignores ``ef_construction``: the
candidate pool is ``PROBES`` blocks of 64 rows, whatever ``ef_construction``
says (a divergence from the Rust reference, whose inserts search with an
``ef_construction`` beam).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import no_tf32
from ..ops.topk import lex_sort, smallest
from .hnsw_build import BulkGraph, _heuristic_select, _prep_order, _slot_block
from .hnsw_device import _BIG32, _pairwise_rank, _rank_rows, _repeats

GROUP = 64
#: neighbor blocks scored per block (x64 rows = the candidate pool per row)
PROBES = 24
#: k-means refinement sweeps over the layer prefix
KMEANS_ITERS = 4
#: blocks scored per chunk of the scoring loop
CHUNK_BLOCKS = 64
#: capacity-bucket floor (blocks): every layer pads up to a pow2 block count
#: at least this large
MIN_NGB = 256
#: rows assigned per chunk of k-means: the JAX package's 65,536, fewer where
#: the chunk's [rows, clusters] f32 products would pass 1 GiB (the
#: assignments are per row, so the chunk cannot change them)
_KM_CHUNK = 65_536
_KM_CHUNK_BYTES = 1 << 30
#: rows pruned per chunk of the reciprocal pass
_PRUNE_CHUNK = 4096


def _next_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1)).bit_length()


def _mm(a, b):
    """f32 product of ``a`` [..., m, k] and ``b`` [..., k, n] from widened
    operands, in full f32."""
    a, b = a.float(), b.float()
    no_tf32(a)
    return torch.matmul(a, b)


def _sqnorm(rows):
    rows = rows.float()
    return (rows * rows).sum(dim=-1)


# ---------------------------------------------------------------------------
# layer setup: k-means over the (bf16) layer prefix, cluster-major sort, and
# block probe lists
# ---------------------------------------------------------------------------


def _kmeans_assign(xt_pad, w, ngb: int, metric: str):
    """Cluster assignment for the padded prefix. Chunked product + argmax
    assignment, segment-sum update, ``KMEANS_ITERS`` sweeps; no f32 copy of
    the corpus is kept (each chunk is widened in turn)."""
    capk, d = xt_pad.shape
    dev = xt_pad.device
    spherical = metric in ("cosine", "inner_product")
    ck = max(1, min(_KM_CHUNK, capk, _KM_CHUNK_BYTES // (4 * ngb)))
    stride = max(1, capk // ngb)
    cent = xt_pad[::stride][:ngb].float() * w[::stride][:ngb, None]
    if cent.shape[0] < ngb:
        cent = torch.cat([cent, cent.new_zeros((ngb - cent.shape[0], d))])

    def assign_chunk(cent_t, csq, xc):
        dots = _mm(xc, cent_t.to(xc.dtype))
        if spherical:
            return dots.argmax(dim=1)
        return (csq[None, :] - 2.0 * dots).argmin(dim=1)

    for _ in range(max(1, KMEANS_ITERS)):
        cent_t = cent.T
        csq = (cent * cent).sum(dim=1)
        sums = torch.zeros((ngb, d), dtype=torch.float64, device=dev)
        cnts = torch.zeros(ngb, dtype=torch.float64, device=dev)
        for s in range(0, capk, ck):
            xc, wc = xt_pad[s:s + ck], w[s:s + ck]
            a = assign_chunk(cent_t, csq, xc)
            sums.index_add_(0, a, xc.double() * wc[:, None].double())
            cnts.index_add_(0, a, wc.double())
        sums, cnts = sums.float(), cnts.float()
        fresh = sums / cnts.clamp_min(1.0)[:, None]
        cent = torch.where((cnts > 0)[:, None], fresh, cent)
    cent_t = cent.T
    csq = (cent * cent).sum(dim=1)
    return torch.cat([assign_chunk(cent_t, csq, xt_pad[s:s + ck]) for s in range(0, capk, ck)])


def _layer_setup(xt, lex_d, nl, *, ngb, probes, metric):
    """Cluster-major layout + probe lists for the layer whose node set is
    slots [0, nl). Returns ``(xs [capb, d] bf16, valid_s, lex_s, slot_s, nb
    [ngb, probes])``."""
    n, d = xt.shape
    dev = xt.device
    capb = ngb * GROUP
    iota = torch.arange(capb, device=dev)
    if ngb <= probes:
        perm = iota
    else:
        head = min(capb, n)
        xt_pad = xt[:head]
        if capb > head:
            xt_pad = torch.cat([xt_pad, xt.new_zeros((capb - head, d))])
        w = (iota < nl).float()
        assign = _kmeans_assign(xt_pad, w, ngb, metric)
        assign = torch.where(iota < nl, assign, torch.full_like(assign, ngb))
        perm = torch.sort(assign, stable=True).indices
    valid_s = perm < nl

    safe = perm.clamp_max(n - 1)
    xs = torch.where(valid_s[:, None], xt[safe], xt.new_zeros(()))
    slot_s = torch.where(valid_s, perm, torch.full_like(perm, -1))
    lex_s = torch.where(valid_s, lex_d[safe].long(), torch.full_like(perm, _BIG32))

    # block (64-row window) centroids -> probed neighbor blocks
    w = valid_s.float().reshape(ngb, GROUP)
    cent = ((xs.double().reshape(ngb, GROUP, d) * w[..., None].double()).sum(dim=1).float()
            / w.sum(dim=1).clamp_min(1.0)[:, None])
    cb = cent.to(torch.bfloat16)
    cdots = _mm(cb, cb.T)
    if metric == "l2":
        c2 = (cent * cent).sum(dim=1)
        crank = c2[:, None] + c2[None, :] - 2.0 * cdots
    else:
        crank = -cdots
    dead = w.sum(dim=1) <= 0.0
    crank = torch.where(dead[None, :], torch.full_like(crank, float("inf")), crank)
    gi = torch.arange(ngb, device=dev)
    crank = torch.where(gi[:, None] == gi[None, :], torch.full_like(crank, float("-inf")),
                        crank)  # self first
    _vals, nb = smallest(crank, min(probes, ngb))
    return xs, valid_s, lex_s, slot_s, nb


# ---------------------------------------------------------------------------
# block scoring: forward adjacency for one chunk of blocks
# ---------------------------------------------------------------------------


def _knn_chunk(adj, dist, xs, valid_s, lex_s, slot_s, nb_chunk, g0, *, metric, deg, csel):
    """Scores one chunk of ``G`` blocks against their probed neighbor blocks
    and writes the heuristic-selected forward adjacency by slot into
    ``adj`` / ``dist`` [capb + 1, deg] (in place; trash row last).

    ``xs`` [capb, d] bf16 cluster-major rows, ``valid_s``/``lex_s``/``slot_s``
    [capb] row metadata in the same order, ``nb_chunk`` [G, P] probed block
    ids per chunk block, ``g0`` first block index."""
    capb, d = xs.shape
    dev = xs.device
    G, P = nb_chunk.shape
    PC = P * GROUP

    rows = xs[g0 * GROUP:(g0 + G) * GROUP].reshape(G, GROUP, d)
    pool = xs.reshape(capb // GROUP, GROUP, d)[nb_chunk].reshape(G, PC, d)

    dots = _mm(rows, pool.transpose(1, 2))
    if metric == "l2":
        rsq, csq = _sqnorm(rows), _sqnorm(pool)
        rank = (rsq[..., :, None] + csq[..., None, :] - 2.0 * dots).clamp_min(0.0).sqrt()
    else:
        rank = 1.0 - dots if metric == "cosine" else -dots

    # candidate metadata in sorted-row space
    pos_c = (nb_chunk[:, :, None] * GROUP
             + torch.arange(GROUP, device=dev)[None, None, :]).reshape(G, PC)
    row_pos = (g0 * GROUP + torch.arange(G * GROUP, device=dev)).reshape(G, GROUP)
    cvalid = valid_s[pos_c]  # [G, PC]
    self_mask = pos_c[:, None, :] == row_pos[:, :, None]
    rank = torch.where(cvalid[:, None, :] & ~self_mask, rank,
                       torch.full_like(rank, float("inf")))

    lex_pool = lex_s[pos_c]  # [G, PC]
    clex = lex_pool[:, None, :].expand(rank.shape)
    cidx_s = lex_sort(rank, clex)
    ncand = min(csel, PC)
    top_cidx = cidx_s[..., :ncand]
    top_rank = rank.gather(2, top_cidx)

    # ---- spread candidates: each probed block's best row. A dense natural
    # cluster fills the whole nearest-``csel`` shortlist with intra-cluster
    # rows, so the diversity heuristic never SEES a cross-cluster candidate
    # and layer 0 degenerates into disconnected islands. One guaranteed
    # candidate per probed block restores an outbound direction toward
    # every nearby cluster; the heuristic then keeps the diverse ones.
    rb = rank.reshape(G, GROUP, P, GROUP)
    sp_rank, sp_arg = rb.min(dim=3)  # first minimum, as argmin
    sp_cidx = sp_arg + torch.arange(P, device=dev)[None, None, :] * GROUP
    cat_rank = torch.cat([top_rank, sp_rank], dim=2)  # [G, K, C']
    cat_cidx = torch.cat([top_cidx, sp_cidx], dim=2)
    cat_lex = clex.gather(2, cat_cidx)
    order = lex_sort(cat_rank, cat_lex)
    cat_rank = cat_rank.gather(2, order)
    cat_cidx = cat_cidx.gather(2, order)
    C4 = cat_cidx.shape[-1]
    # a probed block's best row may be in the shortlist too: keep its first place
    dup = _repeats(cat_cidx)
    top_rank = torch.where(dup, torch.full_like(cat_rank, float("inf")), cat_rank)
    top_cidx = torch.where(dup, torch.zeros_like(cat_cidx), cat_cidx)

    top_pos = pos_c[:, None, :].expand(G, GROUP, PC).gather(2, top_cidx)
    top_slot = torch.where(dup | ~torch.isfinite(top_rank), torch.full_like(top_pos, -1),
                           slot_s[top_pos])

    cvecs = pool.gather(1, top_cidx.reshape(G, GROUP * C4, 1).expand(-1, -1, d))
    pr = _pairwise_rank(cvecs.reshape(G, GROUP, C4, d), metric)
    sel_slot, sel_d = _heuristic_select(top_slot, top_rank, pr, deg)

    # scatter by slot (invalid rows land in the trash row)
    row_slot = slot_s[g0 * GROUP:(g0 + G) * GROUP]
    tgt = torch.where(row_slot >= 0, row_slot, torch.full_like(row_slot, capb))
    adj[tgt] = sel_slot.reshape(G * GROUP, deg).to(adj.dtype)
    dist[tgt] = sel_d.reshape(G * GROUP, deg)


# ---------------------------------------------------------------------------
# reciprocal edges + prune (one segment program per layer)
# ---------------------------------------------------------------------------


def _reciprocal_pass(adj, dist, xt, lex_rank, nl, *, metric, deg):
    """Union each node's forward row with its capped incoming edges, rescore,
    and diversity-prune back to ``deg`` — the add-then-prune semantics of
    hnsw.rs:220-236 as one batched pass. ``adj``/``dist`` [cap + 1, deg] in
    slot space (rows >= nl are -1/inf); returns the pruned ``[cap, deg]``."""
    cap = adj.shape[0] - 1
    n = xt.shape[0]
    dev = xt.device
    src = torch.arange(cap, device=dev)[:, None].expand(cap, deg).reshape(-1)
    dst = adj[:cap].reshape(-1).long()
    dvals = dist[:cap].reshape(-1)
    valid = (dst >= 0) & (src < nl)
    E = dst.shape[0]

    dkey = torch.where(valid, dst, torch.full_like(dst, cap))
    slex = torch.where(valid, lex_rank[src.clamp_max(n - 1)].long(), torch.full_like(src, _BIG32))
    dvals = torch.where(valid, dvals, torch.full_like(dvals, float("inf")))
    # stable sort by (dkey, dist, slex): least significant key first
    order = torch.sort(slex, stable=True).indices
    order = order.gather(0, torch.sort(dvals[order], stable=True).indices)
    order = order.gather(0, torch.sort(dkey[order], stable=True).indices)
    dkey, src_s = dkey[order], src[order]
    iota = torch.arange(E, device=dev)
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = dkey[1:] != dkey[:-1]
    seg_start = torch.cummax(torch.where(first, iota, torch.zeros_like(iota)), dim=0).values
    seg_rank = iota - seg_start
    keep = (dkey < cap) & (seg_rank < deg)

    inc = torch.full((cap + 1, deg), -1, dtype=torch.int64, device=dev)
    inc[torch.where(keep, dkey, torch.full_like(dkey, cap)), seg_rank.clamp_max(deg - 1)] = \
        torch.where(keep, src_s, torch.full_like(src_s, -1))

    cand_all = torch.cat([adj[:cap].long(), inc[:cap]], dim=1)  # [cap, 2*deg]
    pruned = torch.full((cap, deg), -1, dtype=torch.int64, device=dev)
    # rows >= nl stay -1 (live is a prefix of the slots)
    for s in range(0, min(cap, nl), _PRUNE_CHUNK):
        rows_c = torch.arange(s, min(s + _PRUNE_CHUNK, cap, nl), device=dev)
        cand_c = cand_all[rows_c]
        base = xt[rows_c.clamp_max(n - 1)]
        cvalid = (cand_c >= 0) & (cand_c != rows_c[:, None])
        csafe = cand_c.clamp(0, n - 1)
        cd = torch.where(cvalid, _rank_rows(xt[csafe], base, metric),
                         torch.full(cand_c.shape, float("inf"), device=dev))
        clex = torch.where(cvalid, lex_rank[csafe].long(), torch.full_like(cand_c, _BIG32))
        order = lex_sort(cd, clex)
        cd = cd.gather(1, order)
        cand_s = torch.where(cvalid, cand_c, torch.full_like(cand_c, -1)).gather(1, order)
        dup = torch.zeros_like(cvalid)
        dup[:, 1:] = (cand_s[:, 1:] == cand_s[:, :-1]) & (cand_s[:, 1:] >= 0)
        cd = torch.where(dup, torch.full_like(cd, float("inf")), cd)
        cand_s = torch.where(dup, torch.full_like(cand_s, -1), cand_s)
        pr = _pairwise_rank(xt[cand_s.clamp(0, n - 1)], metric)
        pruned[rows_c] = _heuristic_select(cand_s, cd, pr, deg)[0]
    return pruned


# ---------------------------------------------------------------------------
# per-layer assembly + full build
# ---------------------------------------------------------------------------


def _layer_adjacency(xt, lex_d, nl: int, deg: int, metric: str):
    """Forward+reciprocal adjacency for the layer whose node set is slots
    [0, nl). Returns a [nl, deg] int64 tensor (-1 padded)."""
    dev = xt.device
    if nl <= 1:
        return torch.full((max(nl, 1), deg), -1, dtype=torch.int64, device=dev)[:nl]
    # the capacity bucket: a pow2 block count with a floor
    ngb = max(_next_pow2(-(-nl // GROUP)), MIN_NGB)
    capb = ngb * GROUP
    probes = min(PROBES, ngb)

    xs, valid_s, lex_s, slot_s, nb = _layer_setup(xt, lex_d, nl, ngb=ngb, probes=probes,
                                                  metric=metric)
    adj = torch.full((capb + 1, deg), -1, dtype=torch.int64, device=dev)
    dist = torch.full((capb + 1, deg), float("inf"), device=dev)
    G = min(CHUNK_BLOCKS, ngb)
    for g0 in range(0, ngb, G):
        _knn_chunk(adj, dist, xs, valid_s, lex_s, slot_s, nb[g0:g0 + G], g0,
                   metric=metric, deg=deg, csel=2 * deg)
    del xs
    return _reciprocal_pass(adj, dist, xt, lex_d, nl, metric=metric, deg=deg)[:nl]


def bulk_build_knn(metric: str, params: dict, ids, vectors=None, *, device="cuda",
                   x_device=None) -> BulkGraph:
    """Builds a full BulkGraph via cluster-blocked kNN assembly (module
    docstring) from ``vectors`` (host [n, d] f32, in ``ids`` order, uploaded
    once to ``device``) or ``x_device`` (a device-resident [n, d] f32 block
    in ``ids`` order, permuted on its device)."""
    n = int(x_device.shape[0]) if x_device is not None else vectors.shape[0]
    m, m0 = params["m"], params["m0"]
    ids_sorted, order, levels, lex_rank, lmax, up_index, cap_up = _prep_order(
        ids, params["max_level"], n)

    # at most one upload; the slot permutation runs on the device
    xd = _slot_block(order, vectors, device, x_device)
    device = xd.device
    xt = xd.to(torch.bfloat16)
    lex_d = torch.from_numpy(lex_rank).to(device)

    a0 = torch.full((n, m0), -1, dtype=torch.int32, device=device)
    up_adj = torch.full((max(cap_up, 1), max(lmax, 1), m), -1, dtype=torch.int32, device=device)
    for layer in range(0, lmax + 1):
        nl = int(np.sum(levels >= layer))
        if nl <= 1:
            break
        adj = _layer_adjacency(xt, lex_d, nl, m0 if layer == 0 else m, metric).int()
        if layer == 0:
            a0[:nl] = adj
        else:
            up_adj[:nl, layer - 1] = adj
    del xt
    return BulkGraph(
        ids=ids_sorted, n=n, m=m, m0=m0, lmax=lmax, metric=metric,
        x=xd, a0=a0, up_index=torch.from_numpy(up_index).to(device), up_adj=up_adj,
        lex_rank=lex_d, entry_slot=0, entry_level=int(levels[0]) if n else 0,
        levels=levels,
    )
