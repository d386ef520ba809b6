"""IVF (inverted-file) device ops: k-means routing + block-gather rescore.

The port of ``vettore_tpu/ops/ivf.py``. Everything here is plain PyTorch,
as the JAX module computes it outside Pallas, except the rescore: it is K2,
``flat_scan.rescore``, which launches the hand-written CUDA kernel on the
card.

* **build**: k-means over the corpus (assignment = one chunked product +
  argmax per iteration, update = a segment sum), then rows are reordered
  cluster-major and chopped into contiguous ``GROUP``-row blocks;
* **search**: queries rank *block centroids* with one small product
  ([B, d] x [d, N/64]), probe the best ``n_probe`` blocks and rescore only
  those rows through K2: the rows read are ``n_probe * GROUP`` per query
  instead of N. The winners re-score in full f32 like the flat scans.

Routing products are f32 sums of bf16-rounded operands, as JAX's
``jnp.dot(bf16, bf16, preferred_element_type=f32)``: on the card a bf16
GEMM with an f32 output (``torch.mm(..., out_dtype=torch.float32)``: f32
accumulation, no bf16 rounding of the result), on the CPU an f32 product of
the bf16-rounded operands (exact products, f32 sums). A bf16 ``matmul``
would round the ranks that ``argmax`` compares. The operands are bf16 by
definition here, so the f32 search path's rule against single-pass TF32
does not apply to them.

The centroid update is deterministic on the card: rows are sorted by
cluster (a stable sort) and summed per cluster by ``torch.segment_reduce``,
which adds each segment's rows in row order; ``index_add_`` on CUDA adds in
atomic order, so two builds of one corpus could route differently.

Approximation contract matches HNSW (recall measured against the exact
scan); with ``n_probe >= n_blocks`` every row is rescored and results equal
the exact fused scan including (rank, id) tie order.
"""

from __future__ import annotations

import torch

from . import flat_scan, select
from .flat_scan import GROUP, TIE_PAD, _finalize, _group_rows
from .topk import lex_sort, smallest

#: metrics the IVF routing + rescore path serves (the fused-scan set)
IVF_METRICS = ("cosine", "inner_product", "negative_inner_product", "l2",
               "l2_squared")

_BIG32 = 2**31 - 1
_SPHERICAL = ("cosine", "inner_product", "negative_inner_product")


def bf16_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, d] · b [N, d]ᵀ`` as f32 sums of the bf16-rounded operands
    (see the module docstring for the route on each device)."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if a.is_cuda:
        return torch.mm(a16, b16.T, out_dtype=torch.float32)
    return a16.float() @ b16.float().T


# ---------------------------------------------------------------------------
# build: k-means assignment + cluster-major permutation
# ---------------------------------------------------------------------------


def _assign_chunk(xc, cent, csq, *, spherical):
    """Nearest-centroid assignment for one row chunk. ``cent`` [C, d] f32
    centroids (routed in bf16), ``csq`` [C] squared norms. Spherical
    (cosine/IP) routes by max dot; otherwise by min L2 via the norm
    expansion. Ties go to the first centroid, as ``jnp.argmax`` does."""
    dots = bf16_dots(xc, cent)  # [T, C]
    if spherical:
        return dots.argmax(dim=1).int()
    return (csq[None, :] - 2.0 * dots).argmin(dim=1).int()


def _update_centroids(cent, x, w, assign, *, n_cent):
    """One k-means update: weighted segment-mean of rows per centroid.
    ``w`` [N] 0/1 weights mask dead/pad rows out of the statistics. The
    sums run in a fixed order (module docstring)."""
    order = torch.sort(assign, stable=True).indices
    lengths = torch.bincount(assign, minlength=n_cent)
    sums = torch.segment_reduce((x * w[:, None])[order], "sum", lengths=lengths, axis=0,
                                initial=0.0)
    cnts = torch.segment_reduce(w[order], "sum", lengths=lengths, axis=0, initial=0.0)
    fresh = sums / cnts.clamp_min(1.0)[:, None]
    return torch.where((cnts > 0)[:, None], fresh, cent)


def kmeans_assign(x, valid, *, n_cent: int, iters: int, metric: str,
                  chunk: int = 65_536):
    """K-means over a device ``[N, d]`` f32 block; returns the final
    ``assign`` [N] int32. Dead rows (``valid`` False) are pinned to
    sentinel cluster ``n_cent`` so the cluster-major sort packs them into
    trailing blocks (which carry +inf block bias and never win a probe).
    Assignment is a chunked product + argmax, the update one segment sum;
    centroids route in bfloat16 (routing is approximate by design; the
    rescore is full width)."""
    n, d = x.shape
    spherical = metric in _SPHERICAL
    w = valid.float()
    # strided init over the block: dead rows yield zero centroids that only
    # ever attract other dead/zero rows
    stride = max(1, n // n_cent)
    cent = (x[::stride][:n_cent] * w[::stride][:n_cent, None]).float()
    if cent.shape[0] < n_cent:
        cent = torch.cat([cent, cent.new_zeros(n_cent - cent.shape[0], d)])
    assign = None
    for _ in range(max(1, iters)):
        csq = (cent * cent).sum(dim=1)
        assign = torch.cat([_assign_chunk(x[s:s + chunk], cent, csq, spherical=spherical)
                            for s in range(0, n, chunk)])
        cent = _update_centroids(cent, x, w, assign, n_cent=n_cent)
    return torch.where(valid, assign, torch.full_like(assign, n_cent))


def build_blocks(xs, valid_sorted, *, metric):
    """Per-block routing state from a cluster-major block. ``xs`` [N, d] f32
    (dead rows zero), ``valid_sorted`` [N] bool. Returns ``(bcb [NG, d]
    bf16 routing centroids, csq [NG] f32, block_bias [NG] f32, xsq [N] f32,
    bias [N] f32)``. Cosine routing centroids are L2-normalized (block rank
    is then a pure dot like the flat cosine posture, flat.rs:105)."""
    n, d = xs.shape
    ng = n // GROUP
    w = valid_sorted.float()
    cnt = w.reshape(ng, GROUP).sum(dim=1)
    cent = xs.reshape(ng, GROUP, d).sum(dim=1) / cnt.clamp_min(1.0)[:, None]
    if metric == "cosine":
        norm = torch.linalg.norm(cent, dim=1, keepdim=True)
        cent = torch.where(norm > 0.0, cent / norm.clamp_min(1e-30), cent)
    csq = (cent * cent).sum(dim=1)
    inf = float("inf")
    block_bias = torch.where(cnt > 0.0, 0.0, inf).float()
    xsq = (xs * xs).sum(dim=1)
    bias = torch.where(valid_sorted, 0.0, inf).float()
    return cent.to(torch.bfloat16), csq, block_bias, xsq, bias


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def ivf_search(xb, xsq, bias, lex_rank, bcb, csq, block_bias, q, *, metric, nprobe, k):
    """Batched IVF top-k over a cluster-major block.

    ``xb`` [N, d] storage block (f32/bf16), ``xsq``/``bias`` [N] f32,
    ``lex_rank`` [N] int32 id ranks (block-slot order is NOT id order),
    ``bcb`` [NG, d] bf16 routing centroids, ``csq``/``block_bias`` [NG] f32,
    ``q`` [B, d] f32. Returns ``(slots [B, k] int64 block slots, raws [B, k]
    f32 rescored in full f32, ranks [B, k] f32)`` best-first with the flat
    (rank, lex id) tie-break over the probed candidate set.
    """
    n = xb.shape[0]
    b = q.shape[0]
    ng = n // GROUP
    p = min(nprobe, ng)
    qf = q.float()
    dots = bf16_dots(qf, bcb)  # [B, NG]
    if metric in ("cosine", "inner_product"):
        crank = -dots
    elif metric == "negative_inner_product":
        crank = dots
    else:  # l2 / l2_squared: qsq is constant per row, drop it
        crank = csq[None, :] - 2.0 * dots
    crank = crank + block_bias[None, :]
    _cv, gidx, _ok = select.group_topk(crank, p)
    gidx = gidx.clamp_max(ng - 1)

    cand = flat_scan.rescore(xb, xsq, bias, qf, gidx.int(), metric=metric).reshape(b, p * GROUP)
    cand_slots = _group_rows(gidx).reshape(b, p * GROUP)

    sel = min(k + TIE_PAD, p * GROUP)
    sel_rank, pos = smallest(cand, sel)
    sel_slots = cand_slots.gather(1, pos)
    sel_lex = torch.where(torch.isfinite(sel_rank), lex_rank[sel_slots].long(),
                          torch.full_like(sel_slots, _BIG32))
    order = lex_sort(sel_rank, sel_lex)[:, :k]
    top_slot, raw, top_rank = _finalize(xb, qf, sel_slots.gather(1, order),
                                        sel_rank.gather(1, order), metric=metric)
    raw = torch.where(torch.isfinite(top_rank), raw, torch.zeros_like(raw))
    return top_slot, raw, top_rank


def gather_lex_rows(x, idx):
    """``xs[i] = x[idx[i]]`` with ``idx`` -1 meaning a zero pad row — the
    live-rows-in-id-order gather that feeds the k-means build."""
    idx = idx.long()
    rows = x[idx.clamp_min(0)].float()
    return torch.where((idx >= 0)[:, None], rows, torch.zeros_like(rows))


def merge_with_tail(slots, raws, ranks, lex_of_slots, t_slots, t_raws, *, metric, k, capb):
    """(rank, lex) merge of the built block's IVF hits with the pending
    tail's exact hits. Tail slots are encoded past ``capb``; tail rows carry
    lex keys past every built row's (fresh ids sort after equal-rank built
    rows — the build-time lex snapshot can't rank them). Raws ride the sort
    as values, so no post-hoc slot matching."""
    if metric == "cosine":
        t_ranks = 1.0 - t_raws
    elif metric == "inner_product":
        t_ranks = -t_raws
    else:
        t_ranks = t_raws
    inf = float("inf")
    t_live = t_slots >= 0
    a_rank = torch.where(torch.isfinite(ranks), ranks, inf)
    t_rank = torch.where(t_live, t_ranks, inf)
    t_lex = torch.where(t_live, 2**30 + t_slots.long(), _BIG32)
    m_rank = torch.cat([a_rank, t_rank], dim=1)
    m_lex = torch.cat([lex_of_slots.long(), t_lex], dim=1)
    m_slot = torch.cat([slots.long(), t_slots.long() + capb], dim=1)
    m_raw = torch.cat([raws, t_raws], dim=1)
    order = lex_sort(m_rank, m_lex)[:, :k]
    return m_slot.gather(1, order), m_raw.gather(1, order)
