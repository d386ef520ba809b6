"""Fused exact flat scan: group-min scan kernel + candidate rescore kernel.

The port of ``vettore_tpu/ops/flat_scan.py::fused_flat_search``. Two
hand-written CUDA kernels (``csrc/flat_scan.cu``) carry it, each beside its
plain PyTorch version in this module:

* **K1** ``gmin_scan`` — matmul, rank conversion and a 64-row group-min in
  one pass; only ``[B, N/64]`` group minima reach device memory. The kernel
  epilogue carries no finiteness checks: overflow safety is proven per batch
  OUTSIDE the kernel by a Cauchy-Schwarz norm bound (queries that could
  overflow an f32 accumulator flag ``ok=False`` → f64 host oracle).
* **group selection** (plain torch): the ``k + slack`` best groups per
  query, exact by the order-statistic bound — the k smallest group-mins are
  k distinct elements, so any group whose min exceeds the k-th smallest
  group-min cannot contain a top-k element. Ties at the boundary deeper
  than the slack clear the ``ok`` flag (host-oracle fallback).
* **K2** ``rescore`` — each (query, selected group) pair re-ranks the 64
  contiguous rows of its group; no ``[B, N]``-sized gather.
* **final selection** (plain torch): the ``k + tie pad`` best candidates by
  rank, then a small (rank, lex id) sort — the reference's (rank, id)
  tie-break, flat.rs:34-40. A rank tie straddling the pad boundary clears
  ``ok`` (lex order not provable without the full candidate sort).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors; any other device raises. Each keeps a launch
count in ``LAUNCHES`` (kernel launches only; the plain versions count
nothing).
"""

from __future__ import annotations

import torch

from . import select
from .distance import no_tf32
from .topk import lex_sort, smallest

#: rows per selection group (one K1 block owns exactly one group)
GROUP = 64

#: extra groups gathered beyond k — absorbs cross-group ties at the k-th
#: group-min boundary (ties deeper than this clear the ok flag)
GROUP_SLACK = 8

#: extra winners taken beyond k in the final by-rank selection — absorbs
#: exact rank ties at the k-th boundary so the (rank, lex) sort stays
#: provably complete (deeper ties clear the ok flag)
TIE_PAD = 16

#: largest supported k
MAX_FUSED_K = 128

FUSED_METRICS = ("cosine", "inner_product", "negative_inner_product", "l2", "l2_squared")

_BIG32 = 2**31 - 1

#: overflow-proof bound: per-term cap so |xsq| + 2|dot| + |qsq| stays under
#: f32 max with margin for bf16 rounding and accumulation-order effects
_SAFE_LIM = 4e37
_SAFE_LOG = 86.0  # log(2.2e37) >= log(|dot|) bound via Cauchy-Schwarz

#: kernel launch counts, by kernel name
LAUNCHES = {"gmin_scan": 0, "rescore": 0}


def supports(metric: str, cap: int, k: int) -> bool:
    """Whether the fused group-min scan handles this configuration."""
    return metric in FUSED_METRICS and cap % GROUP == 0 and 0 < k <= MAX_FUSED_K


def _is_l2(metric: str) -> bool:
    return metric in ("l2", "l2_squared")


def _check_operands(x, xsq, bias, q):
    n, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if n % GROUP:
        raise ValueError(f"row count {n} is not a multiple of {GROUP}")
    for name, t, shape in (("xsq", xsq, (n,)), ("bias", bias, (n,)), ("q", q, (q.shape[0], d))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for t in (xsq, bias, q):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")


def _launch_args(x, xsq, bias, q, qsq):
    for t in (x, xsq, bias, q, qsq):
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return (x.data_ptr(), int(x.dtype == torch.bfloat16), xsq.data_ptr(), bias.data_ptr(),
            q.data_ptr(), qsq.data_ptr())


def _rank(dots, xsq, qsq, metric):
    """The shared rank key: -dot for the dot metrics (cosine's 1-dot offset
    is applied at the end), squared distance for l2 / l2_squared."""
    if _is_l2(metric):
        return xsq - 2.0 * dots + qsq
    return -dots


# ---------------------------------------------------------------------------
# K1: matmul + rank + bias + 64-row group-min
# ---------------------------------------------------------------------------


def _scan_query(x, q):
    """The query K1 multiplies with: rounded to bf16 under bf16 storage, so
    the scan sees bf16 x bf16 products (the f32 query still gives qsq)."""
    return q.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else q


def _gmin_scan_ref(x, xsq, bias, q, *, metric):
    """Plain PyTorch version of K1: ``[B, N/64]`` group minima of
    ``rank(x . q) + bias``. Products and sums run in f32, which is exact for
    products of bf16 values."""
    no_tf32(x)
    n = x.shape[0]
    b = q.shape[0]
    dots = _scan_query(x, q) @ x.float().T  # [B, N]
    rank = _rank(dots, xsq[None, :], (q * q).sum(dim=1)[:, None], metric) + bias[None, :]
    return rank.reshape(b, n // GROUP, GROUP).amin(dim=-1)


def _bounded(xsq, qsq):
    """Per-batch overflow proof: every partial sum of ``x_row . q`` is
    bounded by ``|x_row| * |q|`` (Cauchy-Schwarz holds for every prefix), so
    when ``max_row_norm * max_query_norm`` and the squared-norm terms sit well
    under f32 max, every intermediate is finite. 0-dim bool tensor."""
    xsq_max = xsq.max()
    qlog = 0.5 * torch.log(qsq.clamp_min(1e-30))
    xlog = 0.5 * torch.log(xsq_max.clamp_min(1e-30))
    return ((qsq < _SAFE_LIM) & (xsq_max < _SAFE_LIM) & (qlog + xlog < _SAFE_LOG)).all()


def gmin_scan(x, xsq, bias, q, *, metric):
    """Group minima of the rank matrix: ``([B, N/64] f32, bounded)``.

    ``x`` [N, d] f32 or bf16, ``xsq`` / ``bias`` [N] f32, ``q`` [B, d] f32.
    Under bf16 storage the query is rounded to bf16 for the scan (the
    matmul sees bf16 x bf16 products); ``qsq`` always comes from the f32
    query. ``bounded`` is False when the batch fails the overflow bound."""
    _check_operands(x, xsq, bias, q)
    qsq = (q * q).sum(dim=1)
    bounded = _bounded(xsq, qsq)
    if x.device.type == "cpu":
        return _gmin_scan_ref(x, xsq, bias, q, metric=metric), bounded
    if not x.is_cuda:
        raise ValueError(f"gmin_scan runs on cuda or cpu tensors, not {x.device}")
    from .. import _build

    n, d = x.shape
    b = q.shape[0]
    qs = _scan_query(x, q).contiguous()
    gmin = torch.empty((b, n // GROUP), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.vt_gmin_scan(*_launch_args(x, xsq, bias, qs, qsq), gmin.data_ptr(),
                            n, d, b, int(_is_l2(metric)),
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "gmin_scan")
    LAUNCHES["gmin_scan"] += 1
    return gmin, bounded


# ---------------------------------------------------------------------------
# K2: candidate-group rescore
# ---------------------------------------------------------------------------


def _group_rows(gidx):
    """Slots of every row of the selected groups: ``[B, gsel, 64]`` int64."""
    return gidx.long()[:, :, None] * GROUP + torch.arange(GROUP, device=gidx.device)


def _rescore_ref(x, xsq, bias, q, gidx, *, metric):
    """Plain PyTorch version of K2: ranks of every row of the selected
    groups, ``[B, gsel, 64]`` f32, against the f32 query (also under bf16
    storage); non-finite ranks become +inf."""
    no_tf32(x)
    rows = _group_rows(gidx)
    qf = q.float()
    dots = torch.einsum("bgrd,bd->bgr", x[rows].float(), qf)
    rank = _rank(dots, xsq[rows], (qf * qf).sum(dim=1)[:, None, None], metric) + bias[rows]
    return torch.where(torch.isfinite(rank), rank, torch.full_like(rank, float("inf")))


def rescore(x, xsq, bias, q, gidx, *, metric):
    """Ranks of every row of the selected groups: ``[B, gsel, 64]`` f32.
    ``gidx`` [B, gsel] int32 group indices (values in ``[0, N/64)``)."""
    _check_operands(x, xsq, bias, q)
    b, gsel = gidx.shape
    if b != q.shape[0]:
        raise ValueError(f"gidx has {b} rows for {q.shape[0]} queries")
    if gidx.dtype != torch.int32 or gidx.device != x.device:
        raise TypeError("gidx must be an int32 tensor on the operands' device")
    if x.device.type == "cpu":
        return _rescore_ref(x, xsq, bias, q, gidx, metric=metric)
    if not x.is_cuda:
        raise ValueError(f"rescore runs on cuda or cpu tensors, not {x.device}")
    from .. import _build

    n, d = x.shape
    q = q.contiguous()
    qsq = (q * q).sum(dim=1)
    gidx = gidx.contiguous()
    out = torch.empty((b, gsel, GROUP), dtype=torch.float32, device=x.device)
    lib = _build.load()
    code = lib.vt_rescore(*_launch_args(x, xsq, bias, q, qsq), gidx.data_ptr(),
                          out.data_ptr(), n, d, b, gsel, int(_is_l2(metric)),
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "rescore")
    LAUNCHES["rescore"] += 1
    return out


# ---------------------------------------------------------------------------
# end-to-end fused search
# ---------------------------------------------------------------------------


def fused_flat_search(x, xsq, bias, lex_rank, q, *, metric, k):
    """Exact batched top-k over a device block.

    ``x`` [N, d] (f32 or bf16 storage), ``xsq`` [N] f32 squared norms,
    ``bias`` [N] f32 (0 valid / +inf invalid), ``lex_rank`` [N] int32
    lexicographic id ranks, ``q`` [B, d] f32 queries. Invalid rows of ``x``
    must be all-zero (the flat index zeroes dead slots) so their rank is
    exactly the +inf bias.

    Returns ``(slots [B, k] int64, raws [B, k] f32, ranks [B, k] f32, ok)``
    best-first with (rank, lex id) tie-break; ``ok`` (0-dim bool tensor)
    False means the batch failed the overflow-safety norm bound or a tie
    spill — caller must re-run on the host oracle.
    """
    n = x.shape[0]
    b = q.shape[0]
    gmin, bounded = gmin_scan(x, xsq, bias, q, metric=metric)
    ng = n // GROUP
    gsel = min(k + GROUP_SLACK, ng)
    # tie spill check at the K boundary: every group with min <= m_k must be
    # selected (GROUP_SLACK absorbs up to 8 tied groups past it)
    _gtop, gidx, g_ok = select.group_topk(gmin, gsel, check_c=k)
    spill_ok = g_ok.all()

    cand = rescore(x, xsq, bias, q, gidx.int(), metric=metric).reshape(b, gsel * GROUP)
    cand_slots = _group_rows(gidx).reshape(b, gsel * GROUP)

    sel = min(k + TIE_PAD, gsel * GROUP)
    sel_rank, pos = smallest(cand, sel)
    sel_slots = cand_slots.gather(1, pos)
    sel_lex = torch.where(torch.isfinite(sel_rank), lex_rank[sel_slots].long(),
                          torch.full_like(sel_slots, _BIG32))
    order = lex_sort(sel_rank, sel_lex)
    rank_s = sel_rank.gather(1, order)
    slot_s = sel_slots.gather(1, order)
    # a rank tie crossing the pad boundary means lex-smaller ids may sit
    # outside the selected pad — not provably exact, flag it
    tie_ok = ((rank_s[:, k - 1] < sel_rank[:, sel - 1])
              | ~torch.isfinite(sel_rank[:, sel - 1])).all()
    top_slot, raw, top_rank = _finalize(x, q, slot_s[:, :k], rank_s[:, :k], metric=metric)
    return top_slot, raw, top_rank, bounded & spill_ok & tie_ok


def _finalize(x, q, top_slot, top_rank, *, metric):
    """Re-scores the k winners in full f32 (raw values must be f32-exact
    regardless of the storage/selection dtype)."""
    rows = x[top_slot].float()
    qf = q.float()
    if _is_l2(metric):
        # selection ranked via the xsq - 2qx + qsq expansion (monotonic, one
        # matmul); winners re-score DIRECTLY — the expansion cancels
        # catastrophically near zero (distances.rs computes (a-b)^2 directly)
        diff = rows - qf[:, None, :]
        sq = (diff * diff).sum(dim=-1)
        raw = sq.sqrt() if metric == "l2" else sq
        top_rank = torch.where(torch.isfinite(top_rank), raw, torch.full_like(raw, float("inf")))
    else:
        no_tf32(rows)  # the einsum below is a batched matmul on the card
        rdots = torch.einsum("bkd,bd->bk", rows, qf)
        raw = -rdots if metric == "negative_inner_product" else rdots
        if metric == "cosine":
            top_rank = 1.0 + top_rank  # rank key was -dot
    return top_slot, raw, top_rank
