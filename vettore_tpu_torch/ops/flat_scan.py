"""Fused flat scans: the exact flat search and the adaptive stage-1 scans.

The port of ``vettore_tpu/ops/flat_scan.py``. ``fused_flat_search`` is
carried by two hand-written CUDA kernels (``csrc/flat_scan.cu``), each
beside its plain PyTorch version in this module:

* **K1** ``gmin_scan`` — matmul, rank conversion and a 64-row group-min in
  one pass; only ``[B, N/64]`` group minima reach device memory. The
  products run on the tensor cores (``csrc/wgmma_scan.cuh``): bf16 blocks
  as bf16 products, f32 blocks as three TF32 products of split operands
  (3xTF32, about f32's accuracy; no single-pass TF32). The kernel
  epilogue carries no finiteness checks: overflow safety is proven per batch
  OUTSIDE the kernel by a Cauchy-Schwarz norm bound (queries that could
  overflow an f32 accumulator flag ``ok=False`` → f64 host oracle).
* **group selection** (plain torch): the ``k + slack`` best groups per
  query, exact by the order-statistic bound — the k smallest group-mins are
  k distinct elements, so any group whose min exceeds the k-th smallest
  group-min cannot contain a top-k element. Ties at the boundary deeper
  than the slack clear the ``ok`` flag (host-oracle fallback).
* **K2** ``rescore`` — re-ranks the 64 contiguous rows of every (query,
  selected group) pair; no ``[B, N]``-sized gather. Group-major
  (``csrc/group_rescore.cuh``): for f32 rows the pairs are sorted by group
  on the card (``_rescore_plan``), and each selected group's rows are read
  from device memory once per work item for every query that chose it.
* **final selection** (plain torch): the ``k + tie pad`` best candidates by
  rank, then a small (rank, lex id) sort — the reference's (rank, id)
  tie-break, flat.rs:34-40. A rank tie straddling the pad boundary clears
  ``ok`` (lex order not provable without the full candidate sort).

The adaptive pipelines (``ops/pipeline.py``) run three more kernels
(``csrc/adaptive_scan.cu``):

* **K5** ``stage_gmin_scan`` — funnel stage 1: the true stage metric over
  the first ``dims`` columns, its 64-row group minima AND the full ``[B, N]``
  rank matrix, in one pass (``fused_stage_candidates`` selects from them),
  on K1's tensor-core mainloop and operand policies;
* **K6** ``fused_sign_scan`` — quantized stage 1: Hamming distances of ±1
  int8 sign rows, their 64-row group minima and the ``[B, N]`` int16
  Hamming matrix, in one pass, on the int8 tensor cores;
* **K7** ``extract_group_rows`` — the gather of selected 64-wide group rows
  out of K5's or K6's ``[B, N]`` matrix (and of the MaxSim rank matrix,
  ``ops/maxsim.py``).

``fused_int8_search`` (``FlatIndex`` int8 storage) runs two more
(``csrc/int8_scan.cu``):

* **K3** ``int8_gmin_scan`` — int8 x int8 exact int32 dots, dequantized by
  the row and query scales, the K1 rank and its 64-row group minima. K1,
  K3, K5 and K6 share one tensor-core scan skeleton (``csrc/wgmma_scan.cuh``),
  fed by TMA, with the MaxSim scan (``ops/maxsim.py``); ``ROUTES`` counts
  whether their operands were read in place or first copied to a stride
  TMA can address;
* **K4** ``int8_rescore`` — the selected groups' int8 rows against the full
  f32 query, dequantized after the sum: K2's group-major kernel on int8
  rows; ``ROUTES`` counts both rescores' staging route.

Each kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors; any other device raises. Each keeps a launch
count in ``LAUNCHES`` (kernel launches only; the plain versions count
nothing).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
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
LAUNCHES = {"gmin_scan": 0, "rescore": 0, "int8_gmin_scan": 0, "int8_rescore": 0,
            "stage_gmin_scan": 0, "sign_scan": 0, "extract_group_rows": 0}

#: launches by operand route. The tensor-core scans: "direct" when TMA
#: reads every operand in place, "padded" when one of them first went
#: through ``_tma_rows``'s copy. The rescores (K2, K4): "direct" when the
#: rows are staged by 16-byte bulk copies and read 16 bytes a lane,
#: "narrow" when a row stride or base rules that out and the same kernel
#: copies and reads one element at a time
ROUTES = {"gmin_scan": {"direct": 0, "padded": 0},
          "int8_gmin_scan": {"direct": 0, "padded": 0},
          "stage_gmin_scan": {"direct": 0, "padded": 0},
          "sign_scan": {"direct": 0, "padded": 0},
          "rescore": {"direct": 0, "narrow": 0},
          "int8_rescore": {"direct": 0, "narrow": 0}}

#: the group-major rescore's limits: pairs per work item and bytes of one
#: shared-memory ring stage (compiled into csrc/group_rescore.cuh from
#: ``_build.LIMITS``), and the most row slices the plan cuts a group into
RESCORE_MAX_WINDOW = _build.LIMITS["VT_RESCORE_MAX_WINDOW"]
RESCORE_STAGE_BYTES = _build.LIMITS["VT_RESCORE_STAGE_BYTES"]
RESCORE_MAX_SLICES = 16


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


def _rank(dots, xsq, qsq, metric):
    """The shared rank key: -dot for the dot metrics (cosine's 1-dot offset
    is applied at the end), squared distance for l2 / l2_squared."""
    if _is_l2(metric):
        return xsq - 2.0 * dots + qsq
    return -dots


# ---------------------------------------------------------------------------
# K1: matmul + rank + bias + 64-row group-min
# ---------------------------------------------------------------------------


def _bf16_query(q):
    """The query of a scan of bf16 storage: rounded to bf16, so the scan
    sees bf16 x bf16 products (the f32 query still gives qsq). The kernels
    take it as it is, the plain versions widened back to f32."""
    return q.to(torch.bfloat16)


def _scan_query(x, q):
    """The query K1 multiplies with, in f32: ``_bf16_query`` under bf16
    storage, else ``q``."""
    return _bf16_query(q).float() if x.dtype == torch.bfloat16 else q


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


def tf32_split(v):
    """``(hi, lo)`` of an f32 tensor: ``hi`` is ``v`` rounded to TF32 (to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``: its 13 low
    mantissa bits are zero) and ``lo = v - hi``, exact in f32, so ``hi + lo
    == v``. K1's f32 kernel takes the query in these two parts."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, v - hi


def gmin_scan(x, xsq, bias, q, *, metric):
    """Group minima of the rank matrix: ``([B, N/64] f32, bounded)``.

    ``x`` [N, d] f32 or bf16, ``xsq`` / ``bias`` [N] f32, ``q`` [B, d] f32.
    Under bf16 storage the query is rounded to bf16 for the scan (the
    matmul sees bf16 x bf16 products); ``qsq`` always comes from the f32
    query. ``bounded`` is False when the batch fails the overflow bound.
    On the card f32 blocks take 3xTF32 products: the group minima stay
    within ``K1_ATOL`` of the plain f32 version's."""
    _check_operands(x, xsq, bias, q)
    qsq = (q * q).sum(dim=1)
    bounded = _bounded(xsq, qsq)
    if x.device.type == "cpu":
        return _gmin_scan_ref(x, xsq, bias, q, metric=metric), bounded
    if not x.is_cuda:
        raise ValueError(f"gmin_scan runs on cuda or cpu tensors, not {x.device}")
    if not all(t.is_contiguous() for t in (x, xsq, bias)):
        raise ValueError("kernel operands must be contiguous")
    n, d = x.shape
    b = q.shape[0]
    q = q.contiguous()
    parts = (_bf16_query(q),) if x.dtype == torch.bfloat16 else tf32_split(q)
    xt, ldx, x_copied = _tma_rows(x)
    qts = [_tma_rows(t) for t in parts]
    gmin = torch.empty((b, n // GROUP), dtype=torch.float32, device=x.device)
    _build.launch("gmin_scan", x.device, xt, ldx, int(x.dtype == torch.bfloat16), xsq, bias,
                  qts[0][0], qts[-1][0], qts[0][1], qsq, gmin, n, d, b, int(_is_l2(metric)))
    _count_route("gmin_scan", x_copied, *(copied for _t, _ld, copied in qts))
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


def _rescore_geometry(p, d, elt, sms):
    """The rescore kernels' work geometry for ``p`` pairs of rows of ``d``
    elements of ``elt`` bytes on a card of ``sms`` SMs: ``(w, rows, rs,
    cols)``. A work item is a window of ``w`` sorted pairs times a slice of
    ``rows`` of a group's 64 rows: ``w`` grows with ``p`` (about two windows
    per SM, at most ``RESCORE_MAX_WINDOW``), and the slices multiply the
    windows until there are eight work items per SM or a slice is 4 rows,
    so small batches still fill the card. A ring stage holds ``rs`` rows of
    ``cols`` columns: the slice's rows, halved until they fit
    ``RESCORE_STAGE_BYTES``; a row wider than a stage is cut into column
    chunks (``rs`` = 1)."""
    w = max(1, min(RESCORE_MAX_WINDOW, p // (2 * sms)))
    windows = -(-p // w)
    slices = 1
    while slices < RESCORE_MAX_SLICES and windows * slices < 8 * sms:
        slices *= 2
    rows = GROUP // slices
    rs = rows
    while rs > 1 and rs * d * elt > RESCORE_STAGE_BYTES:
        rs //= 2
    cols = d if rs * d * elt <= RESCORE_STAGE_BYTES else RESCORE_STAGE_BYTES // elt
    return w, rows, rs, cols


def _rescore_plan(gidx, n, *, d, elt, sms):
    """The rescore kernels' work list for ``gidx`` [B, gsel] over a block of
    ``n`` rows of ``elt`` bytes an element: ``(groups [P] int32, pairs [P]
    int64 or None, geometry)``. For f32 rows the ``P = B * gsel`` pairs are
    ordered by group by a stable sort: ``groups`` in that order and
    ``pairs`` the original pair index ``b * gsel + s`` of each, so that a
    shared group is read once per window. ``pairs`` is None, and the pairs
    stay in their own order, for bf16 and int8 rows, at B = 1 (a query's
    selected groups are distinct) and whenever ``P <= 4 * sms``. Reading a
    shared group once pays only where the row bytes set the kernel's time:
    on an H100 at B = 512 (sharing 1.32; ``tools/scan_timing.py``'s
    ``_unsorted`` times) the sort cut K2 f32's device time
    per call 0.584 → 0.511 ms, but left bf16's at 0.302 → 0.295 and raised
    int8's 0.317 → 0.352, whose kernels are bound by their per (pair, row)
    work; at ``P <= 4 * sms`` every work item is in flight at once and the
    sort's launches cost more than it saves. Group indices outside ``[0,
    n/64)`` are clamped by the kernel, which clamps every index it reads; a
    clamp is monotone, so the sort of the raw indices also orders the
    clamped ones, and the wrapper launches nothing for it. Every size
    follows from the shapes: nothing is read back to the host.
    ``geometry`` is ``_rescore_geometry``'s."""
    b, gsel = gidx.shape
    if elt != 4 or b == 1 or b * gsel <= 4 * sms:
        groups, pairs = gidx.reshape(-1), None
    else:
        groups, pairs = torch.sort(gidx.reshape(-1), stable=True)
    return groups, pairs, _rescore_geometry(b * gsel, d, elt, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _group_rescore(name, lead, x, q, gidx, *, metric):
    """Launches K2 or K4 (``name``; ``lead`` the entry point's leading
    arguments: the rows and their side values) on ``gidx``'s work list, on
    the caller's stream; counts the launch and its route."""
    n, d = x.shape
    b, gsel = gidx.shape
    q = q.contiguous()
    qsq = (q * q).sum(dim=1) if _is_l2(metric) else None  # the dot metrics need no norm
    elt = x.element_size()
    groups, pairs, (w, rows, rs, cols) = _rescore_plan(
        gidx.contiguous(), n, d=d, elt=elt, sms=_sm_count(x.device.index))
    direct = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0 and (d * elt) % 16 == 0
    out = torch.empty((b, gsel, GROUP), dtype=torch.float32, device=x.device)
    _build.launch(name, x.device, *lead, q, qsq, groups, pairs, out, n, d, b * gsel, gsel, w,
                  rows, rs, cols, int(direct), int(_is_l2(metric)))
    LAUNCHES[name] += 1
    ROUTES[name]["direct" if direct else "narrow"] += 1
    return out


def rescore(x, xsq, bias, q, gidx, *, metric):
    """Ranks of every row of the selected groups: ``[B, gsel, 64]`` f32.
    ``gidx`` [B, gsel] int32 group indices (clamped into ``[0, N/64)``)."""
    _check_operands(x, xsq, bias, q)
    b, gsel = gidx.shape
    if b != q.shape[0]:
        raise ValueError(f"gidx has {b} rows for {q.shape[0]} queries")
    if gidx.dtype != torch.int32:
        raise TypeError("gidx must be an int32 tensor")
    if gidx.device != x.device:
        raise ValueError(f"operands on {gidx.device} and {x.device}")
    if x.device.type == "cpu":
        return _rescore_ref(x, xsq, bias, q, gidx.clamp(0, x.shape[0] // GROUP - 1),
                            metric=metric)
    if not x.is_cuda:
        raise ValueError(f"rescore runs on cuda or cpu tensors, not {x.device}")
    for t in (x, xsq, bias):
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    lead = (x, int(x.dtype == torch.bfloat16), xsq, bias)
    return _group_rescore("rescore", lead, x, q, gidx, metric=metric)


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
    gmin, bounded = gmin_scan(x, xsq, bias, q, metric=metric)
    gsel = min(k + GROUP_SLACK, x.shape[0] // GROUP)
    # tie spill check at the K boundary: every group with min <= m_k must be
    # selected (GROUP_SLACK absorbs up to 8 tied groups past it)
    _gtop, gidx, g_ok = select.group_topk(gmin, gsel, check_c=k)
    cand = rescore(x, xsq, bias, q, gidx.int(), metric=metric)
    slot_s, rank_s, tie_ok = _select_winners(cand, gidx, lex_rank, k)
    top_slot, raw, top_rank = _finalize(x, q, slot_s, rank_s, metric=metric)
    return top_slot, raw, top_rank, bounded & g_ok.all() & tie_ok


def _select_winners(cand, gidx, lex_rank, k):
    """The ``k`` best of the rescored groups ``cand`` [B, gsel, 64] in
    (rank, lex id) order: ``(slots [B, k], ranks [B, k], tie_ok)``. The
    ``k + TIE_PAD`` best by rank are sorted by (rank, lex); a rank tie that
    crosses the pad boundary means lex-smaller ids may sit outside the pad,
    which is not provably exact, so ``tie_ok`` (0-dim bool) goes False."""
    b, gsel, _ = cand.shape
    cand = cand.reshape(b, gsel * GROUP)
    cand_slots = _group_rows(gidx).reshape(b, gsel * GROUP)
    sel = min(k + TIE_PAD, gsel * GROUP)
    sel_rank, pos = smallest(cand, sel)
    sel_slots = cand_slots.gather(1, pos)
    sel_lex = torch.where(torch.isfinite(sel_rank), lex_rank[sel_slots].long(),
                          torch.full_like(sel_slots, _BIG32))
    order = lex_sort(sel_rank, sel_lex)
    rank_s = sel_rank.gather(1, order)
    slot_s = sel_slots.gather(1, order)
    tie_ok = ((rank_s[:, k - 1] < sel_rank[:, sel - 1])
              | ~torch.isfinite(sel_rank[:, sel - 1])).all()
    return slot_s[:, :k], rank_s[:, :k], tie_ok


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


# ---------------------------------------------------------------------------
# int8 storage: K3 int8_gmin_scan, K4 int8_rescore, fused_int8_search
# ---------------------------------------------------------------------------

#: widest d-chunk whose int8 dot an f32 GEMM sums exactly: every partial
#: sum is an integer of magnitude <= 1040 * 127**2 < 2**24
_EXACT_I8_CHUNK = 1040


def quantize_rows(x):
    """Per-row symmetric int8 quantization: ``(x8 [N, d] int8, scale [N]
    f32)`` with ``scale = max(max |row|, 1e-30) * f32(1/127)`` and ``x8 =
    clip(round(x / scale), -127, 127)``, rounding half to even. The same
    f32 arithmetic as the JAX package's ``_quantize_int8`` and its query
    quantization in ``fused_int8_search`` (XLA turns their division by the
    constant 127 into a product with its f32 reciprocal), so both give the
    same bits."""
    xf = x.float()
    scale = xf.abs().amax(dim=1).clamp_min(1e-30) * (1.0 / 127.0)
    x8 = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return x8, scale


def int8_dots(q8, x8):
    """``[B, N]`` f32 values of the exact int32 dots ``q8 . x8``. An f32 GEMM
    of widened int8 values is exact per d-chunk of at most 1040 columns
    (also with TF32 inputs, which hold 8-bit integers exactly); wider rows
    sum their chunks in int64. ``torch.matmul`` takes no integer tensors on
    CUDA."""
    d = x8.shape[1]
    if d <= _EXACT_I8_CHUNK:
        return q8.float() @ x8.float().T
    acc = 0
    for s in range(0, d, _EXACT_I8_CHUNK):
        part = q8[:, s:s + _EXACT_I8_CHUNK].float() @ x8[:, s:s + _EXACT_I8_CHUNK].float().T
        acc = acc + part.to(torch.int64)
    return acc.float()


def _check_int8_operands(x8, scale, xsq, bias, q, q_dtype):
    n, d = x8.shape
    if x8.dtype != torch.int8:
        raise TypeError(f"x8 must be int8, got {x8.dtype}")
    if n % GROUP:
        raise ValueError(f"row count {n} is not a multiple of {GROUP}")
    if q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"queries {tuple(q.shape)} do not have {d} columns")
    if q.dtype != q_dtype:
        raise TypeError(f"queries must be {q_dtype}, got {q.dtype}")
    for name, t in (("scale", scale), ("xsq", xsq), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be float32 of shape {(n,)}")
    for t in (scale, xsq, bias, q):
        if t.device != x8.device:
            raise ValueError(f"operands on {t.device} and {x8.device}")


def _tma_rows(t, cols=None):
    """``t`` [rows, d] (contiguous, any element size) as TMA can read its
    first ``cols`` columns (all by default): ``(rows, row stride in bytes,
    copied)``. TMA needs a 16-byte aligned base and a row stride that is a
    multiple of 16 bytes; any other block (a row of bytes off 16, a view at
    an odd offset) has its first ``cols`` columns copied into a zero-padded
    block with the next such stride. The kernel reads only the first
    ``cols`` elements of each row. A tensor that is not contiguous raises:
    its row stride is not ``d`` elements."""
    if not t.is_contiguous():
        raise ValueError("kernel operands must be contiguous")
    d, size = t.shape[1], t.element_size()
    cols = d if cols is None else cols
    if (d * size) % 16 == 0 and t.data_ptr() % 16 == 0:
        return t, d * size, False
    ld = -(-cols * size // 16) * 16 // size
    padded = t.new_zeros((t.shape[0], ld))
    padded[:, :cols] = t[:, :cols]
    return padded, ld * size, True


def _count_route(name, *copied):
    LAUNCHES[name] += 1
    ROUTES[name]["padded" if any(copied) else "direct"] += 1


def _int8_bounded(scale, xsq, qscale, qsq, d):
    """Overflow proof of the int8 scan: ``|approx| <= d * 127**2 * scale *
    qscale`` exactly, so every rank is finite when that product and the
    norm terms sit under the per-term cap. 0-dim bool tensor. The constant
    enters as a Python scalar: a tensor made from it on the card would be a
    host-to-device copy, which waits for the stream."""
    amax = scale.max() * float(d * 127 * 127) * qscale.abs().max()
    return ((amax < _SAFE_LIM) & (xsq.max() < _SAFE_LIM) & (qsq < _SAFE_LIM)).all()


def _int8_gmin_scan_ref(x8, scale, xsq, bias, q8, qscale, qsq, *, metric):
    """Plain PyTorch version of K3: ``[B, N/64]`` group minima of
    ``rank((q8 . x8) * scale * qscale) + bias``, in the JAX body's order of
    f32 operations (``flat_scan.py::_int8_gmin_body``)."""
    n = x8.shape[0]
    b = q8.shape[0]
    approx = int8_dots(q8, x8) * scale[None, :] * qscale[:, None]
    rank = _rank(approx, xsq[None, :], qsq[:, None], metric) + bias[None, :]
    return rank.reshape(b, n // GROUP, GROUP).amin(dim=-1)


def int8_gmin_scan(x8, scale, xsq, bias, q8, qscale, qsq, *, metric):
    """Group minima of the quantized rank matrix: ``([B, N/64] f32,
    bounded)``.

    ``x8`` [N, d] int8 with dequant ``scale`` [N] f32, ``xsq`` [N] f32 TRUE
    squared norms (the l2 expansion keeps them; only the cross term is
    quantized), ``bias`` [N] f32, ``q8`` [B, d] int8 with ``qscale`` [B]
    and ``qsq`` [B] f32 (from the f32 queries). The int32 dot is exact, so
    the kernel and its plain version agree bit for bit."""
    _check_int8_operands(x8, scale, xsq, bias, q8, torch.int8)
    b, d = q8.shape
    for name, t in (("qscale", qscale), ("qsq", qsq)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b,):
            raise TypeError(f"{name} must be float32 of shape {(b,)}")
        if t.device != x8.device:
            raise ValueError(f"operands on {t.device} and {x8.device}")
    bounded = _int8_bounded(scale, xsq, qscale, qsq, d)
    if x8.device.type == "cpu":
        return _int8_gmin_scan_ref(x8, scale, xsq, bias, q8, qscale, qsq,
                                   metric=metric), bounded
    if not x8.is_cuda:
        raise ValueError(f"int8_gmin_scan runs on cuda or cpu tensors, not {x8.device}")
    if not all(t.is_contiguous() for t in (x8, scale, xsq, bias, q8, qscale, qsq)):
        raise ValueError("kernel operands must be contiguous")
    n = x8.shape[0]
    xt, ldx, x_copied = _tma_rows(x8)
    qt, ldq, q_copied = _tma_rows(q8)
    gmin = torch.empty((b, n // GROUP), dtype=torch.float32, device=x8.device)
    _build.launch("int8_gmin_scan", x8.device, xt, ldx, scale, xsq, bias, qt, ldq, qscale, qsq,
                  gmin, n, d, b, int(_is_l2(metric)))
    _count_route("int8_gmin_scan", x_copied, q_copied)
    return gmin, bounded


def _int8_rescore_ref(x8, scale, xsq, bias, q, gidx, *, metric):
    """Plain PyTorch version of K4: ``[B, gsel, 64]`` ranks of the selected
    groups' rows, ``(sum_d f32(x8) * q) * scale`` against the full f32 query
    (sum first, then the scale, as ``_int8_rescore_body``); non-finite
    ranks become +inf."""
    no_tf32(q)
    rows = _group_rows(gidx)
    dots = torch.einsum("bgrd,bd->bgr", x8[rows].float(), q) * scale[rows]
    rank = _rank(dots, xsq[rows], (q * q).sum(dim=1)[:, None, None], metric) + bias[rows]
    return torch.where(torch.isfinite(rank), rank, torch.full_like(rank, float("inf")))


def int8_rescore(x8, scale, xsq, bias, q, gidx, *, metric):
    """Ranks of every row of the selected groups of an int8 block: ``[B,
    gsel, 64]`` f32. ``q`` [B, d] f32 (the unquantized queries), ``gidx``
    [B, gsel] int32 group indices (clamped into ``[0, N/64)``)."""
    _check_int8_operands(x8, scale, xsq, bias, q, torch.float32)
    b, gsel = gidx.shape
    if b != q.shape[0]:
        raise ValueError(f"gidx has {b} rows for {q.shape[0]} queries")
    if gidx.dtype != torch.int32:
        raise TypeError("gidx must be an int32 tensor")
    if gidx.device != x8.device:
        raise ValueError(f"operands on {gidx.device} and {x8.device}")
    if x8.device.type == "cpu":
        return _int8_rescore_ref(x8, scale, xsq, bias, q,
                                 gidx.clamp(0, x8.shape[0] // GROUP - 1), metric=metric)
    if not x8.is_cuda:
        raise ValueError(f"int8_rescore runs on cuda or cpu tensors, not {x8.device}")
    if not all(t.is_contiguous() for t in (x8, scale, xsq, bias)):
        raise ValueError("kernel operands must be contiguous")
    lead = (x8, scale, xsq, bias)
    return _group_rescore("int8_rescore", lead, x8, q, gidx, metric=metric)


def fused_int8_search(x8, scale, xsq, bias, lex_rank, q, *, metric, k):
    """Batched top-k over an int8-quantized block.

    ``x8`` [N, d] int8 (per-row symmetric quantization, ``quantize_rows``),
    ``scale`` [N] f32 dequant factors, ``xsq`` [N] f32 TRUE squared norms,
    ``bias`` / ``lex_rank`` / ``q`` as ``fused_flat_search``. Selection
    ranks are the quantized metric (the query is quantized too, so the
    candidates are approximate); the returned raw values come from the
    dequantized rows in full f32. Returns ``(slots, raws, ranks, ok)`` as
    ``fused_flat_search``; ``ok`` False = a tie spill past the slack, or
    dequant scales so extreme the quantized rank could overflow f32 (host
    oracle)."""
    n = x8.shape[0]
    qf = q.float()
    q8, qscale = quantize_rows(qf)
    qsq = (qf * qf).sum(dim=1)
    gmin, bounded = int8_gmin_scan(x8, scale, xsq, bias, q8, qscale, qsq, metric=metric)
    gsel = min(k + GROUP_SLACK, n // GROUP)
    _gtop, gidx, g_ok = select.group_topk(gmin, gsel, check_c=k)
    cand = int8_rescore(x8, scale, xsq, bias, qf, gidx.int(), metric=metric)
    top_slot, top_rank, tie_ok = _select_winners(cand, gidx, lex_rank, k)
    # dequantized winners in full f32 (raw quality = the int8 storage noise)
    rows = x8[top_slot].float() * scale[top_slot][:, :, None]
    if _is_l2(metric):
        diff = rows - qf[:, None, :]
        sq = (diff * diff).sum(dim=-1)
        raw = sq.sqrt() if metric == "l2" else sq
        top_rank = torch.where(torch.isfinite(top_rank), raw, torch.full_like(raw, float("inf")))
    else:
        no_tf32(rows)
        rdots = torch.einsum("bkd,bd->bk", rows, qf)
        raw = -rdots if metric == "negative_inner_product" else rdots
        if metric == "cosine":
            top_rank = torch.where(torch.isfinite(top_rank), 1.0 - raw,
                                   torch.full_like(raw, float("inf")))
    return top_slot, raw, top_rank, bounded & g_ok.all() & tie_ok


# ---------------------------------------------------------------------------
# K5: fused stage candidates (funnel stage 1) — prefix matmul + true stage
# metric + group-min AND the [B, N] rank matrix, one pass
# ---------------------------------------------------------------------------

#: largest candidate count the fused stage path serves
MAX_FUSED_C = 512


def supports_candidates(metric: str, cap: int, dims: int, count: int) -> bool:
    """Whether the fused prefix-candidate scan handles this configuration.
    K5 reads any prefix width (the JAX package's ``dims % 128`` lane-tile
    gate has no counterpart on the card)."""
    return metric in FUSED_METRICS and cap % GROUP == 0 and 0 < count <= MAX_FUSED_C


def _stage_rank(dots, xsq, qsq, *, metric):
    """True stage-metric rank from prefix dots — the same formulas as
    ``pipeline._rank_full`` (true cosine at every width, search.rs:56-58).
    ``dots`` [B, N], ``xsq`` [1, N], ``qsq`` [B, 1]."""
    if metric == "cosine":
        denom = xsq.sqrt() * qsq.sqrt()
        sim = torch.where(denom > 0.0, dots / denom, 0.0)
        return 1.0 - sim.clamp(-1.0, 1.0)
    if metric == "inner_product":
        return -dots
    if metric == "negative_inner_product":
        return dots
    sq = (xsq - 2.0 * dots + qsq).clamp_min(0.0)
    return sq.sqrt() if metric == "l2" else sq


def _stage_gmin_scan_ref(x, xsq, bias, q, *, metric, dims):
    """Plain PyTorch version of K5: ``(gmin [B, N/64], rank [B, N])`` of
    ``stage_rank(x[:, :dims] . q[:, :dims]) + bias``. Under bf16 storage the
    query prefix is rounded to bf16 (bf16 x bf16 products, exact in f32);
    ``qsq`` always comes from the f32 prefix."""
    no_tf32(x)
    n = x.shape[0]
    b = q.shape[0]
    qp = q[:, :dims].float()
    dots = _scan_query(x, qp) @ x[:, :dims].float().T  # [B, N]
    rank = _stage_rank(dots, xsq[None, :], (qp * qp).sum(dim=1)[:, None],
                       metric=metric) + bias[None, :]
    return rank.reshape(b, n // GROUP, GROUP).amin(dim=-1), rank


def stage_gmin_scan(x, xsq, bias, q, *, metric, dims):
    """Group minima AND the full rank matrix of the true prefix metric:
    ``(gmin [B, N/64] f32, rank [B, N] f32, bounded)``.

    ``x`` [N, d] f32 or bf16 (only its first ``dims`` columns are read, with
    row stride d — no prefix copy), ``xsq`` [N] f32 PREFIX squared norms,
    ``bias`` [N] f32 (0 valid / +inf invalid), ``q`` [B, d] f32. ``bounded``
    is the Cauchy-Schwarz overflow proof of ``gmin_scan`` over the prefix.
    On the card K5 runs K1's tensor-core policies: f32 blocks take 3xTF32
    products of the split query prefix (within ``K5_ATOL`` of the plain f32
    version), bf16 blocks bf16 products. A block whose row stride TMA cannot
    address has its prefix copied first (``ROUTES["stage_gmin_scan"]``)."""
    _check_operands(x, xsq, bias, q)
    if metric not in FUSED_METRICS:
        raise ValueError(f"stage_gmin_scan has no metric {metric!r}")
    if not 0 < dims <= x.shape[1]:
        raise ValueError(f"dims {dims} is not in [1, {x.shape[1]}]")
    qp = q[:, :dims].float()
    qsq = (qp * qp).sum(dim=1)
    bounded = _bounded(xsq, qsq)
    if x.device.type == "cpu":
        gmin, rank = _stage_gmin_scan_ref(x, xsq, bias, q, metric=metric, dims=dims)
        return gmin, rank, bounded
    if not x.is_cuda:
        raise ValueError(f"stage_gmin_scan runs on cuda or cpu tensors, not {x.device}")
    if not all(t.is_contiguous() for t in (xsq, bias)):
        raise ValueError("kernel operands must be contiguous")
    n = x.shape[0]
    b = q.shape[0]
    qp = qp.contiguous()
    parts = (_bf16_query(qp),) if x.dtype == torch.bfloat16 else tf32_split(qp)
    xt, ldx, x_copied = _tma_rows(x, dims)
    qts = [_tma_rows(t) for t in parts]
    gmin = torch.empty((b, n // GROUP), dtype=torch.float32, device=x.device)
    rank = torch.empty((b, n), dtype=torch.float32, device=x.device)
    _build.launch("stage_gmin_scan", x.device, xt, ldx, int(x.dtype == torch.bfloat16), xsq,
                  bias, qts[0][0], qts[-1][0], qts[0][1], qsq, gmin, rank, n, dims, b,
                  FUSED_METRICS.index(metric))
    _count_route("stage_gmin_scan", x_copied, *(copied for _t, _ld, copied in qts))
    return gmin, rank, bounded


def fused_stage_candidates(x, xsq, bias, q, *, metric, count, dims):
    """Exact top-``count`` candidate slots by the true prefix metric.

    ``x`` [N, d] f32 or bf16 (lex-sorted cache block; bf16 selects at
    storage precision), ``xsq`` [N] f32 PREFIX squared norms (over the first
    ``dims`` columns), ``bias`` [N] f32 (0 valid / +inf invalid), ``q``
    [B, d] f32. Returns ``(slots [B, count] int64 best-first by (rank,
    slot), ranks [B, count] f32, ok [B])``; ok False = overflow or a tie
    spill past the slack (host fallback).

    Order-statistic exactness as ``fused_flat_search``: the ``count``
    smallest group-mins are ``count`` distinct elements, so any group whose
    min exceeds the count-th smallest group-min holds no top-count element
    (spill past GROUP_SLACK flags ok False). The covered groups' elements
    are gathered (K7) from K5's own rank output."""
    n = x.shape[0]
    b = q.shape[0]
    gmin, rank, bounded = stage_gmin_scan(x, xsq.reshape(-1), bias.reshape(-1), q,
                                          metric=metric, dims=dims)
    ng = n // GROUP
    gsel = min(count + GROUP_SLACK, ng)
    _gtop, gidx, spill_ok = select.group_topk(gmin, gsel, check_c=count)
    # group_topk may return clamped +inf-pad indices when a row has fewer
    # than gsel finite groups; those rows flag spill_ok False
    gidx = gidx.clamp_max(ng - 1)
    cand = extract_group_rows(rank.view(b, ng, GROUP), gidx.int()).reshape(b, gsel * GROUP)
    cand_slots = _group_rows(gidx).reshape(b, gsel * GROUP)
    slots, ranks, sel_ok = select.exact_top_c_slots(cand, cand_slots, c=count)
    return slots, ranks, bounded & spill_ok & sel_ok


# ---------------------------------------------------------------------------
# K6: fused sign scan (quantized stage 1) — ±1 int8 dot + Hamming +
# group-min + the [B, N] int16 Hamming matrix, one pass
# ---------------------------------------------------------------------------

#: int16 Hamming of invalid rows (any real value is <= d < 16384)
_BIG16 = 32767


def supports_sign_scan(cap: int, d: int) -> bool:
    """Whether the fused sign scan serves this block. K6 takes any ``d`` in
    the int16 Hamming range (the JAX package's ``d % 128`` lane-tile gate
    has no counterpart on the card)."""
    return cap % GROUP == 0 and 0 < d < _BIG16 // 2


def _check_sign_operands(signs, valid8, qsigns, d):
    n = signs.shape[0]
    if signs.dim() != 2 or signs.shape[1] != d or qsigns.dim() != 2 or qsigns.shape[1] != d:
        raise ValueError(f"signs {tuple(signs.shape)} and qsigns {tuple(qsigns.shape)} "
                         f"must both have {d} columns")
    if n % GROUP:
        raise ValueError(f"row count {n} is not a multiple of {GROUP}")
    if not 0 < d < _BIG16 // 2:
        raise ValueError(f"d {d} is outside the int16 Hamming range")
    for name, t in (("signs", signs), ("valid8", valid8), ("qsigns", qsigns)):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} must be int8, got {t.dtype}")
        if t.device != signs.device:
            raise ValueError(f"operands on {t.device} and {signs.device}")
    if tuple(valid8.shape) != (n,):
        raise ValueError(f"valid8 has shape {tuple(valid8.shape)}, expected {(n,)}")


def sign_dots(qsigns, signs):
    """``[B, N]`` int32 dot products of ±1 int8 sign rows. The matmul runs in
    f32, which is exact here: every product is ±1 and every partial sum an
    integer of magnitude <= d < 2**24 (so TF32 inputs would be exact too)."""
    return torch.round(qsigns.float() @ signs.float().T).to(torch.int32)


def _fused_sign_scan_ref(signs, valid8, qsigns, *, d):
    """Plain PyTorch version of K6: ``(gmin [B, N/64] int32, ham16 [B, N]
    int16)`` with ham = (d - s.q) >> 1 and invalid rows at ``_BIG16``."""
    n = signs.shape[0]
    b = qsigns.shape[0]
    ham = (d - sign_dots(qsigns, signs)) >> 1
    ham = torch.where(valid8[None, :] != 0, ham, _BIG16)
    return ham.reshape(b, n // GROUP, GROUP).amin(dim=-1), ham.to(torch.int16)


def fused_sign_scan(signs, valid8, qsigns, *, d):
    """One pass over the ±1 int8 block ``signs`` [N, d] against the query
    signs ``qsigns`` [B, d]: ``(gmin [B, N/64] int32, ham16 [B, N] int16)``
    — hamming = (d - s·q)/2 exactly (the packed XOR+popcount value,
    distances.rs:426-437), rows with ``valid8 == 0`` pinned to ``_BIG16``."""
    _check_sign_operands(signs, valid8, qsigns, d)
    if signs.device.type == "cpu":
        return _fused_sign_scan_ref(signs, valid8, qsigns, d=d)
    if not signs.is_cuda:
        raise ValueError(f"fused_sign_scan runs on cuda or cpu tensors, not {signs.device}")
    for t in (signs, valid8, qsigns):
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    n = signs.shape[0]
    b = qsigns.shape[0]
    st, lds, s_copied = _tma_rows(signs)
    qt, ldq, q_copied = _tma_rows(qsigns)
    gmin = torch.empty((b, n // GROUP), dtype=torch.int32, device=signs.device)
    ham16 = torch.empty((b, n), dtype=torch.int16, device=signs.device)
    _build.launch("sign_scan", signs.device, st, lds, valid8, qt, ldq, gmin, ham16, n, d, b)
    _count_route("sign_scan", s_copied, q_copied)
    return gmin, ham16


# ---------------------------------------------------------------------------
# K7: covered-row extraction — out[b, c] = mat[b, gidx[b, c]]
# ---------------------------------------------------------------------------


def _extract_group_rows_ref(mat, gidx):
    """Plain PyTorch version of K7 (indices clamped into ``[0, R)``, as the
    kernel clamps them)."""
    b, rows, lanes = mat.shape
    idx = gidx.long().clamp(0, rows - 1)
    return mat.gather(1, idx[:, :, None].expand(b, idx.shape[1], lanes))


def extract_group_rows(mat, gidx):
    """``mat`` [B, R, L] f32 or int16, ``gidx`` [B, C] int32 row ids in
    ``[0, R)``. Returns ``[B, C, L]`` with ``out[b, c] = mat[b, gidx[b, c]]``.
    Callers pre-clamp pad indices (selection masks their values afterwards);
    an index outside ``[0, R)`` is clamped, never read out of range.

    The JAX package gathers 64-wide group rows as HALF rows of a 128-lane
    view (``half=True``) because Mosaic loads whole 128-lane rows; here the
    64-wide rows of the ``[B, N/64, 64]`` view are gathered directly.

    On an H100 the kernel takes ~0.003 ms at B = 1-16 and 0.02-0.03 ms at
    B = 512, so this wrapper's host work is most of a call: it checks each
    operand once."""
    if mat.dim() != 3 or gidx.dim() != 2 or gidx.shape[0] != mat.shape[0]:
        raise ValueError(f"mat {tuple(mat.shape)} and gidx {tuple(gidx.shape)} do not pair")
    if mat.dtype not in (torch.float32, torch.int16):
        raise TypeError(f"mat must be float32 or int16, got {mat.dtype}")
    if gidx.dtype != torch.int32:
        raise TypeError("gidx must be an int32 tensor")
    if gidx.device != mat.device:
        raise ValueError(f"operands on {gidx.device} and {mat.device}")
    if not mat.is_cuda:
        if mat.device.type == "cpu":
            return _extract_group_rows_ref(mat, gidx)
        raise ValueError(f"extract_group_rows runs on cuda or cpu tensors, not {mat.device}")
    b, rows, lanes = mat.shape
    row_bytes = lanes * mat.element_size()
    if not mat.is_contiguous() or mat.data_ptr() % 16 or row_bytes % 16:
        raise ValueError("mat must be contiguous and 16-byte aligned, with rows of a "
                         "multiple of 16 bytes")
    gidx = gidx.contiguous()
    c = gidx.shape[1]
    out = torch.empty((b, c, lanes), dtype=mat.dtype, device=mat.device)
    _build.launch("extract_group_rows", mat.device, mat, gidx, out, b, rows, c, row_bytes)
    LAUNCHES["extract_group_rows"] += 1
    return out
