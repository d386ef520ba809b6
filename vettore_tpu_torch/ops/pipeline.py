"""Batched adaptive search pipelines: the Matryoshka funnel and binary
quantization.

The port of ``vettore_tpu/ops/pipeline.py``. The reference's funnel /
quantized / hybrid modes chain batched scans with candidate lists flowing
through Elixir (collection.ex:558-713); here the candidates never leave the
device:

* **batch-first**: every stage works on the whole ``[B, N]`` problem;
* **candidate selection via ops/select** — recursive group-min descent,
  exact with (rank, id) ties;
* **stage 1 on hand-written kernels** at scale: the funnel's prefix scan is
  K5 (``flat_scan.fused_stage_candidates``: prefix matmul, true stage
  metric, group minima and the rank matrix in one pass) and the quantized
  Hamming scan is K6 (``flat_scan.fused_sign_scan``); K7 gathers the
  covered 64-row groups out of their ``[B, N]`` matrices. Hamming on ±1
  int8 signs is ``(d - s·q) / 2`` — bit-identical to XOR+popcount over the
  packed words (distances.rs:426-437).

Invariant: the caller's block is LEX-SORTED — slot order equals id order
(``_VectorCache`` stores records sorted by id, invalid/pad slots last), so
slot order is the (rank, id) tie-break key (search.rs:23-29).

Candidate counts and limits are fixed by the caller; padded positions carry
+inf rank / False validity. Every pipeline returns a per-query ``ok`` flag;
False (overflow or tie spill past the selection slack) sends that query to
the host oracle. Slots are int64 throughout.
"""

from __future__ import annotations

import torch

from ..observability import span
from . import flat_scan
from .distance import no_tf32
from .select import exact_top_c, exact_top_c_unique_int
from .topk import lex_sort

_BIG32 = 2**31 - 1

#: slots per group in the group-cover Hamming selection
_GROUP = 64
#: int16 pad for invalid rows' Hamming (any real value is <= d < 16384)
_BIG16 = 32767
#: below this many rows the direct full-width composite pass is used. On an
#: NVIDIA H100 80GB HBM3 at 700 W, d = 768 and 500 candidates
#: (tools/sign_cover_crossover.py, three runs), the K6 group cover wins at a
#: batch of 512 from 65,536 rows in every run (at 32,768 in two of three);
#: at batches of 1-16 both routes take 1-2 ms, bound by launches, and the
#: cover wins from 262k-524k rows.
_GROUP_COVER_MIN = 65536
#: below this many rows the plain stage 1 (materialized [B, N] rank matrix)
#: is used instead of the fused K5 scan. On an H100 at d = 768 and a batch of
#: 512, K5's route overtakes the plain one between 8k and 16k rows.
_FUSED_STAGE_MIN = 16384

_DOT_METRICS = ("cosine", "inner_product", "negative_inner_product")


def _composite_bits(n: int, d: int):
    """Slot-bit width for distinct (hamming << slot_bits) | slot composite
    int32 keys, or None when the address space doesn't fit 31 bits (then the
    float path with tie-spill detection applies)."""
    slot_bits = max(1, (n - 1).bit_length())
    if d.bit_length() + slot_bits <= 31:
        return slot_bits
    return None


# ---------------------------------------------------------------------------
# scoring stages
# ---------------------------------------------------------------------------


def _rank_full(x, valid, queries, *, metric, dims):
    """Rank distances of every row vs every query over the first ``dims``
    columns: [B, N] ascending-is-better, +inf on invalid rows. Returns
    (rank, finite [B]). Cosine renormalizes over the prefix (search.rs:56-58
    scores prefixes with the true cosine)."""
    sub = x[:, :dims].float()
    q = queries[:, :dims].float()
    no_tf32(sub)
    if metric in _DOT_METRICS:
        dots = q @ sub.T  # [B, N]
        if metric == "cosine":
            xn = (sub * sub).sum(dim=1).sqrt()
            qn = (q * q).sum(dim=1).sqrt()
            denom = qn[:, None] * xn[None, :]
            sim = torch.where(denom > 0.0, dots / denom, 0.0)
            rank = 1.0 - sim.clamp(-1.0, 1.0)
        elif metric == "inner_product":
            rank = -dots
        else:
            rank = dots  # negative_inner_product: raw = -dot, rank = raw
    elif metric in ("l2", "l2_squared"):
        xsq = (sub * sub).sum(dim=1)
        qsq = (q * q).sum(dim=1)
        sq = (xsq[None, :] - 2.0 * (q @ sub.T) + qsq[:, None]).clamp_min(0.0)
        rank = sq.sqrt() if metric == "l2" else sq
    else:
        raise ValueError(f"unsupported pipeline metric {metric}")
    finite = (torch.isfinite(rank) | ~valid[None, :]).all(dim=1)
    return torch.where(valid[None, :], rank, float("inf")), finite


def _subset_raw_rank(x, slots, slot_ok, queries, *, metric, dims):
    """Raw + rank for per-query candidate subsets. ``slots`` [B, C] (−1/pad
    allowed where ``slot_ok`` False). Returns (raw [B, C], rank [B, C],
    finite [B])."""
    rows = x[slots.clamp_min(0), :dims].float()  # [B, C, dims]
    q = queries[:, :dims].float()
    if metric in _DOT_METRICS:
        no_tf32(rows)  # the einsum is a batched matmul on the card
        dots = torch.einsum("bcd,bd->bc", rows, q)
        if metric == "cosine":
            # true cosine at every width — the adaptive pipelines mirror
            # vector_top_k, which scores with distances::cosine even at full
            # dims (search.rs:56-58), unlike the flat index's plain dot
            xn = (rows * rows).sum(dim=2).sqrt()
            qn = (q * q).sum(dim=1).sqrt()
            denom = qn[:, None] * xn
            raw = torch.where(denom > 0.0, dots / denom, 0.0).clamp(-1.0, 1.0)
            rank = 1.0 - raw
        elif metric == "inner_product":
            raw = dots
            rank = -dots
        else:
            raw = -dots
            rank = raw
    elif metric in ("l2", "l2_squared"):
        diff = rows - q[:, None, :]
        sq = (diff * diff).sum(dim=2)
        raw = sq.sqrt() if metric == "l2" else sq
        rank = raw
    else:
        raise ValueError(f"unsupported pipeline metric {metric}")
    finite = (torch.isfinite(raw) | ~slot_ok).all(dim=1)
    rank = torch.where(slot_ok, rank, float("inf"))
    return raw, rank, finite


def _top_limit(slots, raw, rank, *, limit):
    """Final (rank, slot==lex) selection over a small candidate axis.
    Returns (top_slots [B, limit], raws, ranks) best-first."""
    key_slot = torch.where(torch.isfinite(rank), slots, _BIG32)
    order = lex_sort(rank, key_slot)[:, :limit]
    return slots.gather(1, order), raw.gather(1, order), rank.gather(1, order)


def _sort_candidates(slots):
    """Candidate sets stay lex-sorted (ascending slot) between stages; pads
    (-1) move to the end as invalid. Returns (slots, ok)."""
    key = torch.where(slots >= 0, slots, _BIG32)
    key = torch.sort(key, dim=1).values
    ok = key < _BIG32
    return torch.where(ok, key, 0), ok


# ---------------------------------------------------------------------------
# sign-bit expansion + Hamming
# ---------------------------------------------------------------------------


def signs_from_bits(bits, *, d):
    """Expands packed sign words ``bits`` [N, W] into a ±1 int8 block
    [N, d] (bit i%32 of word i//32, the pack_signs_u32 layout).

    ``bits`` holds each uint32 word in an int64 (torch has no shifts for
    uint32). The words are read as their four little-endian bytes, so the
    expansion runs on uint8 with an [N, 32·W] uint8 intermediate."""
    n, w = bits.shape
    if bits.dtype != torch.int64:
        raise TypeError(f"bits must be int64 words, got {bits.dtype}")
    low = bits.contiguous().view(torch.uint8).reshape(n, w, 8)[:, :, :4]  # LE bytes
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    flat = ((low[..., None] >> shifts) & 1).reshape(n, w * 32)[:, :d]
    return (flat.to(torch.int8) * 2 - 1).to(torch.int8)


def query_signs(queries):
    """±1 int8 signs of prepared queries (>= 0 rule, distances.rs:413-423)."""
    return torch.where(queries >= 0.0, 1, -1).to(torch.int8)


def _hamming_rank(signs, valid, qsigns, *, d):
    """[B, N] Hamming distances (f32): ham = (d - s·q) / 2, exactly the
    packed XOR+popcount value; +inf on invalid rows."""
    ham = (d - flat_scan.sign_dots(qsigns, signs)) // 2
    return torch.where(valid[None, :], ham.float(), float("inf"))


def _hamming_slots(signs, valid, qsigns, *, count, d):
    """Exact top-``count`` (hamming, slot) candidates per query.

    Hamming values are integers — at 1M rows hundreds of rows tie at the
    count-th value, so a float rank + slack-bounded selection degenerates to
    host fallbacks. Composite int32 keys ``(ham << bits) | index`` are
    DISTINCT per valid row, with ``index`` ordered like the slot: selection
    is unconditionally exact and the low bits implement the (rank, id)
    tie-break (search.rs:23-29; blocks are lex-sorted so slot order is id
    order).

    Large blocks take a two-level GROUP-COVER path: element keys are
    distinct, so at most ``count`` groups can hold any top-``count``
    element, and each such group's min element key is <= the count-th
    element key — selecting the ``count`` smallest ``(group_min_ham,
    group_index)`` composites provably covers all top-``count`` elements.
    K6 writes the int16 Hamming matrix and its [B, N/64] group minima in one
    pass, and K7 gathers the <= count covered groups. The covered groups are
    gathered in ascending group order, so an element's position in the
    gathered ``[B, count * 64]`` sub-block orders like its slot: the key's
    low bits are that position (``(count * 64 - 1).bit_length()`` bits, 15
    at 500 candidates), not the slot, and fit 31 bits where a global slot
    would not (1M rows at d >= 2048: 12 + 20 bits).

    Returns ``(slots [B, count] int64 ascending-by-(ham, slot),
    ranks [B, count] f32 hamming (+inf pads), ok [B])``."""
    n = signs.shape[0]
    b = qsigns.shape[0]
    dev = signs.device
    ng = n // _GROUP
    gbits = max(1, (ng - 1).bit_length()) if ng else 0
    pos_bits = max(1, (count * _GROUP - 1).bit_length())
    if (
        n >= _GROUP_COVER_MIN
        and flat_scan.supports_sign_scan(n, d)
        and (d + 1).bit_length() + gbits <= 31
        and d.bit_length() + pos_bits <= 31
        and ng > count
    ):
        gmin, ham16 = flat_scan.fused_sign_scan(signs, valid.to(torch.int8), qsigns, d=d)
        # all-pad groups clamp to d + 1: still past every real hamming
        # (<= d) but shift-safe under the (d + 1)-bit guard above
        gmin = gmin.clamp_max(d + 1)  # [B, NG]
        gcomp = (gmin << gbits) | torch.arange(ng, dtype=torch.int32, device=dev)[None, :]
        gslots, _gkeys = exact_top_c_unique_int(gcomp, c=count)
        # ascending group order (pads, if any, last), so that a position in
        # the gathered sub-block orders like its slot
        gsorted, gok = _sort_candidates(gslots)
        sub = flat_scan.extract_group_rows(ham16.view(b, ng, _GROUP), gsorted.int())  # [B, C, 64]
        place = torch.arange(count * _GROUP, dtype=torch.int32, device=dev).view(count, _GROUP)
        comp = torch.where(
            (sub < _BIG16) & gok[:, :, None],
            (sub.int() << pos_bits) | place[None],
            _BIG32,
        ).reshape(b, count * _GROUP)
        pos, keys = exact_top_c_unique_int(comp, c=count)
        p = pos.clamp_min(0)
        slots = torch.where(pos >= 0, gsorted.gather(1, p // _GROUP) * _GROUP + p % _GROUP, -1)
        key_bits = pos_bits
    else:
        # below _GROUP_COVER_MIN rows a global slot takes at most 16 bits,
        # so the composite fits for any d below 2**15; a block past the
        # cover's guards whose composite does not fit keeps the float path
        slot_bits = _composite_bits(n, d)
        if slot_bits is None:
            rank_h = _hamming_rank(signs, valid, qsigns, d=d)
            return exact_top_c(rank_h, None, c=count)
        ham = (d - flat_scan.sign_dots(qsigns, signs)) >> 1
        comp = (ham << slot_bits) | torch.arange(n, dtype=torch.int32, device=dev)[None, :]
        comp = torch.where(valid[None, :], comp, _BIG32)
        slots, keys = exact_top_c_unique_int(comp, c=count)
        key_bits = slot_bits
    ranks = torch.where(keys < _BIG32, (keys >> key_bits).float(), float("inf"))
    return slots, ranks, torch.ones(b, dtype=torch.bool, device=dev)


# ---------------------------------------------------------------------------
# pipelines (batched; single-query wrappers at the bottom)
# ---------------------------------------------------------------------------


def _stage1_candidates(x, valid, queries, stage_xsq, *, metric, dims, count):
    """Stage-1 candidate selection: the fused K5 prefix scan + K7 group
    cover when the caller supplied prefix norms and the config qualifies;
    the plain formulation (materialized [B, N] rank matrix) otherwise.
    Returns (slots [B, count] best-first, ranks [B, count] (+inf pads),
    ok [B])."""
    n = x.shape[0]
    if (
        stage_xsq is not None
        and n >= _FUSED_STAGE_MIN
        and flat_scan.supports_candidates(metric, n, dims, count)
    ):
        bias = torch.where(valid, 0.0, float("inf")).float()
        return flat_scan.fused_stage_candidates(
            x, stage_xsq, bias, queries, metric=metric, count=count, dims=dims)
    rank, finite = _rank_full(x, valid, queries, metric=metric, dims=dims)
    slots, ranks, sel_ok = exact_top_c(rank, None, c=count)
    return slots, ranks, finite & sel_ok


def _funnel_stages(x, valid, queries, stage_xsq, *, metric, stages, count):
    """Stage 1 and the narrowing stages: (slots, slot_ok, ok)."""
    slots, _ranks, ok = _stage1_candidates(x, valid, queries, stage_xsq,
                                           metric=metric, dims=stages[0], count=count)
    slots, slot_ok = _sort_candidates(slots)
    for dims in stages[1:]:
        raw, rank_c, f = _subset_raw_rank(x, slots, slot_ok, queries, metric=metric, dims=dims)
        ok = ok & f
        # reference semantics: keep the best `count` per stage (with C ==
        # count this re-orders only; sets shrink when count > survivors)
        sel, _, _ = _top_limit(slots, raw, rank_c, limit=min(count, slots.shape[1]))
        slots, slot_ok = _sort_candidates(sel)
    return slots, slot_ok, ok


def funnel_pipeline_batch(x, valid, queries, stage_xsq=None, *, metric, stages, count, limit):
    """Matryoshka funnel: prefix stages + exact rerank.
    Returns (slots [B, limit], raws, ranks, ok [B])."""
    with span("adaptive.candidates"):
        slots, slot_ok, ok = _funnel_stages(x, valid, queries, stage_xsq,
                                            metric=metric, stages=stages, count=count)
    with span("adaptive.rerank"):
        top, raws, ranks, finite = rerank_batch(x, slots, slot_ok, queries, metric=metric,
                                                limit=limit)
    return top, raws, ranks, ok & finite


def quantized_pipeline_batch(x, signs, valid, queries, *, metric, count, limit, d):
    """Binary-quantized candidates (Hamming) + exact rerank."""
    with span("adaptive.candidates"):
        slots, slot_ok, sel_ok = quantized_candidates_batch(signs, valid, queries, count=count,
                                                            d=d)
    with span("adaptive.rerank"):
        top, raws, ranks, finite = rerank_batch(x, slots, slot_ok, queries, metric=metric,
                                                limit=limit)
    return top, raws, ranks, sel_ok & finite


def funnel_candidates_batch(x, valid, queries, stage_xsq=None, *, metric, stages, count):
    """Funnel stages only (hybrid generator): lex-sorted candidates.
    Returns (slots [B, C], slot_ok [B, C], ok [B])."""
    return _funnel_stages(x, valid, queries, stage_xsq, metric=metric, stages=stages,
                          count=count)


def quantized_candidates_batch(signs, valid, queries, *, count, d):
    """Hamming candidates only (hybrid generator)."""
    qs = query_signs(queries[:, :d])
    slots, _hams, sel_ok = _hamming_slots(signs, valid, qs, count=count, d=d)
    slots, slot_ok = _sort_candidates(slots)
    return slots, slot_ok, sel_ok


def union_candidates(blocks):
    """Unions per-query candidate slot sets from several generators.

    ``blocks`` is a [B, C_total] integer concatenation of generator outputs
    with ``_BIG32`` at invalid/pad positions. Returns lex-sorted
    ``(slots [B, C_total], ok [B, C_total])`` with duplicates and pads masked
    off — the device equivalent of the reference's union-by-id
    (collection.ex:617-629; every rerank re-sorts by (rank, id))."""
    key = torch.sort(blocks, dim=1).values
    dup = torch.cat([torch.zeros_like(key[:, :1], dtype=torch.bool),
                     key[:, 1:] == key[:, :-1]], dim=1)
    ok = (key < _BIG32) & ~dup
    return torch.where(ok, key, 0), ok


def rerank_batch(x, slots, slot_ok, queries, *, metric, limit):
    """Exact full-dims rerank of per-query lex-sorted candidate sets.
    Returns (top_slots [B, limit], raws, ranks, ok [B])."""
    raw, rank_f, finite = _subset_raw_rank(x, slots, slot_ok, queries,
                                           metric=metric, dims=x.shape[1])
    top, raws, ranks = _top_limit(slots, raw, rank_f, limit=limit)
    return top, raws, ranks, finite


# ---------------------------------------------------------------------------
# single-query wrappers (collection single-shot paths)
# ---------------------------------------------------------------------------


def _first(outs):
    return tuple(t[0] for t in outs)


def funnel_pipeline(x, valid, q, stage_xsq=None, *, metric, stages, count, limit):
    return _first(funnel_pipeline_batch(x, valid, q[None, :], stage_xsq, metric=metric,
                                        stages=stages, count=count, limit=limit))


def quantized_pipeline(x, signs, valid, q, *, metric, count, limit, d):
    return _first(quantized_pipeline_batch(x, signs, valid, q[None, :], metric=metric,
                                           count=count, limit=limit, d=d))


def funnel_candidates_pipeline(x, valid, q, stage_xsq=None, *, metric, stages, count):
    return _first(funnel_candidates_batch(x, valid, q[None, :], stage_xsq, metric=metric,
                                          stages=stages, count=count))


def quantized_candidates_pipeline(signs, valid, q, *, count, d):
    return _first(quantized_candidates_batch(signs, valid, q[None, :], count=count, d=d))


def rerank_pipeline(x, slots, slot_ok, q, *, metric, limit):
    return _first(rerank_batch(x, slots[None, :], slot_ok[None, :], q[None, :], metric=metric,
                               limit=limit))
