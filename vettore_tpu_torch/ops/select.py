"""Exact batched selection — recursive group-min descent.

``group_topk`` picks the ``gsel`` smallest group minima of each query row.
For large group counts it descends through 8-wide super-group minima first:
the gsel smallest group-mins occupy at most gsel super-groups, so any
super-group whose min exceeds the gsel-th smallest group-min holds none of
them (the same order-statistic bound as ops/flat_scan.py). Ties deeper than
the slack are reported through ``ok`` (callers fall back to a host oracle).

The top-C selections of the adaptive pipelines (quantized candidates=500,
funnel candidates=200) build on it: ``exact_top_c``, ``exact_top_c_slots``
and ``exact_top_c_unique_int`` select the exact C best slots per query out
of a ``[B, N]`` key matrix by descending through group minima —

* level 1 reduces rows to 64-row group minima and keeps the best
  ``C + slack`` groups. The C smallest group-mins are C distinct elements,
  so the true C-th best key is <= the C-th smallest group-min ``m_C``; a
  group whose min exceeds ``m_C`` cannot hold a top-C element. All groups
  with min <= ``m_C`` fit in the selection unless more than ``slack`` tie at
  exactly ``m_C`` — detected and reported via ``ok``;
* level 2 repeats with 8-row groups over the gathered ~C·64 candidates;
* the final <= ~8·C survivors sort exactly by (key, lex id) with stable
  sorts (``topk.lex_sort``) — the reference's (rank, id) heap order
  (search.rs:23-29).
"""

from __future__ import annotations

import torch

from .topk import lex_sort, smallest

#: extra groups kept per level beyond C (boundary-tie absorption)
SLACK = 8

#: above this many groups the 8-wide super-group descent runs first
_DIRECT_TOPK = 2048

_BIG32 = 2**31 - 1


def _pad_value(dtype: torch.dtype):
    """The +inf pad of ``dtype``: ``+inf`` for floats, the largest value for
    integers (what JAX's cast of ``jnp.inf`` to int32 gives)."""
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def group_topk(gmin: torch.Tensor, gsel: int, check_c=None):
    """Per-row ``gsel`` smallest entries of ``gmin`` [B, ng]
    (ascending-is-better, +inf pad): returns ``(values, idx, ok)`` sorted
    ascending, ``idx`` int64 and ``ok`` [B] bool. ``gmin`` may be float or
    integer (the composite keys of ``exact_top_c_unique_int``).

    ``check_c`` is the CALLER's exactness boundary: ``ok[b]`` asserts that
    every position whose value is <= the ``check_c``-th selected value was
    selected. One global count against the full input suffices — internal
    recursion levels need no checks of their own, because any excluded
    position at or below that boundary would force >= gsel+1 positions at
    or below it (each level keeps ``level_sel + SLACK >= gsel`` covers), and
    the count would fail. Checking at the caller's boundary instead of the
    gsel-th matters in practice: bf16 ranks tie densely, and the k-th
    boundary plus GROUP_SLACK absorbs them. ``check_c=None`` skips the check
    (ok True) — for callers that verify exactness themselves."""
    b, ng = gmin.shape
    if ng % 8 and ng > _DIRECT_TOPK:
        # +inf-pad to the next multiple of 8 so the descent applies. A pad
        # can only be selected when a row has fewer than gsel finite groups;
        # clamping would duplicate a real group in the selection, so such
        # rows flag ok=False (host-oracle fallback) instead.
        gmin = _pad_cols(gmin, ng + (-ng) % 8, _pad_value(gmin.dtype))
        vals, idx, ok = group_topk(gmin, gsel, check_c=check_c)
        ok = ok & (idx < ng).all(dim=1)
        return vals, idx.clamp_max(ng - 1), ok
    if ng % 8 == 0 and ng // 8 > gsel + SLACK and ng > _DIRECT_TOPK:
        sup = gmin.reshape(b, ng // 8, 8)
        smin = sup.amin(dim=2)
        _sv, sidx, _sok = group_topk(smin, min(gsel + SLACK, ng // 8))
        ssel = sidx.shape[1]
        sub = sup.gather(1, sidx[:, :, None].expand(b, ssel, 8)).reshape(b, ssel * 8)
        sub_idx = (sidx[:, :, None] * 8
                   + torch.arange(8, device=gmin.device)[None, None, :]).reshape(b, ssel * 8)
        vals, pos = smallest(sub, gsel)
        idx = sub_idx.gather(1, pos)
    else:
        gsel = min(gsel, ng)
        vals, idx = smallest(gmin, gsel)
    if check_c is None or gsel >= ng:
        return vals, idx, torch.ones(b, dtype=torch.bool, device=gmin.device)
    mc = vals[:, min(check_c, gsel) - 1]
    ok = (gmin <= mc[:, None]).sum(dim=1) <= gsel
    return vals, idx, ok


def _level(key, slots, c, group):
    """One group-min descent level. ``key`` [B, M] ascending-is-better with
    +inf padding, ``slots`` [B, M] global slot per position (-1 pad).
    Returns (key' [B, C'·group], slots', ok) where C' = min(c+SLACK, M/group).
    """
    b, m = key.shape
    ng = m // group
    kg = key.reshape(b, ng, group)
    gsel = min(c + SLACK, ng)
    _gtop, gidx, ok = group_topk(kg.amin(dim=2), gsel, check_c=c)
    take = gidx[:, :, None].expand(b, gsel, group)
    key2 = kg.gather(1, take).reshape(b, gsel * group)
    slots2 = slots.reshape(b, ng, group).gather(1, take).reshape(b, gsel * group)
    return key2, slots2, ok


def _descend(key, slots, c_eff):
    """Group-min descent while a level still shrinks the problem. Returns
    (key, slots, ok [B]) of the survivors."""
    ok = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    while True:
        m = key.shape[1]
        for group in (64, 8):
            shrunk = min(c_eff + SLACK, m // group) * group
            if m % group == 0 and shrunk < m and m // group > c_eff:
                key, slots, lvl_ok = _level(key, slots, c_eff, group)
                ok = ok & lvl_ok
                break
        else:
            return key, slots, ok


def _all_slots(key):
    b, n = key.shape
    return torch.arange(n, device=key.device).expand(b, n)


def _pad_cols(t, width, value):
    """``t`` [B, M] right-padded to ``width`` columns of ``value`` (exact for
    every dtype: ``torch.full`` takes the integer as it is)."""
    fill = torch.full((t.shape[0], width - t.shape[1]), value, dtype=t.dtype, device=t.device)
    return torch.cat([t, fill], dim=1)


def exact_top_c_unique_int(key, *, c: int):
    """Exact batched top-C for DISTINCT int32 keys (``_BIG32`` = invalid).

    Hamming stages tie massively at scale, so the quantized pipeline builds
    composite keys ``(stage_value << slot_bits) | slot``: every valid key is
    distinct, group minima are distinct elements, the order-statistic bound
    is always tight, and the (rank, id) tie-break (search.rs:23-29) is the
    key order itself. Returns ``(slots [B, C] int64, keys [B, C] int32)``
    ascending; surplus positions carry ``_BIG32`` key and slot -1. No ``ok``
    flag: the selection is unconditionally exact.
    """
    n = key.shape[1]
    c_eff = min(c, n)
    cur_key, cur_slots, _ok = _descend(key, _all_slots(key), c_eff)
    key_s, pos = torch.sort(cur_key, dim=1, stable=True)
    out_k = key_s[:, :c_eff]
    out_s = torch.where(out_k < _BIG32, cur_slots.gather(1, pos[:, :c_eff]), -1)
    if c_eff < c:
        out_k = _pad_cols(out_k, c, _BIG32)
        out_s = _pad_cols(out_s, c, -1)
    return out_s, out_k


def _descend_and_sort(key, slots, lex_rank, c, c_eff):
    """Shared tail of the float top-C selections: group-min descent, then
    the exact (key, lex) sort over the survivors. Returns (slots [B, C]
    int64, keys [B, C], ok [B])."""
    cur_key, cur_slots, ok = _descend(key, slots, c_eff)
    # lex_rank None means slot order IS id order (lex-sorted blocks)
    if lex_rank is None:
        lex = cur_slots
    else:
        lex = torch.where(cur_slots >= 0, lex_rank[cur_slots.clamp_min(0)].long(), _BIG32)
    lex = torch.where(torch.isfinite(cur_key), lex, _BIG32)
    order = lex_sort(cur_key, lex)[:, :c_eff]
    out_k = cur_key.gather(1, order)
    out_s = torch.where(torch.isfinite(out_k), cur_slots.gather(1, order).long(), -1)
    if c_eff < c:
        out_k = _pad_cols(out_k, c, float("inf"))
        out_s = _pad_cols(out_s, c, -1)
    return out_s, out_k, ok


def exact_top_c(key, lex_rank, *, c: int):
    """Exact batched top-C: ``key`` [B, N] f32 ascending-is-better (+inf =
    invalid), ``lex_rank`` [N] id ranks or None (slot order is id order).
    Returns ``(slots [B, C] int64, keys [B, C] f32, ok [B] bool)`` ordered
    by (key, lex id); surplus positions carry +inf key and slot -1.
    ``ok[b]`` False = a tie spill exceeded the slack for that query — the
    caller must use an exact fallback for it."""
    return _descend_and_sort(key, _all_slots(key), lex_rank, c, min(c, key.shape[1]))


def exact_top_c_slots(key, slots, *, c: int):
    """``exact_top_c`` over caller-provided ``(key [B, M], slots [B, M])``
    pairs — for keyed arrays that are gathered sub-blocks whose positions
    are NOT global slots (the fused stage-candidate rescore). Slot order
    must equal lex id order (lex-sorted cache blocks); pads carry +inf key."""
    return _descend_and_sort(key, slots, None, c, min(c, key.shape[1]))
