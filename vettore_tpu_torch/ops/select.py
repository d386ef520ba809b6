"""Exact batched group selection — recursive group-min descent.

``group_topk`` picks the ``gsel`` smallest group minima of each query row.
For large group counts it descends through 8-wide super-group minima first:
the gsel smallest group-mins occupy at most gsel super-groups, so any
super-group whose min exceeds the gsel-th smallest group-min holds none of
them (the same order-statistic bound as ops/flat_scan.py). Ties deeper than
the slack are reported through ``ok`` (callers fall back to a host oracle).
"""

from __future__ import annotations

import torch

from .topk import smallest

#: extra groups kept per level beyond C (boundary-tie absorption)
SLACK = 8

#: above this many groups the 8-wide super-group descent runs first
_DIRECT_TOPK = 2048


def group_topk(gmin: torch.Tensor, gsel: int, check_c=None):
    """Per-row ``gsel`` smallest entries of ``gmin`` [B, ng]
    (ascending-is-better, +inf pad): returns ``(values, idx, ok)`` sorted
    ascending, ``idx`` int64 and ``ok`` [B] bool.

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
        pad = (-ng) % 8
        gmin = torch.nn.functional.pad(gmin, (0, pad), value=float("inf"))
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
