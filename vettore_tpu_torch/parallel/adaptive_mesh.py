"""Mesh-sharded adaptive pipelines: funnel, quantized, MaxSim, hybrid rerank.

The port of ``vettore_tpu/parallel/adaptive_mesh.py``. The scan cache's
vector, sign and token blocks are row-sharded (``mesh.Blocks``); every
per-shard stage runs the single-device pipeline functions on the shard's own
rows, so a CUDA shard launches the hand kernels: the funnel's stage 1 is K5
+ K7 (``pipeline._stage1_candidates``), the quantized stage 1 K6 + K7
(``pipeline._hamming_slots``), the full MaxSim scan the MaxSim kernel + K7
(``maxsim.fused_maxsim_topk_batch``, where ``supports_fused`` holds for the
shard). Between stages only fixed-size ``(rank, global slot[, raw])``
candidate planes move, gathered onto the data row's first device and merged
by a stable two-key sort; never vectors. The cache is lex-sorted, so the
global slot IS the lex rank and the (rank, slot) merge keeps the
reference's (rank, id) tie-break (search.rs:23-29).

Stage exactness: a member of the global top-C at any stage is in the top-C
of its own shard, so an exact per-shard top-C and an exact global merge
select exactly the single-device candidate set: the results equal the
single-device pipelines' (each query's ``ok`` is the AND over the shards).

Every pipeline takes its query batch on the mesh's first device, with a
batch size that is a multiple of ``data``, and returns its outputs there.
The cache is lex-packed (its ``n`` live rows first), so each shard's live
rows are known from ``n``: a shard selects at most its live rows (a
selection past them would read its +inf pads as a tie spill) and a shard
with none sits out.
"""

from __future__ import annotations

import torch

from ..ops import maxsim as maxsim_ops
from ..ops import pipeline as pipe
from ..ops.topk import lex_sort
from .mesh import row_queries, to_first

_BIG32 = 2**31 - 1


def _merge_topc(mesh, per_shard, device, c):
    """Merges per-shard ``(rank, global slot)`` candidate sets: the global
    best ``c`` by (rank, slot), invalid = rank +inf. Returns ``(rank [b, c],
    slots [b, c])``, slot -1 where the rank is not finite."""
    r, s = mesh.gather(per_shard, device)
    key_s = torch.where(torch.isfinite(r), s, _BIG32)
    order = lex_sort(r, key_s)[:, :c]
    r2, s2 = r.gather(1, order), s.gather(1, order)
    return r2, torch.where(torch.isfinite(r2), s2, -1)


def _merge_topk_raw(mesh, per_shard, device, k):
    """The final merge, carrying raw values beside the rank keys: per-shard
    ``(rank, raw, global slot)``; returns ``(slots, raws, ranks)``."""
    r, w, s = mesh.gather(per_shard, device)
    key_s = torch.where(torch.isfinite(r), s, _BIG32)
    order = lex_sort(r, key_s)[:, :k]
    return s.gather(1, order), w.gather(1, order), r.gather(1, order)


def _merge_desc(mesh, per_shard, device, limit):
    """The MaxSim merge: per-shard ``(score, global slot)`` (``_BIG32`` for
    no hit), best by (score desc, slot asc). Returns ``(slots (-1 pads),
    scores)``."""
    s, g = mesh.gather(per_shard, device)
    key_slot = torch.where(s > float("-inf"), g, _BIG32)
    order = lex_sort(-s, key_slot)[:, :min(limit, s.shape[1])]
    s2, g2 = s.gather(1, order), g.gather(1, order)
    return torch.where(s2 > float("-inf"), g2, -1), s2


def _localize(gslots, gvalid, off, n_loc):
    """This shard's members of a replicated global candidate set: local
    slots (0 where foreign) and the membership mask."""
    mine = gvalid & (gslots >= off) & (gslots < off + n_loc)
    return torch.where(mine, gslots - off, 0), mine


def _all_ok(oks, device):
    """The AND over the shards of per-shard ``[b]`` flags, on ``device``."""
    out = oks[0].to(device)
    for ok in oks[1:]:
        out = out & ok.to(device)
    return out


def _live(rows, n, shards):
    """The live rows of each shard of a lex-packed block of ``n`` rows."""
    return [min(max(n - s * rows, 0), rows) for s in range(shards)]


def _global(slots, off):
    """Global int32 slots (-1 kept) of a shard's local slots."""
    return torch.where(slots >= 0, slots + off, -1).int()


def _narrow(mesh, r, x, qs, g_rank, g_slots, oks, live, *, metric, dims):
    """One narrowing stage over a replicated candidate set: each shard with
    live rows scores its members over ``dims`` columns. Returns per-shard
    ``(rank, raw, global slot)`` planes (non-members at rank +inf, slot
    -1); each shard's finiteness flag joins ``oks``."""
    n_loc = x.rows
    slots_r = mesh.replicate(g_slots, r)
    valid_r = mesh.replicate(torch.isfinite(g_rank), r)
    out = []
    for s, dev in enumerate(mesh.devices[r]):
        if not live[s]:
            continue
        lsl, mine = _localize(slots_r[s], valid_r[s], s * n_loc, n_loc)
        raw, rank, finite = pipe._subset_raw_rank(x.shard(s, r), lsl, mine, qs[dev],
                                                  metric=metric, dims=dims)
        oks.append(finite)
        out.append((torch.where(mine, rank, float("inf")), raw,
                    torch.where(mine, slots_r[s], -1)))
    return out


def _funnel_rows(mesh, x, valid, stage_xsq, queries, *, n, metric, stages, count, limit):
    """The funnel on every data row: stage 1 per shard and its merge, the
    narrowing stages, and (``limit`` set) the full-dims rerank."""
    n_loc, full_d = x.rows, x.shard(0).shape[1]
    live = _live(n_loc, n, mesh.shape["shard"])
    per_row = []
    for r, qs in enumerate(row_queries(mesh, queries)):
        head = mesh.devices[r][0]
        oks, per_shard = [], []
        for s, dev in enumerate(mesh.devices[r]):
            if not live[s]:
                continue
            slots, ranks, ok = pipe._stage1_candidates(
                x.shard(s, r), valid.shard(s, r), qs[dev],
                None if stage_xsq is None else stage_xsq.shard(s, r),
                metric=metric, dims=stages[0], count=min(count, live[s]))
            oks.append(ok)
            per_shard.append((ranks, _global(slots, s * n_loc)))
        g_rank, g_slots = _merge_topc(mesh, per_shard, head, count)
        for dims in stages[1:]:
            planes = _narrow(mesh, r, x, qs, g_rank, g_slots, oks, live, metric=metric,
                             dims=dims)
            g_rank, g_slots = _merge_topc(mesh, [(p[0], p[2]) for p in planes], head, count)
        if limit is None:
            per_row.append((g_slots, torch.isfinite(g_rank), _all_ok(oks, head)))
            continue
        planes = _narrow(mesh, r, x, qs, g_rank, g_slots, oks, live, metric=metric,
                         dims=full_d)
        per_row.append((*_merge_topk_raw(mesh, planes, head, limit), _all_ok(oks, head)))
    return to_first(mesh, per_row)


def sharded_funnel_topk(mesh, x, valid, stage_xsq, queries, *, n, metric, stages, count,
                        limit):
    """Sharded Matryoshka funnel + exact rerank. ``x`` / ``valid`` (and
    ``stage_xsq``, the prefix norms that enable K5, or None) are the cache's
    sharded blocks, ``n`` its live rows. Returns ``(slots [B, limit], raws, ranks, ok [B])``
    with slot -1 pads; equals ``pipeline.funnel_pipeline_batch``."""
    return _funnel_rows(mesh, x, valid, stage_xsq, queries, n=n, metric=metric,
                        stages=tuple(stages), count=count, limit=limit)


def sharded_funnel_candidates(mesh, x, valid, stage_xsq, queries, *, n, metric, stages, count):
    """The funnel's candidate stages only (the hybrid generator): global
    ``(slots [B, C], slot_ok [B, C], ok [B])``, (rank, slot)-ordered; the
    union re-sorts them. Equals ``pipeline.funnel_candidates_batch``'s
    set."""
    return _funnel_rows(mesh, x, valid, stage_xsq, queries, n=n, metric=metric,
                        stages=tuple(stages), count=count, limit=None)


def _hamming_rows(mesh, x, signs, valid, queries, *, n, metric, count, limit, d):
    """Sign-bit Hamming candidates per shard and their merge, then (``x``
    given) the full-dims rerank."""
    n_loc = signs.rows
    live = _live(n_loc, n, mesh.shape["shard"])
    per_row = []
    for r, qs in enumerate(row_queries(mesh, queries)):
        head = mesh.devices[r][0]
        oks, per_shard = [], []
        for s, dev in enumerate(mesh.devices[r]):
            if not live[s]:
                continue
            # composite (hamming, slot) keys per shard; the (ham, slot)
            # merge stays exact because local slot order is global order
            slots, ranks, sel_ok = pipe._hamming_slots(
                signs.shard(s, r), valid.shard(s, r), pipe.query_signs(qs[dev][:, :d]),
                count=min(count, live[s]), d=d)
            oks.append(sel_ok)
            per_shard.append((ranks, _global(slots, s * n_loc)))
        g_rank, g_slots = _merge_topc(mesh, per_shard, head, count)
        if x is None:
            per_row.append((g_slots, torch.isfinite(g_rank), _all_ok(oks, head)))
            continue
        planes = _narrow(mesh, r, x, qs, g_rank, g_slots, oks, live, metric=metric,
                         dims=x.shard(0).shape[1])
        per_row.append((*_merge_topk_raw(mesh, planes, head, limit), _all_ok(oks, head)))
    return to_first(mesh, per_row)


def sharded_quantized_topk(mesh, x, signs, valid, queries, *, n, metric, count, limit, d):
    """Sharded sign-bit Hamming candidates + exact rerank. Equals
    ``pipeline.quantized_pipeline_batch``."""
    return _hamming_rows(mesh, x, signs, valid, queries, n=n, metric=metric, count=count,
                         limit=limit, d=d)


def sharded_quantized_candidates(mesh, signs, valid, queries, *, n, count, d):
    """The Hamming candidate stage only (the hybrid generator)."""
    return _hamming_rows(mesh, None, signs, valid, queries, n=n, metric=None, count=count,
                         limit=None, d=d)


def sharded_maxsim_topk(mesh, tokens, counts, valid, norms, qtok, qmask, *, n, metric, limit,
                        chunk):
    """Sharded full-corpus MaxSim: per shard the fused scan (the MaxSim
    kernel, the group cover, an exact subset rerank) where
    ``maxsim.supports_fused`` holds for the shard, else the chunked plain
    scan; then the (score desc, slot asc) merge. ``norms`` are the shards'
    ``token_norms`` (Blocks of pairs) or None. Returns ``(slots [B, limit]
    (-1 pads), scores, ok [B])``."""
    n_loc = tokens.rows
    live = _live(n_loc, n, mesh.shape["shard"])
    fused = maxsim_ops.supports_fused(metric, n_loc, qtok.shape[1])
    per_row = []
    for r, (qts, qms) in enumerate(zip(row_queries(mesh, qtok), row_queries(mesh, qmask))):
        head = mesh.devices[r][0]
        oks, per_shard = [], []
        for s, dev in enumerate(mesh.devices[r]):
            if not live[s]:
                continue
            args = (tokens.shard(s, r), counts.shard(s, r), valid.shard(s, r), qts[dev],
                    qms[dev])
            if fused:
                slots, scores, ok = maxsim_ops.fused_maxsim_topk_batch(
                    *args, metric=metric, limit=min(limit, n_loc),
                    norms=None if norms is None else norms.shard(s, r))
            else:
                slots, scores, ok = maxsim_ops.maxsim_full_topk_batch(
                    *args, metric=metric, limit=min(limit, n_loc), chunk=min(chunk, n_loc))
            oks.append(ok)
            per_shard.append((scores, torch.where(slots >= 0, slots + s * n_loc, _BIG32).int()))
        per_row.append((*_merge_desc(mesh, per_shard, head, limit), _all_ok(oks, head)))
    return to_first(mesh, per_row)


def sharded_subset_maxsim(mesh, tokens, counts, cslots, cok, qtok, qmask, *, n, metric, limit):
    """Sharded MaxSim rerank of a global candidate set (the hybrid's MaxSim
    rerank): each shard with live rows scores its members, merged by (score
    desc, slot asc). Equals ``maxsim.maxsim_subset_topk_batch``."""
    n_loc = tokens.rows
    live = _live(n_loc, n, mesh.shape["shard"])
    per_row = []
    rows = zip(row_queries(mesh, cslots), row_queries(mesh, cok), row_queries(mesh, qtok),
               row_queries(mesh, qmask))
    for r, (css, coks, qts, qms) in enumerate(rows):
        head = mesh.devices[r][0]
        oks, per_shard = [], []
        for s, dev in enumerate(mesh.devices[r]):
            if not live[s]:
                continue
            lsl, mine = _localize(css[dev], coks[dev], s * n_loc, n_loc)
            top, scores, ok = maxsim_ops.maxsim_subset_topk_batch(
                tokens.shard(s, r), counts.shard(s, r), lsl, mine, qts[dev], qms[dev],
                metric=metric, limit=limit)
            oks.append(ok)
            per_shard.append((scores, torch.where(top >= 0, top + s * n_loc, _BIG32).int()))
        per_row.append((*_merge_desc(mesh, per_shard, head, limit), _all_ok(oks, head)))
    return to_first(mesh, per_row)


def sharded_subset_rerank(mesh, x, cslots, cok, queries, *, n, metric, limit):
    """Sharded exact full-dims rerank of a global candidate set (the
    hybrid's exact rerank). Equals ``pipeline.rerank_batch``."""
    per_row = []
    rows = zip(row_queries(mesh, cslots), row_queries(mesh, cok), row_queries(mesh, queries))
    for r, (css, coks, qs) in enumerate(rows):
        head = mesh.devices[r][0]
        cs, ck = css[head], coks[head]
        # a valid candidate's rank is finite for the narrowing's membership
        g_rank = torch.where(ck, 0.0, float("inf"))
        oks = []
        planes = _narrow(mesh, r, x, qs, g_rank, torch.where(ck, cs, -1).int(), oks,
                         _live(x.rows, n, mesh.shape["shard"]), metric=metric,
                         dims=x.shard(0).shape[1])
        per_row.append((*_merge_topk_raw(mesh, planes, head, limit), _all_ok(oks, head)))
    return to_first(mesh, per_row)
