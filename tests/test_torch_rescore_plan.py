"""The rescore kernels' work list on the CPU: what K2 ``rescore`` and K4
``int8_rescore`` are given on the card and how ``csrc/group_rescore.cuh``
walks it, held against the plain versions and the JAX package.

* ``_rescore_plan`` (f32 rows: the pairs ordered by group by a stable
  sort, which also orders the indices as the kernel clamps them; the
  identity at B = 1 and for bf16 and int8 rows) and ``_rescore_geometry`` (the
  window length, the row slices, the ring stage's rows and columns) over
  the pair counts and SM counts of small and large batches.
* A numpy model of the kernel's walk with the same index arithmetic: a
  block per (window of sorted pairs, row slice); per window the runs of
  equal groups; per run the stage steps (``rs`` rows by ``cols`` columns,
  partial sums carried over the column chunks); every pair of the run
  served from the staged rows and written to its own ``(b, s)`` slot. It
  must write every ``(pair, row)`` exactly once, stage each group of a
  window once per step, and, from the rows and queries alone, give the
  plain versions' ranks: K2 atol 1e-5 (f32 sums in another order), K4
  rtol 1e-5 (each product rounded before the add, the scale after the
  sum); and the JAX package's ``_rescore`` / ``_int8_rescore`` (Pallas,
  interpret mode, as ``tests/test_torch_flat_scan.py`` and
  ``tests/test_torch_int8.py`` run them) to the same tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import flat_scan as jfs
from vettore_tpu_torch.ops import flat_scan as tfs

torch.set_num_threads(2)

G = tfs.GROUP
CASES = ("distinct", "overlap", "identical", "b1", "out_of_range", "dead")
ROWS = ("f32", "bf16", "int8")


def _case(case, ng, b, gsel, seed=0):
    """``gidx`` [b, gsel] int32 of one selection scenario (``b`` = 1 for
    "b1"), and the groups to kill (all rows zero, +inf bias)."""
    rng = np.random.default_rng(seed)
    b = 1 if case == "b1" else b
    dead = []
    if case == "distinct":  # no group chosen twice in the batch
        gidx = rng.choice(ng, b * gsel, replace=False).reshape(b, gsel)
    elif case == "identical":  # every query chose the same groups
        gidx = np.tile(rng.choice(ng, gsel, replace=False), (b, 1))
    else:  # heavy overlap: each query's distinct groups out of a small pool
        pool = rng.choice(ng, min(ng, 2 * gsel), replace=False)
        gidx = np.stack([rng.choice(pool, gsel, replace=False) for _ in range(b)])
        if case == "out_of_range":
            gidx[0, 0], gidx[-1, -1], gidx[b // 2, 1] = ng + 3, -2, ng
        elif case == "dead":
            dead = [int(gidx[0, 0]), int(gidx[-1, 1])]
    return gidx.astype(np.int32), dead


def _data(case, n, d, b, seed=1):
    """Numpy rows ``x`` [n, d] of norms 0.5-2 and unit queries ``q`` [b, d]
    (all equal in the "identical" case)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if case == "identical":
        q[:] = q[0]
    return x, q


def _operands(case, n, d, b, gsel, rows):
    """``(xs, scale, xsq, bias, q, gidx)``: the stored rows ``xs`` (torch, in
    the storage type ``rows``) and their ``scale`` (int8, else None), numpy
    side values, queries and selection of ``_case(case, ...)``."""
    gidx, dead = _case(case, n // G, b, gsel)
    x, q = _data(case, n, d, gidx.shape[0])
    bias = np.zeros(n, np.float32)
    for g in dead:
        x[g * G:(g + 1) * G] = 0.0
        bias[g * G:(g + 1) * G] = np.inf
    xs = torch.from_numpy(x)
    scale = None
    if rows == "bf16":
        xs = xs.to(torch.bfloat16)
    elif rows == "int8":
        xs, scale = tfs.quantize_rows(xs)
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    return xs, scale, xsq, bias, q, gidx


def _ref(xs, scale, xsq, bias, q, gidx, metric):
    t = (torch.from_numpy(xsq), torch.from_numpy(bias), torch.from_numpy(q))
    g = torch.from_numpy(gidx).clamp(0, xs.shape[0] // G - 1)
    if scale is None:
        return tfs._rescore_ref(xs, *t, g, metric=metric).numpy()
    return tfs._int8_rescore_ref(xs, scale, *t, g, metric=metric).numpy()


def _model(xs, scale, xsq, bias, q, groups, pairs, geo, gsel, metric):
    """``csrc/group_rescore.cuh``'s walk of the plan in numpy: ``(out [B,
    gsel, 64], writes [P, 64], staged)``; ``staged`` lists each step's
    (window, slice, group, sub-slice, chunk)."""
    w, rows, rs, cols = geo
    xf = xs.float().numpy()
    sc = None if scale is None else scale.numpy()
    n, d = xf.shape
    ng, p = n // G, len(groups)
    qsq = np.sum(q * q, axis=1, dtype=np.float32)
    nsub, nch = rows // rs, -(-d // cols)
    out = np.full((p, G), np.nan, np.float32)
    writes = np.zeros((p, G), np.int64)
    staged = []
    for i0 in range(0, p, w):  # blockIdx.x
        g = np.clip(groups[i0:i0 + w], 0, ng - 1)
        pr = pairs[i0:i0 + w] if pairs is not None else np.arange(i0, i0 + len(g))
        starts = [0] + [j for j in range(1, len(g)) if g[j] != g[j - 1]] + [len(g)]
        for s0 in range(0, G, rows):  # blockIdx.y
            for k in range(len(starts) - 1):
                run = pr[starts[k]:starts[k + 1]]
                bq = run // gsel
                for sub in range(nsub):
                    base = int(g[starts[k]]) * G + s0 + sub * rs
                    dot = np.zeros((len(run), rs), np.float32)
                    for ch in range(nch):
                        c0 = ch * cols
                        stage = xf[base:base + rs, c0:c0 + cols]
                        staged.append((i0, s0, int(g[starts[k]]), sub, ch))
                        prod = q[bq, None, c0:c0 + cols] * stage[None]  # rounded products
                        dot = dot + prod.sum(axis=2, dtype=np.float32)
                    r = base + np.arange(rs)
                    if sc is not None:
                        dot = dot * sc[r]
                    if tfs._is_l2(metric):
                        rank = xsq[r] - np.float32(2.0) * dot + qsq[bq, None]
                    else:
                        rank = -dot
                    rank = rank + bias[r]
                    slot = (s0 + sub * rs + np.arange(rs))[None, :]
                    out[run[:, None], slot] = np.where(np.isfinite(rank), rank, np.inf)
                    np.add.at(writes, (np.broadcast_to(run[:, None], rank.shape),
                                       np.broadcast_to(slot, rank.shape)), 1)
    return out.reshape(-1, gsel, G), writes, staged


def _assert_close(got, want, scaled):
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all() and (got[~fin] == want[~fin]).all()
    err = np.abs(got[fin] - want[fin])
    if scaled:  # K4: 1e-5 * max(1, |rank|)
        assert (err <= 1e-5 * np.maximum(1.0, np.abs(want[fin]))).all(), err.max()
    else:  # K2: atol 1e-5
        assert err.max(initial=0.0) <= 1e-5


def _plan(gidx, n, d, elt, sms):
    groups, pairs, geo = tfs._rescore_plan(torch.from_numpy(gidx), n, d=d, elt=elt, sms=sms)
    return groups.numpy(), None if pairs is None else pairs.numpy(), geo


# ---------------------------------------------------------------------------
# the plan and the geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elt", [1, 2, 4])
@pytest.mark.parametrize("sms", [1, 15, 16, 132])
@pytest.mark.parametrize("case", CASES)
def test_plan_orders_pairs_by_group_stably(case, sms, elt):
    # P = 63 pairs of f32 rows: sorted on a card of up to 15 SMs (P > 4 *
    # sms), in their own order on 16 or more, where every work item is in
    # flight; bf16 and int8 rows always in their own order
    n, b, gsel = 64 * 80, 9, 7
    gidx, _dead = _case(case, n // G, b, gsel)
    groups, pairs, _geo = _plan(gidx, n, 32, elt, sms)
    flat = gidx.reshape(-1)  # raw: the kernel clamps what it reads
    if elt != 4 or gidx.shape[0] == 1 or flat.size <= 4 * sms:  # no sort
        assert pairs is None and (groups == flat).all()
        return
    assert groups.dtype == np.int32 and pairs.dtype == np.int64
    assert sorted(pairs.tolist()) == list(range(flat.size))
    assert (groups == flat[pairs]).all() and (np.diff(groups) >= 0).all()
    same = np.diff(groups) == 0
    assert (np.diff(pairs)[same] > 0).all()  # stable: equal groups keep pair order
    # clamped as the kernel reads them, the groups stay ordered: runs are whole
    assert (np.diff(np.clip(groups, 0, n // G - 1)) >= 0).all()


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("elt", [1, 2, 4])
def test_geometry_fills_the_card_and_fits_a_stage(sms, elt):
    for p in list(range(1, 300)) + [576, 1000, 4096, 9216, 12288, 100_000]:
        for d in (1, 33, 96, 99, 768, 4096, 40_000):
            w, rows, rs, cols = tfs._rescore_geometry(p, d, elt, sms)
            windows = -(-p // w)
            slices = G // rows
            assert 1 <= w <= tfs.RESCORE_MAX_WINDOW and slices * rows == G
            assert slices in (1, 2, 4, 8, 16) and rows % rs == 0
            # at least as many blocks as one per pair, up to 8 per SM
            assert windows * slices >= min(p, 8 * sms)
            assert rs * cols * elt <= tfs.RESCORE_STAGE_BYTES and 0 < cols <= d
            assert cols == d or rs == 1  # column chunks only for rows past a stage
            if d * elt % 16 == 0:  # the direct route's 16-byte copies
                assert cols * elt % 16 == 0


# ---------------------------------------------------------------------------
# the kernel's walk
# ---------------------------------------------------------------------------

#: stage shapes (rows per stage as a fraction of the slice, columns): whole
#: slices, half slices, single rows, single rows in column chunks
STAGES = ((1, None), (2, None), ("row", None), ("row", 8), ("row", 16))


@pytest.mark.parametrize("case", ["overlap", "identical", "b1"])
@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
def test_walk_writes_every_pair_row_once(slices, case):
    n, d, b, gsel = 64 * 24, 33, 6, 5
    xs, scale, xsq, bias, q, gidx = _operands(case, n, d, b, gsel, "f32")
    groups, pairs, _geo = _plan(gidx, n, d, 4, 1)  # P = 30 > 4 SMs: sorted
    want = _ref(xs, scale, xsq, bias, q, gidx, "l2")
    rows = G // slices
    for w in (1, 2, 3, 4, 7, 16, 29, 30, 64):
        for div, cols in STAGES:
            rs = 1 if div == "row" else max(1, rows // div)
            geo = (w, rows, rs, cols or d)
            out, writes, staged = _model(xs, scale, xsq, bias, q, groups, pairs, geo, gsel, "l2")
            assert (writes == 1).all(), geo
            if pairs is not None:  # sorted: a window stages each group once per step
                assert len(staged) == len(set(staged)), geo
            _assert_close(out, want, False)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_versions(case, rows):
    # P = 1,200 pairs on a card of 8 SMs: windows of 64 pairs, so the runs
    # of the overlapping and identical cases cross windows (f32 rows, the
    # sorted plan; bf16 and int8 rows walk the pairs in their own order)
    n, d, b, gsel = 64 * 1280, 40, 100, 12
    xs, scale, xsq, bias, q, gidx = _operands(case, n, d, b, gsel, rows)
    groups, pairs, geo = _plan(gidx, n, d, xs.element_size(), 8)
    if case != "b1":
        assert geo[0] == 64 and len(groups) > geo[0]
    for metric in ("cosine", "l2"):
        out, writes, _staged = _model(xs, scale, xsq, bias, q, groups, pairs, geo, gsel, metric)
        assert (writes == 1).all()
        _assert_close(out, _ref(xs, scale, xsq, bias, q, gidx, metric), scale is not None)


def _jax_rescore(xs, scale, xsq, bias, q, gidx, metric):
    g = jnp.asarray(np.clip(gidx, 0, xs.shape[0] // G - 1))
    side = (jnp.asarray(xsq), jnp.asarray(bias), jnp.asarray(q))
    if scale is None:
        jx = jnp.asarray(xs.float().numpy())
        if xs.dtype == torch.bfloat16:
            jx = jx.astype(jnp.bfloat16)
        return np.asarray(jfs._rescore(jx, *side, g, metric=metric))
    return np.asarray(jfs._int8_rescore(jnp.asarray(xs.numpy()), jnp.asarray(scale.numpy()),
                                        *side, g, metric=metric))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("case", CASES)
def test_model_matches_jax(case, rows):
    # 8 queries x 6 groups on a card of 8 SMs: windows of 3 pairs, slices of
    # 16 rows, so a run of the identical case spans three windows
    n, d, b, gsel = 64 * 64, 33, 8, 6
    xs, scale, xsq, bias, q, gidx = _operands(case, n, d, b, gsel, rows)
    groups, pairs, geo = _plan(gidx, n, d, xs.element_size(), 8)
    metric = "l2" if case in ("overlap", "dead") else "cosine"
    out, writes, _staged = _model(xs, scale, xsq, bias, q, groups, pairs, geo, gsel, metric)
    assert (writes == 1).all()
    _assert_close(out, _jax_rescore(xs, scale, xsq, bias, q, gidx, metric), scale is not None)


@pytest.mark.parametrize("wrapper", ["rescore", "int8_rescore"])
def test_cpu_wrappers_clamp_group_indices(wrapper):
    n, d, b, gsel = 64 * 10, 16, 3, 4
    xs, scale, xsq, bias, q, gidx = _operands("out_of_range", n, d, b, gsel,
                                              "int8" if wrapper == "int8_rescore" else "f32")
    t = (torch.from_numpy(xsq), torch.from_numpy(bias), torch.from_numpy(q),
         torch.from_numpy(gidx))
    got = (tfs.rescore(xs, *t, metric="l2") if scale is None
           else tfs.int8_rescore(xs, scale, *t, metric="l2"))
    np.testing.assert_array_equal(got.numpy(), _ref(xs, scale, xsq, bias, q, gidx, "l2"))
