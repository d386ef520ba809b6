"""The port's MaxSim ops against the JAX package's, on the CPU.

The same numpy inputs go through ``vettore_tpu.ops.maxsim`` (its Pallas
kernels K8 and K9 in interpret mode, as ``tests/test_maxsim_fused.py`` runs
them) and ``vettore_tpu_torch.ops.maxsim`` (CPU tensors, so the rank-scan
wrapper runs its plain PyTorch version). Shapes as the JAX test: CAP = 128
docs of T = 4 tokens, D = 128. Tolerances:

* slots: identical, in order;
* scores: rtol 1e-5, atol 1e-6 (f32 sums in another order);
* rank matrices (plain rank scan against K8 / K9): rtol = atol = 1e-5 for
  f32 blocks, 1e-4 for bf16 blocks (exact bf16 products summed in another
  order; inner products reach ~30 here); +inf entries equal;
* host ``score`` / ``top_k``: equal (the same float64 code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import maxsim as jms
from vettore_tpu_torch.ops import flat_scan as tfs
from vettore_tpu_torch.ops import maxsim as tms

torch.set_num_threads(2)

CAP, T, D = 128, 4, 128
DOT_METRICS = ("cosine", "inner_product", "negative_inner_product")
STORAGES = ("f32", "bf16")


def _block(seed=77, n_real=100, zero_token_docs=(5, 17), dead=(9,), uniform=False):
    """Numpy ``(tokens, counts, valid)``; pad token rows zero (the cache
    contract)."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((CAP, T, D)).astype(np.float32)
    if uniform:
        counts = np.where(np.arange(CAP) < n_real, T, 0).astype(np.int32)
    else:
        counts = rng.integers(1, T + 1, CAP).astype(np.int32)
        counts[list(zero_token_docs)] = 0
    counts[n_real:] = 0
    for i in range(CAP):
        tokens[i, counts[i]:] = 0.0
    valid = np.arange(CAP) < n_real
    if not uniform:
        valid[list(dead)] = False
    return tokens, counts, valid


def _queries(seed=78, b=3, qmax=2, ragged=True):
    rng = np.random.default_rng(seed)
    qtok = rng.standard_normal((b, qmax, D)).astype(np.float32)
    qmask = np.ones((b, qmax), bool)
    if ragged and b > 1:
        qmask[1, 1:] = False
    qtok[~qmask] = 0.0
    return qtok, qmask


def _jax(tokens, counts, valid, qtok, qmask, storage):
    jt = jnp.asarray(tokens)
    if storage == "bf16":
        jt = jt.astype(jnp.bfloat16)
    return jt, jnp.asarray(counts), jnp.asarray(valid), jnp.asarray(qtok), jnp.asarray(qmask)


def _torch(tokens, counts, valid, qtok, qmask, storage):
    tt = torch.from_numpy(tokens)
    if storage == "bf16":
        tt = tt.to(torch.bfloat16)
    return (tt, torch.from_numpy(counts), torch.from_numpy(valid), torch.from_numpy(qtok),
            torch.from_numpy(qmask))


def _assert_same_topk(got, want, ok=True):
    g_slots, g_scores, g_ok = (t.numpy() for t in got)
    w_slots, w_scores, w_ok = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(g_ok, w_ok)
    if ok:
        assert g_ok.all()
    np.testing.assert_array_equal(g_slots, w_slots)
    np.testing.assert_allclose(g_scores, w_scores, rtol=1e-5, atol=1e-6)


def _jax_fused(args, metric, limit, uniform):
    jt, _c, _v, jq, _m = args
    return jms.fused_maxsim_topk_batch(*args, metric=metric, limit=limit, t=T,
                                       b=int(jq.shape[0]), uniform=uniform)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("metric", DOT_METRICS)
def test_fused_topk_matches_jax(metric, uniform, storage):
    data = _block(uniform=uniform) + _queries()
    want = _jax_fused(_jax(*data, storage), metric, 10, uniform)
    # the port's one kernel reads the counts of a uniform block too
    got = tms.fused_maxsim_topk_batch(*_torch(*data, storage), metric=metric, limit=10)
    _assert_same_topk(got, want)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("metric", DOT_METRICS)
def test_rank_scan_matches_jax_kernels(metric, uniform, storage):
    """The plain rank scan against K8 (masked) and K9 (uniform) themselves."""
    tokens, counts, valid, qtok, _qmask = _block(uniform=uniform) + _queries()
    b, qmax = qtok.shape[:2]
    jt = jnp.asarray(tokens)
    if storage == "bf16":
        jt = jt.astype(jnp.bfloat16)
    x2 = jt.reshape(CAP * T, D)
    qn = np.sqrt((qtok.astype(np.float32) ** 2).sum(axis=2))
    qinv = (np.where(qn > 0, 1.0 / np.maximum(qn, 1e-38), 0.0) if metric == "cosine"
            else np.ones_like(qn)).astype(np.float32).reshape(-1)
    dzero = (counts <= 0).astype(np.float32)
    dbias = np.where(valid, 0.0, np.inf).astype(np.float32)
    qt = jnp.asarray(qtok.reshape(b * qmax, D)).T.astype(x2.dtype)
    row_tile = jms._mv_row_tile(T, D, b * qmax, x2.dtype.itemsize, CAP * T)
    if uniform:
        want = jms.fused_maxsim_rank_scan_uniform(
            x2, jnp.asarray(dzero), jnp.asarray(dbias), qt, jnp.asarray(qinv)[None, :],
            t=T, b=b, metric=metric, row_tile=row_tile)
    else:
        tsq = np.asarray(jms._row_sq_sums(x2))
        tn = np.sqrt(tsq)
        tinv = (np.where(tn > 0, 1.0 / np.maximum(tn, 1e-38), 0.0) if metric == "cosine"
                else np.ones_like(tn)).astype(np.float32)
        live = (np.arange(T)[None, :] < counts[:, None]).reshape(-1)
        tbias = np.where(live, 0.0, jms._PAD_SIM).astype(np.float32)
        want = jms.fused_maxsim_rank_scan(
            x2, jnp.asarray(tinv)[:, None], jnp.asarray(tbias)[:, None],
            jnp.asarray(dzero)[:, None], jnp.asarray(dbias)[:, None], qt,
            jnp.asarray(qinv)[None, :], t=T, b=b, metric=metric, row_tile=row_tile)
    tt = torch.from_numpy(tokens)
    if storage == "bf16":
        tt = tt.to(torch.bfloat16)
    got = tms.maxsim_rank_scan(tt, torch.from_numpy(counts), torch.from_numpy(dbias),
                               torch.from_numpy(qtok.reshape(b * qmax, D)),
                               torch.from_numpy(qinv), b=b, metric=metric).numpy()
    want = np.asarray(want)
    fin = np.isfinite(want)
    assert got.shape == (b, CAP) and (np.isfinite(got) == fin).all()
    tol = 1e-5 if storage == "f32" else 1e-4
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


def test_zero_token_docs_score_zero_and_rank_by_slot():
    tokens, counts, valid = _block(zero_token_docs=(0, 1, 2))
    qtok, qmask = _queries(b=1)
    # every real doc scores negative: the zero-token docs win, by slot
    tokens, qtok = np.abs(tokens), -np.abs(qtok)
    data = (tokens, counts, valid, qtok, qmask)
    want = _jax_fused(_jax(*data, "f32"), "inner_product", 5, False)
    got = tms.fused_maxsim_topk_batch(*_torch(*data, "f32"), metric="inner_product", limit=5)
    _assert_same_topk(got, want)
    assert got[0][0, :3].tolist() == [0, 1, 2]


@pytest.mark.parametrize("storage", STORAGES)
def test_empty_query_sets_score_all_zero(storage):
    tokens, counts, valid = _block()
    qtok, qmask = np.zeros((2, 2, D), np.float32), np.zeros((2, 2), bool)
    data = (tokens, counts, valid, qtok, qmask)
    want = _jax_fused(_jax(*data, storage), "cosine", 4, False)
    got = tms.fused_maxsim_topk_batch(*_torch(*data, storage), metric="cosine", limit=4)
    _assert_same_topk(got, want)
    assert (got[1] == 0).all()


@pytest.mark.parametrize("metric", DOT_METRICS)
def test_dead_slots_never_returned(metric):
    data = _block(dead=(3, 4, 5)) + _queries(b=2)
    want = _jax_fused(_jax(*data, "f32"), metric, 20, False)
    got = tms.fused_maxsim_topk_batch(*_torch(*data, "f32"), metric=metric, limit=20)
    _assert_same_topk(got, want)
    assert not {3, 4, 5} & set(got[0].flatten().tolist())


@pytest.mark.parametrize("qmax", [1, 4, 8])
def test_ragged_query_sets_match_jax(qmax):
    rng = np.random.default_rng(qmax)
    qtok, qmask = _queries(seed=qmax, b=4, qmax=qmax, ragged=False)
    for i, n in enumerate(rng.integers(1, qmax + 1, 4)):
        qmask[i, n:] = False
    qtok[~qmask] = 0.0
    data = _block() + (qtok, qmask)
    want = _jax_fused(_jax(*data, "f32"), "cosine", 10, False)
    got = tms.fused_maxsim_topk_batch(*_torch(*data, "f32"), metric="cosine", limit=10)
    _assert_same_topk(got, want)


def test_overflow_bound_flags_not_ok():
    tokens, counts, valid, qtok, qmask = _block() + _queries()
    tokens[7, 0] = 3e20  # |dot| bound far past f32
    data = (tokens, counts, valid, qtok, qmask)
    want = _jax_fused(_jax(*data, "f32"), "inner_product", 10, False)
    got = tms.fused_maxsim_topk_batch(*_torch(*data, "f32"), metric="inner_product", limit=10)
    assert not got[2].any() and not np.asarray(want[2]).any()


# ---------------------------------------------------------------------------
# the plain paths, every metric
# ---------------------------------------------------------------------------

ALL_METRICS = ("cosine", "inner_product", "negative_inner_product", "l2", "l2_squared",
               "manhattan", "jaccard")


@pytest.mark.parametrize("chunk", [CAP, 48])
@pytest.mark.parametrize("metric", ALL_METRICS)
def test_full_topk_matches_jax(metric, chunk):
    # chunk 48: three chunks, the last clamped back over the second
    data = _block() + _queries()
    want = jms.maxsim_full_topk_batch(*_jax(*data, "f32"), metric=metric, limit=10, chunk=chunk)
    got = tms.maxsim_full_topk_batch(*_torch(*data, "f32"), metric=metric, limit=10, chunk=chunk)
    _assert_same_topk(got, want)


@pytest.mark.parametrize("metric", ("cosine", "l2", "manhattan"))
def test_full_topk_bf16_matches_jax(metric):
    data = _block() + _queries()
    want = jms.maxsim_full_topk_batch(*_jax(*data, "bf16"), metric=metric, limit=10, chunk=64)
    got = tms.maxsim_full_topk_batch(*_torch(*data, "bf16"), metric=metric, limit=10, chunk=64)
    _assert_same_topk(got, want)


@pytest.mark.parametrize("metric", ALL_METRICS)
def test_subset_topk_matches_jax(metric):
    tokens, counts, valid, qtok, qmask = _block() + _queries()
    rng = np.random.default_rng(5)
    slots = np.stack([rng.choice(100, 30, replace=False) for _ in range(3)]).astype(np.int32)
    slot_ok = np.ones_like(slots, bool)
    slot_ok[0, 3:6] = False  # pads
    want = jms.maxsim_subset_topk_batch(
        jnp.asarray(tokens), jnp.asarray(counts), jnp.asarray(slots), jnp.asarray(slot_ok),
        jnp.asarray(qtok), jnp.asarray(qmask), metric=metric, limit=12)
    got = tms.maxsim_subset_topk_batch(
        torch.from_numpy(tokens), torch.from_numpy(counts), torch.from_numpy(slots),
        torch.from_numpy(slot_ok), torch.from_numpy(qtok), torch.from_numpy(qmask),
        metric=metric, limit=12)
    _assert_same_topk(got, want)


@pytest.mark.parametrize("metric", ALL_METRICS + ("chebyshev", "hamming"))
def test_batched_scores_match_jax(metric):
    tokens, counts, _valid, qtok, _qmask = _block() + _queries()
    want_tot, want_fin = jms.batched_maxsim_scores(jnp.asarray(tokens), jnp.asarray(counts),
                                                   jnp.asarray(qtok[0]), metric=metric)
    got_tot, got_fin = tms.batched_maxsim_scores(torch.from_numpy(tokens),
                                                 torch.from_numpy(counts),
                                                 torch.from_numpy(qtok[0]), metric=metric)
    np.testing.assert_array_equal(got_fin.numpy(), np.asarray(want_fin))
    np.testing.assert_allclose(got_tot.numpy(), np.asarray(want_tot), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ("cosine", "inner_product", "l2", "manhattan"))
def test_host_score_and_top_k_equal(metric):
    rng = np.random.default_rng(6)
    docs = [(f"d{i}", rng.normal(size=(int(rng.integers(0, 4)), 5)).tolist()) for i in range(12)]
    query = rng.normal(size=(3, 5)).tolist()
    assert tms.score(query, docs[1][1] or [[0.5] * 5], metric) == jms.score(
        query, docs[1][1] or [[0.5] * 5], metric)
    assert tms.top_k(docs, query, metric, 6) == jms.top_k(docs, query, metric, 6)
    assert tms.top_k(docs, [], metric, 3) == jms.top_k(docs, [], metric, 3)


# ---------------------------------------------------------------------------
# the port's own rules
# ---------------------------------------------------------------------------


def test_supports_fused_keeps_only_the_kernels_limits():
    # any T, d, query count and storage: no TPU tile or VMEM gate
    assert tms.supports_fused("cosine", 64, 3)
    assert tms.supports_fused("inner_product", 1_048_576, 32)
    assert tms.supports_fused("negative_inner_product", 192, 1)
    assert not tms.supports_fused("l2", 1024, 4)  # semantics: the plain path
    assert not tms.supports_fused("cosine", 32, 4)  # under one 64-doc group
    assert not tms.supports_fused("cosine", 100, 4)  # not a group multiple
    assert not tms.supports_fused("cosine", 1024, tms.MAX_QUERY_TOKENS + 1)


@pytest.mark.parametrize("exact", [True, False])
def test_token_block_residency(exact):
    rng = np.random.default_rng(7)
    block = rng.normal(size=(8, 2, 16)).astype(np.float32)
    if exact:
        block = torch.from_numpy(block).to(torch.bfloat16).float().numpy()
    dev = tms.put_token_block(block, "cpu")
    assert dev.dtype == (torch.bfloat16 if exact else torch.float32)
    np.testing.assert_array_equal(dev.float().numpy(), block)  # lossless either way


def test_rank_scan_refuses_other_devices_and_counts_nothing():
    tokens, counts, valid = (torch.from_numpy(a) for a in _block())
    qt = torch.zeros((6, D))
    qinv = torch.ones(6)
    dbias = torch.zeros(CAP)
    before = dict(tms.LAUNCHES)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tms.maxsim_rank_scan(tokens.to("meta"), counts.to("meta"), dbias.to("meta"),
                             qt.to("meta"), qinv.to("meta"), b=3, metric="cosine")
    with pytest.raises(ValueError, match="metric"):
        tms.maxsim_rank_scan(tokens, counts, dbias, qt, qinv, b=3, metric="l2")
    tms.fused_maxsim_topk_batch(tokens, counts, valid, *(torch.from_numpy(a) for a in _queries()),
                                metric="cosine", limit=5)
    assert tms.LAUNCHES == before and "extract_group_rows" in tfs.LAUNCHES
