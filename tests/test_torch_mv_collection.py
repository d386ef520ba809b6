"""The port's multi-vector ``Collection`` surface against the JAX package's,
on the CPU: the same records (``put_tokens`` blocks and ``put_many`` records
with ``vectors``) and the same query sets through ``vettore_tpu`` and
``vettore_tpu_torch`` (``device="cpu"``) give identical ids in identical
order and scores within 1e-5 * max(1, |score|).

The two packages may take different device routes for the same search (the
JAX fused scan needs d % 128 == 0 and 128-doc tiles; the port's kernel takes
any d and 64-doc groups): both routes return the same full-f32 scores, so
the results must agree either way. Also: snapshots with token records load
across the packages, the token block converter, and the refusals of what is
not ported yet.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu_torch import convert
from vettore_tpu_torch.ops import maxsim as tms

torch.set_num_threads(2)

TOL = 1e-5


def _tokens(n, t, d, seed=0, bf16=False):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n, 1, d)).astype(np.float32)
    toks = centres + 0.3 * rng.standard_normal((n, t, d)).astype(np.float32)
    if bf16:
        toks = torch.from_numpy(toks).to(torch.bfloat16).float().numpy()
    return toks


def _ids(n, seed=0):
    return [f"doc-{i:05d}" for i in np.random.default_rng(seed).permutation(n)]


def _query_sets(toks, seed=1, count=4):
    rng = np.random.default_rng(seed)
    sets = []
    for i in range(count):
        doc = toks[rng.integers(0, toks.shape[0])]
        q = doc[: 1 + i % doc.shape[0]] + 0.1 * rng.standard_normal(
            (1 + i % doc.shape[0], doc.shape[1])).astype(np.float32)
        sets.append(q.tolist())
    return sets


def _pair(metric, normalize=None, d=16):
    kw = dict(name="mv", dimensions=d, metric=metric, index="flat")
    if normalize is not None:
        kw["normalize"] = normalize
    return jvt.Collection(**kw), tvt.Collection(**kw, device="cpu")


def _hits(rows):
    return [[(r.id, r.score) for r in row] for row in rows]


def _assert_same(got, want):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, g), (_, w) in zip(grow, wrow):
            assert abs(g - w) <= TOL * max(1.0, abs(w)), (g, w)


def _compare(jcol, tcol, sets, limit=7, metric=None):
    # the sets as lists of floats (the port's per-token loop) and as ndarray
    # rows (its block path), the same values
    for form in (sets, [list(np.asarray(qs)) for qs in sets]):
        _assert_same(_hits(tcol.multi_vector_search_batch(form, limit=limit, metric=metric)),
                     _hits(jcol.multi_vector_search_batch(form, limit=limit, metric=metric)))
        for qs in form[:2]:
            _assert_same(_hits([tcol.multi_vector_search(qs, limit=limit, metric=metric)]),
                         _hits([jcol.multi_vector_search(qs, limit=limit, metric=metric)]))
    assert tcol.host_routes == 0


# (metric, n docs, tokens per doc): n = 150 (cap 256) and 40 (cap 64) reach
# the port's fused kernel for the dot metrics; n = 5 (cap 8) and the other
# metrics take the plain scan
CASES = [("cosine", 150, 4), ("inner_product", 150, 4), ("negative_inner_product", 150, 4),
         ("cosine", 40, 3), ("cosine", 5, 2), ("l2", 150, 4), ("manhattan", 40, 2)]


@pytest.mark.parametrize("metric,n,t", CASES)
def test_put_tokens_search_matches_jax(metric, n, t):
    toks = _tokens(n, t, 16, seed=n)
    ids = _ids(n, seed=n)
    jcol, tcol = _pair(metric, normalize="none")
    for col in (jcol, tcol):
        col.put_tokens(ids, toks, metadata=[{"i": i} for i in range(n)])
    for id in ids[:3]:
        te, je = tcol.get(id), jcol.get(id)
        np.testing.assert_array_equal(np.asarray(te.vectors), np.asarray(je.vectors))
        assert np.asarray(te.vector).tobytes() == np.asarray(je.vector).tobytes()
        assert te.metadata == je.metadata
    fused = tms.supports_fused(metric, tcol._scan_cache().cap, 4)
    assert fused == (metric in tms.FUSED_MV_METRICS and n >= 40)
    _compare(jcol, tcol, _query_sets(toks))


@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_ragged_put_many_records_match_jax(metric):
    rng = np.random.default_rng(3)
    records = []
    for i in range(120):
        t = int(rng.integers(1, 6))
        rec = {"id": f"r{i:04d}", "vectors": rng.standard_normal((t, 16)).tolist()}
        if i % 17 == 0:  # a primary vector only: it scores as one token
            rec = {"id": f"r{i:04d}", "vector": rng.standard_normal(16).tolist()}
        records.append(rec)
    jcol, tcol = _pair(metric)
    for col in (jcol, tcol):
        col.put_many(records)
        col.delete("r0005")
    cache = tcol._scan_cache()
    tokens, counts = cache.multi_vectors()
    assert tokens.shape[1] == 8  # T = pow2 of the longest set
    assert (counts[: cache.n] < 8).any() and not jcol._scan_cache().mv_uniform
    sets = [rng.standard_normal((int(rng.integers(1, 4)), 16)).tolist() for _ in range(5)]
    _compare(jcol, tcol, sets, limit=12)


@pytest.mark.parametrize("bf16", [False, True])
def test_uniform_block_residency_matches_jax(bf16):
    toks = _tokens(200, 4, 32, seed=4, bf16=bf16)
    ids = _ids(200, seed=4)
    jcol, tcol = _pair("cosine", normalize="none", d=32)
    for col in (jcol, tcol):
        col.put_tokens(ids, toks)
    cache = tcol._scan_cache()
    tokens, counts = cache.multi_vectors()
    assert (counts[: cache.n] == 4).all() and (counts[cache.n:] == 0).all()
    assert tokens.dtype == (torch.bfloat16 if bf16 else torch.float32)
    jtok, _jc = jcol._scan_cache().multi_vectors()
    assert jcol._scan_cache().mv_uniform
    assert str(jtok.dtype) == ("bfloat16" if bf16 else "float32")
    _compare(jcol, tcol, _query_sets(toks, seed=5, count=6), limit=10)


def test_plain_corpus_scores_through_primary_vectors():
    rng = np.random.default_rng(6)
    data = rng.standard_normal((90, 16)).astype(np.float32)
    jcol, tcol = _pair("cosine")
    for col in (jcol, tcol):
        col.put_matrix(_ids(90, seed=6), data)
    assert tcol._scan_cache().multi_vectors()[0].shape[1] == 1
    _compare(jcol, tcol, [data[:2].tolist(), data[5:6].tolist()], limit=5)


def test_empty_and_other_metric_searches_match_jax():
    toks = _tokens(70, 2, 16, seed=7)
    jcol, tcol = _pair("cosine", normalize="none")
    assert tcol.multi_vector_search([[1.0] * 16]) == []
    assert tcol.multi_vector_search_batch([]) == []
    for col in (jcol, tcol):
        col.put_tokens(_ids(70, seed=7), toks)
    sets = _query_sets(toks, seed=8, count=3)
    # a per-call metric other than the collection's
    _compare(jcol, tcol, sets, metric="l2")
    _compare(jcol, tcol, sets, metric="inner_product")


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_token_snapshot_loads_across_packages(direction, tmp_path):
    toks = _tokens(80, 3, 16, seed=9)
    ids = _ids(80, seed=9)
    jcol, tcol = _pair("cosine", normalize="none")
    for col in (jcol, tcol):
        col.put_tokens(ids, toks)
    path = str(tmp_path / "mv.vsnap")
    if direction == "jax_to_torch":
        jcol.snapshot(path)
        loaded, reference = tvt.load_snapshot(path, device="cpu"), jcol
    else:
        tcol.snapshot(path)
        loaded, reference = jvt.load_snapshot(path), tcol
    assert loaded.count() == 80
    np.testing.assert_array_equal(np.asarray(loaded.get(ids[4]).vectors, np.float32),
                                  np.asarray(reference.get(ids[4]).vectors, np.float32))
    sets = _query_sets(toks, seed=10)
    _assert_same(_hits(loaded.multi_vector_search_batch(sets, limit=6)),
                 _hits(reference.multi_vector_search_batch(sets, limit=6)))


def test_token_block_state_feeds_the_fused_search():
    toks = _tokens(130, 4, 16, seed=11)
    jcol, tcol = _pair("inner_product", normalize="none")
    for col in (jcol, tcol):
        col.put_tokens(_ids(130, seed=11), toks)
    jcache = jcol._scan_cache()
    jtok, jcounts = jcache.multi_vectors()
    tokens, counts = convert.token_block_state(np.asarray(jtok), np.asarray(jcounts),
                                               device="cpu")
    assert jcache.mv_uniform and tokens.shape == (256, 4, 16)
    qtok, qmask = tcol._pad_query_sets(_query_sets(toks, seed=12))
    valid = torch.arange(256) < 130
    got = tms.fused_maxsim_topk_batch(tokens, counts, valid, torch.from_numpy(qtok),
                                      torch.from_numpy(qmask), metric="inner_product", limit=5)
    want = jvt.collection.maxsim_ops.maxsim_full_topk_batch(
        jtok, jcounts, jcache.valid_mask(), qtok, qmask, metric="inner_product", limit=5,
        chunk=256)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=TOL, atol=1e-6)
    with pytest.raises(tvt.errors.InvalidVector):
        convert.token_block_state(np.asarray(jtok), np.full(256, 5, np.int32), device="cpu")


def test_overflowing_scores_take_the_host_route():
    jcol, tcol = _pair("inner_product", normalize="none", d=2)
    for col in (jcol, tcol):
        col.put_many([{"id": f"p{i:03d}", "vectors": [[1.0, 1.0]]} for i in range(70)]
                     + [{"id": "big", "vectors": [[3e38, 3e38], [1.0, 0.0]]}])
    got = tcol.multi_vector_search_batch([[[1.0, -1.0]]], limit=3)
    want = jcol.multi_vector_search_batch([[[1.0, -1.0]]], limit=3)
    assert tcol.host_routes == 1
    assert _hits(got) == _hits(want)


def test_put_tokens_validation_matches_jax():
    errors = []
    for col in _pair("l2", d=8):
        caught = []
        for ids, toks in ((["a"], np.zeros((1, 2, 9), np.float32)),
                          (["a"], np.zeros((1, 8), np.float32)),
                          (["a", "b"], np.zeros((1, 2, 8), np.float32)),
                          ([""], np.zeros((1, 2, 8), np.float32)),
                          (["a"], np.full((1, 2, 8), np.nan, np.float32))):
            with pytest.raises(Exception) as info:
                col.put_tokens(ids, toks)
            caught.append(type(info.value).__name__)
        assert col.count() == 0
        errors.append(caught)
    assert errors[0] == errors[1]
