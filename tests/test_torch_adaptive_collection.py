"""The port's funnel and quantized search modes through ``Collection``,
against the JAX package's, on the CPU.

The same records (ids inserted in a permuted order, so the scan cache does
NOT share the flat index's block and builds its own lex-sorted one) and the
same queries go through ``vettore_tpu.Collection`` and
``vettore_tpu_torch.Collection(device="cpu")``. Tolerances: the same ids in
the same order, scores within 1e-5 * max(1, |score|) (f32 summation order).
Also: the default routes and the kernel routes (thresholds lowered in both
packages), the device-output entry points, cache invalidation on mutation,
the shared-block route, and the host routes.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu.ops import pipeline as jpipe
from vettore_tpu_torch.ops import flat_scan as tfs
from vettore_tpu_torch.ops import pipeline as tpipe

torch.set_num_threads(2)

N, D = 4096, 128
SCORE_TOL = 1e-5


def _corpus(seed=0, n=N):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(16, D)).astype(np.float32)
    data = centres[rng.integers(0, 16, n)] + 0.4 * rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    queries = data[rng.integers(0, n, 6)] + 0.3 * rng.normal(size=(6, D)).astype(np.float32)
    return ids, data, queries


def _pair(metric, seed=0, sorted_ids=False):
    ids, data, queries = _corpus(seed)
    if sorted_ids:
        ids = sorted(ids)
    cols = (jvt.Collection(name="j", dimensions=D, metric=metric),
            tvt.Collection(name="t", dimensions=D, metric=metric, device="cpu"))
    for col in cols:
        col.put_matrix(ids, data)
    return cols, ids, data, queries


def _same(got, want):
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert abs(g.score - w.score) <= SCORE_TOL * max(1.0, abs(w.score))
            assert g.metric == w.metric and g.value == w.value


@pytest.fixture(params=["default", "kernel"])
def route(request, monkeypatch):
    if request.param == "kernel":
        for mod in (jpipe, tpipe):
            monkeypatch.setattr(mod, "_FUSED_STAGE_MIN", 2048)
            monkeypatch.setattr(mod, "_GROUP_COVER_MIN", 2048)
    return request.param


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_funnel_search_matches_jax(route, metric):
    (jcol, tcol), _ids, _data, queries = _pair(metric)
    opts = dict(limit=10, candidates=40, stages=[128])
    _same(tcol.funnel_search_batch(queries, **opts), jcol.funnel_search_batch(queries, **opts))
    for q in queries[:2]:
        _same([tcol.funnel_search(q.tolist(), **opts)], [jcol.funnel_search(q.tolist(), **opts)])
    # the default stages and candidates, and a multi-stage funnel
    _same(tcol.funnel_search_batch(queries), jcol.funnel_search_batch(queries))
    _same(tcol.funnel_search_batch(queries, limit=5, candidates=30, stages=[32, 64]),
          jcol.funnel_search_batch(queries, limit=5, candidates=30, stages=[32, 64]))
    assert tcol.host_routes == 0
    # permuted ids: the cache built its own block (the index never synced)
    index_block = tcol.index._device
    assert index_block is None or tcol._scan_cache()._x[0] is not index_block[0]


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_quantized_search_matches_jax(route, metric):
    (jcol, tcol), _ids, _data, queries = _pair(metric, seed=1)
    opts = dict(limit=10, candidates=100)
    _same(tcol.quantized_search_batch(queries, **opts),
          jcol.quantized_search_batch(queries, **opts))
    for q in queries[:2]:
        _same([tcol.quantized_search(q.tolist(), **opts)],
              [jcol.quantized_search(q.tolist(), **opts)])
    _same(tcol.quantized_search_batch(queries, limit=3),
          jcol.quantized_search_batch(queries, limit=3))
    assert tcol.host_routes == 0


def test_batch_device_and_results_from_device_match_jax(route):
    (jcol, tcol), _ids, _data, queries = _pair("cosine", seed=2)
    prepared = np.stack([tcol.prepare_query(q) for q in queries]).astype(np.float32)
    tq = torch.from_numpy(prepared)
    before = dict(tfs.LAUNCHES)
    t_out = tcol.funnel_search_batch_device(tq, limit=10, candidates=40, stages=[128])
    j_out = jcol.funnel_search_batch_device(prepared, limit=10, candidates=40, stages=[128])
    assert all(isinstance(t, torch.Tensor) for t in t_out)
    _same(tcol.results_from_device(t_out), jcol.results_from_device(j_out))
    t_out = tcol.quantized_search_batch_device(tq, limit=10, candidates=100)
    j_out = jcol.quantized_search_batch_device(prepared, limit=10, candidates=100)
    _same(tcol.results_from_device(t_out), jcol.results_from_device(j_out))
    np.testing.assert_array_equal(t_out[0].numpy(), np.asarray(j_out[0]))
    assert tfs.LAUNCHES == before  # CPU tensors: plain versions only


def test_results_from_device_gives_none_for_refused_rows():
    (_jcol, tcol), _ids, _data, queries = _pair("cosine", seed=2)
    prepared = np.stack([tcol.prepare_query(q) for q in queries[:3]]).astype(np.float32)
    slots, raws, ranks, ok = tcol.quantized_search_batch_device(torch.from_numpy(prepared))
    ok = ok.clone()
    ok[1] = False
    rows = tcol.results_from_device((slots, raws, ranks, ok))
    assert rows[1] is None and len(rows[0]) == len(rows[2]) == 10


def test_mutation_invalidates_the_cache():
    (jcol, tcol), ids, data, queries = _pair("cosine", seed=3)
    opts = dict(limit=10, candidates=50)
    first = tcol._scan_cache()
    _same(tcol.quantized_search_batch(queries, **opts),
          jcol.quantized_search_batch(queries, **opts))
    assert tcol._scan_cache() is first  # no mutation: the same cache
    top = tcol.quantized_search(queries[0].tolist(), **opts)[0].id
    for col in (jcol, tcol):
        col.delete(top)
        col.put({"id": "zz-new", "vector": queries[1].tolist()})
    assert tcol._scan_cache() is not first
    t_rows = tcol.quantized_search_batch(queries, **opts)
    _same(t_rows, jcol.quantized_search_batch(queries, **opts))
    _same(tcol.funnel_search_batch(queries, stages=[64, 128]),
          jcol.funnel_search_batch(queries, stages=[64, 128]))
    assert top not in {r.id for r in t_rows[0]}
    assert t_rows[1][0].id == "zz-new"


def test_sorted_ingest_shares_the_index_block():
    (jcol, tcol), _ids, _data, queries = _pair("l2", seed=4, sorted_ids=True)
    cache = tcol._scan_cache()
    assert cache._x[0] is tcol.index._device[0]
    _same(tcol.funnel_search_batch(queries, stages=[64, 128]),
          jcol.funnel_search_batch(queries, stages=[64, 128]))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_host_routes_match_device_routes(metric):
    (_jcol, tcol), _ids, _data, queries = _pair(metric, seed=5)
    cache = tcol._scan_cache()
    for q in queries[:2]:
        prepared = tcol.prepare_query(q)
        dev = tcol.funnel_search(q.tolist(), stages=[32, 128], candidates=30, limit=5)
        host = tcol._funnel_host(cache, prepared, [32, 128], 30, 5)
        assert [r.id for r in dev] == [r.id for r in host]
        np.testing.assert_allclose([r.score for r in dev], [r.score for r in host], atol=1e-5)
        dev = tcol.quantized_search(q.tolist(), candidates=60, limit=5)
        host = tcol._quantized_host(cache, prepared, 60, 5)
        assert [r.id for r in dev] == [r.id for r in host]
        np.testing.assert_allclose([r.score for r in dev], [r.score for r in host], atol=1e-5)
    assert tcol.host_routes == 4


def test_refused_queries_take_the_host_route(monkeypatch):
    (jcol, tcol), _ids, _data, queries = _pair("cosine", seed=6)
    real = tpipe.quantized_pipeline_batch

    def refuse_first(*args, **kwargs):
        top, raws, ranks, ok = real(*args, **kwargs)
        ok = ok.clone()
        ok[0] = False
        return top, raws, ranks, ok

    monkeypatch.setattr(tpipe, "quantized_pipeline_batch", refuse_first)
    got = tcol.quantized_search_batch(queries, limit=10, candidates=80)
    assert tcol.host_routes == 1
    _same(got, jcol.quantized_search_batch(queries, limit=10, candidates=80))


def test_adaptive_options_are_validated_like_jax():
    (jcol, tcol), _ids, _data, queries = _pair("cosine", seed=7)
    q = queries[0].tolist()
    for call, kwargs in (
        ("funnel_search", dict(candidates=5, limit=10)),
        ("funnel_search", dict(stages=[0])),
        ("funnel_search", dict(stages=[D + 1])),
        ("funnel_search", dict(bogus=1)),
        ("quantized_search", dict(candidates=True)),
        ("quantized_search", dict(limit=0)),
    ):
        with pytest.raises(jvt.errors.VettoreError) as jerr:
            getattr(jcol, call)(q, **kwargs)
        with pytest.raises(tvt.errors.VettoreError) as terr:
            getattr(tcol, call)(q, **kwargs)
        assert terr.value.reason == jerr.value.reason
    empty = tvt.Collection(dimensions=4, device="cpu")
    assert empty.funnel_search([1.0, 0, 0, 0]) == []
    assert empty.quantized_search_batch([[1.0, 0, 0, 0]]) == [[]]
    assert tcol.funnel_search_batch(np.zeros((0, D))) == []
