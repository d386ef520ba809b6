"""The port's hybrid pipelines (``Collection.hybrid_search`` and
``hybrid_search_batch``) against the JAX package's, on the CPU.

The same records and queries go through ``vettore_tpu.Collection`` and
``vettore_tpu_torch.Collection(device="cpu")``: a flat collection (its
``search`` generator on the fused K1/K2 route: capacity 1,024) and an HNSW
collection, each generator alone and in unions, with the ``exact`` and the
``multi_vector`` reranks. The same ids in the same order, scores within
1e-5 * max(1, |score|). Also the generator and rerank errors, the kernel
routes of the funnel and quantized generators (thresholds lowered in both
packages), and a tie spill that sends a batch query to the single-query
re-run in both packages.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
from vettore_tpu import errors as jerr
from vettore_tpu.ops import pipeline as jpipe
import vettore_tpu_torch as tvt
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch.ops import flat_scan as tfs
from vettore_tpu_torch.ops import pipeline as tpipe

torch.set_num_threads(2)

D, T = 16, 4
TOL = 1e-5


def _corpus(n, seed, d=D):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(max(1, n // 20), 1, d)).astype(np.float32)
    toks = centres[rng.integers(0, centres.shape[0], n)] + 0.4 * rng.normal(
        size=(n, T, d)).astype(np.float32)
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    queries = toks[rng.integers(0, n, 5), 0] + 0.3 * rng.normal(size=(5, d)).astype(np.float32)
    qsets = [(toks[i, : 1 + i % T] + 0.2 * rng.normal(size=(1 + i % T, d))).tolist()
             for i in rng.integers(0, n, 5)]
    return ids, toks, queries, qsets


def _pair(ids, toks, index="flat", metric="cosine", d=D, **kw):
    cols = (jvt.Collection(name="j", dimensions=d, metric=metric, index=index, **kw),
            tvt.Collection(name="t", dimensions=d, metric=metric, index=index, device="cpu",
                           **kw))
    for col in cols:
        if index == "flat":
            col.put_tokens(ids, toks)
        else:  # the host graph: records one by one, tokens kept
            col.put_many([{"id": i, "vectors": t.tolist()} for i, t in zip(ids, toks)])
    return cols


@pytest.fixture(scope="module")
def flat():
    ids, toks, queries, qsets = _corpus(600, seed=1)
    return _pair(ids, toks), queries, qsets


@pytest.fixture(scope="module")
def hnsw():
    ids, toks, queries, qsets = _corpus(300, seed=2)
    opts = {"m": 6, "m0": 12, "ef_construction": 32, "ef_search": 32}
    return _pair(ids, toks, index="hnsw", index_options=opts), queries, qsets


def _assert_same(got, want):
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert abs(g.score - w.score) <= TOL * max(1.0, abs(w.score)), (g, w)
            assert (g.distance is None) == (w.distance is None) and g.metric == w.metric


def _reruns(col, fn):
    """Calls ``fn`` and returns how many batch queries it re-ran alone
    (``_hybrid_fallback`` calls) in ``col``'s package."""
    calls = []
    real = type(col)._hybrid_fallback
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(col), "_hybrid_fallback",
                   lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
        return fn(), len(calls)


def _compare(cols, queries, single=2, **kw):
    """Batch and single-query results equal the JAX package's; returns the
    number of batch queries both packages re-ran alone (it must agree)."""
    jcol, tcol = cols
    got, t_reruns = _reruns(tcol, lambda: tcol.hybrid_search_batch(queries, **kw))
    want, j_reruns = _reruns(jcol, lambda: jcol.hybrid_search_batch(queries, **kw))
    _assert_same(got, want)
    assert t_reruns == j_reruns
    rerank = kw.pop("rerank", "exact")
    for b, q in enumerate(queries[:single]):
        r = rerank if rerank == "exact" else ("multi_vector", rerank[1][b]) + tuple(rerank[2:])
        _assert_same([tcol.hybrid_search(q.tolist(), rerank=r, **kw)],
                     [jcol.hybrid_search(q.tolist(), rerank=r, **kw)])
    return t_reruns


GENERATORS = [
    None,
    ["funnel"],
    ["quantized"],
    ["search"],
    ["funnel", "quantized", "search"],
    [("funnel", {"candidates": 25, "stages": [8, 16]}), ("quantized", {"candidates": 30})],
    [("search", {"candidates": 20}), ("funnel", {"dimensions": 8})],
]


@pytest.mark.parametrize("gens", GENERATORS)
def test_flat_exact_rerank_matches_jax(flat, gens):
    cols, queries, _qsets = flat
    assert _compare(cols, queries, limit=6, generators=gens) == 0


@pytest.mark.parametrize("gens", [None, ["search"], [("quantized", {"candidates": 40})]])
@pytest.mark.parametrize("opts", [(), ({"metric": "inner_product"},), ({"metric": "l2"},)])
def test_flat_multi_vector_rerank_matches_jax(flat, gens, opts):
    cols, queries, qsets = flat
    assert _compare(cols, queries, limit=5, generators=gens,
                    rerank=("multi_vector", qsets) + opts) == 0


def test_search_generator_takes_the_fused_kernels(flat):
    (_jcol, tcol), queries, _qsets = flat
    calls = []
    real = tfs.fused_flat_search
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfs, "fused_flat_search", lambda *a, **k: calls.append(1) or real(*a, **k))
        tcol.hybrid_search_batch(queries, limit=5, generators=["search"])
    assert calls == [1] and tcol.index._fused_eligible(64)


@pytest.mark.parametrize("gens", [None, [("hnsw", {"candidates": 40}),
                                        ("quantized", {"candidates": 40})], ["hnsw", "funnel"]])
def test_hnsw_hybrid_matches_jax(hnsw, gens):
    """With 300 records in 512 slots, a funnel of 50 candidates asks for
    more 8-row groups than hold records: its selection flags every query,
    and both packages re-run them alone."""
    cols, queries, qsets = hnsw
    assert cols[1]._default_generators() == ["hnsw", "quantized"]
    reruns = _compare(cols, queries, limit=5, generators=gens)
    assert reruns == (len(queries) if gens and "funnel" in gens else 0)
    _compare(cols, queries, limit=5, generators=gens, rerank=("multi_vector", qsets))


def test_kernel_routes_match_jax(monkeypatch):
    """The funnel's fused stage 1 (K5 + K7) and the quantized group cover
    (K6 + K7): thresholds lowered in both packages, 2,100 rows."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "_FUSED_STAGE_MIN", 2048)
        monkeypatch.setattr(mod, "_GROUP_COVER_MIN", 2048)
    ids, toks, queries, _qsets = _corpus(2100, seed=3, d=128)
    cols = _pair(ids, toks, d=128)
    calls = []
    for name in ("fused_stage_candidates", "fused_sign_scan"):
        real = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda *a, _r=real, _n=name, **k: calls.append(_n)
                            or _r(*a, **k))
    gens = [("funnel", {"candidates": 50}), ("quantized", {"candidates": 30})]
    assert _compare(cols, queries, single=1, limit=8, generators=gens) == 0
    assert {"fused_stage_candidates", "fused_sign_scan"} <= set(calls)


def _raises_like_jax(cols, call):
    jcol, tcol = cols
    with pytest.raises(jerr.VettoreError) as j:
        call(jcol)
    with pytest.raises(terr.VettoreError) as t:
        call(tcol)
    assert type(t.value).__name__ == type(j.value).__name__
    assert getattr(t.value, "reason", None) == getattr(j.value, "reason", None)


@pytest.mark.parametrize("kw", [
    dict(generators=[]),
    dict(generators="funnel"),
    dict(generators=["nope"]),
    dict(generators=[("funnel", {"bogus": 1})]),
    dict(generators=[("quantized", {"candidates": 0})]),
    dict(generators=[("search", {"candidates": True})]),
    dict(generators=[("funnel", {"stages": [0]})]),
    dict(generators=[["funnel", {}]]),
    dict(generators=["hnsw"]),
    dict(rerank="bogus"),
    dict(rerank=("multi_vector",)),
    dict(rerank=("multi_vector", [[[0.0] * D]], {"bogus": 1})),
    dict(rerank=("multi_vector", [[[0.0] * D]], {"metric": "nope"})),
    dict(rerank=("multi_vector", [[[1.0] * D]] * 3)),
    dict(rerank=("multi_vector", [[]] * 2)),
    dict(bogus=1),
    dict(limit=0),
])
def test_errors_match_jax(flat, kw):
    cols, queries, _qsets = flat
    _raises_like_jax(cols, lambda col: col.hybrid_search_batch(queries[:2], **kw))
    rerank = kw.get("rerank")
    if isinstance(rerank, tuple) and len(rerank) > 1:
        if len(rerank[1]) != 1:  # the batch's count check only
            return
        kw = {**kw, "rerank": ("multi_vector", rerank[1][0]) + rerank[2:]}
    _raises_like_jax(cols, lambda col: col.hybrid_search(queries[0].tolist(), **kw))


def test_empty_inputs_match_jax():
    cols = (jvt.Collection(name="j", dimensions=D), tvt.Collection(name="t", dimensions=D,
                                                                    device="cpu"))
    for col in cols:
        assert col.hybrid_search_batch([[0.5] * D]) == [[]]
        assert col.hybrid_search([0.5] * D) == []
        col.put({"id": "a", "vector": [1.0] * D})
        assert col.hybrid_search_batch(np.zeros((0, D))) == []


def test_tie_spill_reruns_the_query_in_both_packages(monkeypatch):
    """Half the corpus is one repeated vector: the funnel's stage-1 ranks
    tie past the selection's slack, its ``ok`` flag drops, and both packages
    re-run the query alone (whose funnel then scans on the host)."""
    rng = np.random.default_rng(4)
    n = 512
    data = rng.normal(size=(n, D)).astype(np.float32)
    data[: n // 2] = data[0]
    ids = [f"r-{i:04d}" for i in rng.permutation(n)]
    cols = (jvt.Collection(name="j", dimensions=D), tvt.Collection(name="t", dimensions=D,
                                                                    device="cpu"))
    for col in cols:
        col.put_matrix(ids, data)
    reruns = {}
    real = jvt.Collection._hybrid_fallback

    def counted(self, *a, **k):
        reruns[id(self)] = reruns.get(id(self), 0) + 1
        return real(self, *a, **k)

    monkeypatch.setattr(jvt.Collection, "_hybrid_fallback", counted)
    queries = np.stack([data[0] + 0.01 * rng.normal(size=D), rng.normal(size=D)])
    gens = [("funnel", {"candidates": 20})]
    jcol, tcol = cols
    _assert_same(tcol.hybrid_search_batch(queries, limit=5, generators=gens),
                 jcol.hybrid_search_batch(queries, limit=5, generators=gens))
    assert reruns[id(jcol)] >= 1
    # each re-run is one host route, and so is the host scan its funnel takes
    assert tcol.host_routes == 2 * reruns[id(jcol)]
