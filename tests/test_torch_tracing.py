"""The port's spans and counters (``vettore_tpu_torch/observability.py``) on
the CPU.

With no profiler recording, a search records nothing and builds no span,
``record_function`` or ``_RecordFunctionFast`` object, and answers as it
does under a profiler. Under ``torch.profiler.profile``: a flat collection's
``search_batch`` records its root, the Collection's validate / normalize /
hydrate spans, the index's span and its three device reads; each self time
lies between 0 and its total, and a parent's self time is its total less
its children's; the spans are CPU events of the profiler's trace (not user
annotations) inside the caller's ``record_function``, and ranges of
``trace()``'s Chrome trace. The HNSW beam counts its steps (at most
``step_bound``) and the nodes it scored; ``sharded_search`` on a CPU mesh
records one ``mesh.launch`` and one ``mesh.wait`` per shard a call, and
counts its norm passes (``mesh.norms``): one a shard on a block's first
call, 0 on the next; a hybrid call's query token checks count their
per-token fallbacks (``collection.token_fallbacks``). A funnel or
quantized batch call records its candidate stage, rerank, four reads and
hydration, and counts the queries it sends to the host route
(``adaptive.fallbacks``); the hybrid path records none of these. A new
profiling session starts an empty registry; every recorded name is
declared; ``Collection.stats()`` keeps its meaning with and without a
profiler; threads' spans add up.
"""

import glob
import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import vettore_tpu_torch as vt
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch import observability as obs
from vettore_tpu_torch.index import hnsw_device
from vettore_tpu_torch.ops import mmr
from vettore_tpu_torch.ops import pipeline as pipe
from vettore_tpu_torch.parallel import make_mesh, sharded_search

torch.set_num_threads(2)

D = 16


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _vectors(n, seed=0, d=D):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def flat():
    col = vt.Collection(name="flat", dimensions=D, index="flat", metric="cosine", device="cpu")
    x = _vectors(300)
    col.put_matrix([f"r{i:03d}" for i in range(300)], x)
    return col, x


@pytest.fixture(scope="module")
def hnsw():
    # past 2,048 nodes a host-inserted graph searches on the batched beam
    n = 2100
    col = vt.Collection(name="hnsw", dimensions=D, index="hnsw", metric="cosine", device="cpu")
    x = _vectors(n, seed=1)
    col.put_matrix([f"h{i:04d}" for i in range(n)], x)
    assert col.index._use_device()
    return col, x


def _cpu_blocks(shards, rows=1024):
    mesh = make_mesh(["cpu"] * shards)
    x = _vectors(shards * rows, seed=2)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    blocks = (mesh.shard_rows(x), mesh.shard_rows(np.ones(len(x), dtype=bool)),
              mesh.shard_rows(np.arange(len(x), dtype=np.int32)))
    return mesh, blocks, x


def _hits(answers):
    return [[(r.id, r.score) for r in row] for row in answers]


@pytest.fixture(scope="module")
def colbert():
    """A ColBERT-shaped HNSW collection: documents of 4 token rows by
    ``put_tokens``, its primary vectors their means."""
    n, t = 300, 4
    tokens = np.random.default_rng(3).normal(size=(n, t, D)).astype(np.float32)
    col = vt.Collection(name="colbert", dimensions=D, index="hnsw", metric="cosine",
                        normalize="none", device="cpu")
    col.put_tokens([f"c{i:03d}" for i in range(n)], tokens)
    return col, tokens


#: the hybrid generators of BASELINE config 5
COLBERT_GENS = [("hnsw", {"candidates": 40}), ("quantized", {"candidates": 40})]


def _colbert_call(colbert, b, rerank="multi_vector", limit=10):
    """One ``hybrid_search_batch`` of ``b`` query sets (each a document's
    tokens plus noise, its primary row their mean) and ``mmr_rerank_batch``
    of its hits; returns the hits and the picks."""
    col, tokens = colbert
    sets = tokens[:b] + 0.1 * np.random.default_rng(b).normal(size=tokens[:b].shape)
    sets = sets.astype(np.float32)
    hits = col.hybrid_search_batch(
        sets.mean(axis=1), limit=limit, generators=COLBERT_GENS,
        rerank=("multi_vector", [list(s) for s in sets]) if rerank == "multi_vector" else rerank)
    vecs = np.stack([[col.get(r.id).vector for r in row] for row in hits])
    picks = mmr.mmr_rerank_batch([[(r.id, r.score) for r in row] for row in hits], vecs,
                                 metric="cosine", alpha=0.5, final_k=5, device="cpu")
    return hits, picks


def test_no_profiler_records_nothing_and_answers_the_same(flat):
    col, x = flat
    obs.reset()
    plain = col.search_batch(x[:8], limit=5)
    assert obs.snapshot() == {"spans": {}, "counters": {}}
    assert not obs.tracing()
    with _profiler():
        assert obs.tracing()
        traced = col.search_batch(x[:8], limit=5)
    assert _hits(plain) == _hits(traced)


def test_no_span_or_profiler_range_is_built_without_a_profiler(flat, hnsw, monkeypatch):
    made = []

    fast = obs._RecordFunctionFast

    def counted_fast(*args, **kwargs):
        made.append("fast")
        return fast(*args, **kwargs)

    class CountedSpan(obs._Span):
        __slots__ = ()

        def __init__(self, name):
            made.append(name)
            super().__init__(name)

    def counted_record_function(*args, **kwargs):
        made.append("record_function")
        return record_function(*args, **kwargs)

    monkeypatch.setattr(obs, "_RecordFunctionFast", counted_fast)
    monkeypatch.setattr(obs, "_Span", CountedSpan)
    monkeypatch.setattr(torch.profiler, "record_function", counted_record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted_record_function)
    mesh, blocks, xm = _cpu_blocks(2)

    def searches():
        flat[0].search_batch(flat[1][:4], limit=3)
        flat[0].search(flat[1][0], limit=3)
        hnsw[0].search_batch(hnsw[1][:4], limit=3)
        sharded_search(mesh, *blocks, xm[:4], metric="cosine", k=3)

    obs.reset()
    searches()
    assert made == [] and obs.snapshot() == {"spans": {}, "counters": {}}
    with _profiler():
        searches()
    assert "fast" in made and "record_function" not in made


def test_flat_search_batch_spans(flat):
    col, x = flat
    with _profiler():
        col.search_batch(x[:8], limit=5)
    spans = obs.snapshot()["spans"]
    for name in ("collection.search_batch", "index.search_batch", "index.validate",
                 "index.assemble", "collection.validate", "collection.normalize",
                 "collection.hydrate"):
        assert spans[name]["count"] == 1, name
    # slots, raws and the ok flags: the index's three host reads
    assert spans["index.wait"]["count"] == 3
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    root = spans["collection.search_batch"]
    children = sum(spans[n]["total_s"] for n in ("collection.validate", "collection.normalize",
                                                 "index.search_batch", "collection.hydrate"))
    assert root["self_s"] == pytest.approx(root["total_s"] - children, abs=1e-9)
    index = spans["index.search_batch"]
    inner = sum(spans[n]["total_s"] for n in ("index.validate", "index.wait", "index.assemble"))
    assert index["self_s"] == pytest.approx(index["total_s"] - inner, abs=1e-9)


def test_serial_search_spans(flat):
    col, x = flat
    with _profiler():
        for q in x[:3]:
            col.search(q, limit=4)
    spans = obs.snapshot()["spans"]
    for name in ("collection.search", "index.search", "index.validate", "index.assemble",
                 "collection.validate", "collection.normalize", "collection.hydrate"):
        assert spans[name]["count"] == 3, name
    assert spans["index.wait"]["count"] == 9
    assert "collection.search_batch" not in spans


def test_spans_are_cpu_events_inside_the_callers_range(flat):
    col, x = flat
    with _profiler() as prof:
        with record_function("caller"):
            col.search_batch(x[:4], limit=3)
    mine = [e for e in prof.events() if e.name in obs.SPANS]
    assert {e.name for e in mine} >= {"collection.search_batch", "index.wait", "index.search_batch"}
    for e in mine:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation, e.name
        parent = e.cpu_parent
        while parent is not None and parent.name != "caller":
            parent = parent.cpu_parent
        assert parent is not None, e.name
    caller = [e for e in prof.events() if e.name == "caller"]
    assert len(caller) == 1 and caller[0].is_user_annotation


def test_trace_writes_the_spans_into_its_chrome_trace(flat, tmp_path):
    col, x = flat
    with obs.trace(str(tmp_path)):
        col.search_batch(x[:4], limit=3)
    (path,) = glob.glob(str(tmp_path / "*.json"))
    events = json.loads(open(path).read())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e.get("name") in obs.SPANS]
    assert names.count("index.wait") == 3 and names.count("collection.search_batch") == 1
    assert obs.snapshot()["spans"]["collection.search_batch"]["count"] == 1


def test_hnsw_counts_steps_and_nodes(hnsw):
    col, x = hnsw
    index = col.index
    with _profiler():
        col.search_batch(x[:8] + 0.01, limit=5)
    snap = obs.snapshot()
    ef = min(max(index.params["ef_search"], 5), len(x))
    w = index.params.get("expand_w") or hnsw_device.EXPAND_W
    steps = snap["counters"]["hnsw.steps"]
    assert 0 < steps <= hnsw_device.step_bound(ef, w)
    # each step scores at most W * m0 fresh neighbours a query
    assert 0 < snap["counters"]["hnsw.nodes"] <= 8 * steps * min(w, ef) * index.params["m0"]
    spans = snap["spans"]
    assert spans["index.search_batch"]["count"] == 1 and spans["index.assemble"]["count"] == 1
    # the convergence reads every _DONE_EVERY steps, then slots and raws
    reads = spans["index.wait"]["count"]
    assert 2 < reads <= 2 + steps // hnsw_device._DONE_EVERY + 1


def test_hnsw_nodes_are_counted_only_while_tracing(hnsw, monkeypatch):
    col, x = hnsw
    calls = []
    monkeypatch.setattr(hnsw_device, "count", lambda *a: calls.append(a))
    col.search_batch(x[:4], limit=5)
    assert [name for name, _n in calls] == ["hnsw.steps"]
    calls.clear()
    with _profiler():
        col.search_batch(x[:4], limit=5)
    assert [name for name, _n in calls] == ["hnsw.steps", "hnsw.nodes"]
    assert isinstance(calls[1][1], torch.Tensor)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_search_launch_per_shard(shards):
    mesh, blocks, x = _cpu_blocks(shards)
    calls = 3
    with _profiler():
        for c in range(calls):
            sharded_search(mesh, *blocks, x[4 * c:4 * c + 4], metric="cosine", k=5)
    spans = obs.snapshot()["spans"]
    assert spans["mesh.search"]["count"] == calls
    assert spans["mesh.launch"]["count"] == shards * calls
    # shards of 1,024 rows run the fused search, whose ok flag the host reads
    assert spans["mesh.wait"]["count"] == shards * calls
    root = spans["mesh.search"]
    assert root["self_s"] == pytest.approx(
        root["total_s"] - spans["mesh.launch"]["total_s"] - spans["mesh.wait"]["total_s"],
        abs=1e-9)


def test_mesh_norms_count_the_norm_passes_while_tracing():
    """``mesh.norms`` counts the norm passes a call runs, only under a
    profiler: one a shard on the first call over a block, 0 (recorded) on a
    second over the same unchanged block, nothing without a profiler."""
    assert "mesh.norms" in obs.COUNTERS
    mesh, blocks, x = _cpu_blocks(2)
    with _profiler():
        sharded_search(mesh, *blocks, x[:4], metric="cosine", k=5)
    assert obs.snapshot()["counters"]["mesh.norms"] == 2
    with _profiler():
        sharded_search(mesh, *blocks, x[4:8], metric="cosine", k=5)
    assert obs.snapshot()["counters"]["mesh.norms"] == 0
    obs.reset()
    mesh, blocks, x = _cpu_blocks(2)
    sharded_search(mesh, *blocks, x[:4], metric="cosine", k=5)
    assert "mesh.norms" not in obs.snapshot()["counters"]


#: each span of the hybrid path a call, by rerank: the rerank's outputs
#: and the generators' ok flags are one host read each
HYBRID_SPANS = {
    "multi_vector": {"collection.hybrid_search_batch": 1, "collection.validate": 1,
                     "collection.normalize": 1, "collection.validate_tokens": 1,
                     "hybrid.hnsw": 1, "hybrid.quantized": 1, "hybrid.union": 1,
                     "hybrid.rerank": 1, "hybrid.wait": 4, "collection.hydrate": 1,
                     "mmr.rerank": 1},
    "exact": {"collection.hybrid_search_batch": 1, "collection.validate": 1,
              "collection.normalize": 1, "hybrid.hnsw": 1, "hybrid.quantized": 1,
              "hybrid.union": 1, "hybrid.rerank": 1, "hybrid.wait": 5,
              "collection.hydrate": 1, "mmr.rerank": 1},
}


@pytest.mark.parametrize("rerank", sorted(HYBRID_SPANS))
def test_hybrid_spans_per_call(colbert, rerank):
    calls = 3
    obs.reset()
    plain = [_colbert_call(colbert, 4, rerank) for _ in range(calls)]
    assert obs.snapshot() == {"spans": {}, "counters": {}}
    with _profiler():
        traced = [_colbert_call(colbert, 4, rerank) for _ in range(calls)]
    assert [(_hits(h), p) for h, p in plain] == [(_hits(h), p) for h, p in traced]
    spans = obs.snapshot()["spans"]
    hybrid = {n: s["count"] for n, s in spans.items()
              if n.startswith(("hybrid.", "mmr.", "collection."))}
    assert hybrid == {n: calls * c for n, c in HYBRID_SPANS[rerank].items()}
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    rerank_span, waits = spans["hybrid.rerank"], spans["hybrid.wait"]
    assert rerank_span["total_s"] >= waits["total_s"]
    # the beam's own reads and steps lie inside the hnsw generator's span
    assert spans["index.wait"]["total_s"] <= spans["hybrid.hnsw"]["total_s"]
    assert "index.search_batch" not in spans


def test_hybrid_funnel_and_search_generators_have_their_spans(flat):
    col, x = flat
    with _profiler():
        col.hybrid_search_batch(x[:4], limit=3, generators=["funnel", "search"])
    spans = obs.snapshot()["spans"]
    assert spans["hybrid.funnel"]["count"] == 1 and spans["hybrid.search"]["count"] == 1
    assert "hybrid.hnsw" not in spans and "hybrid.quantized" not in spans


#: each span of a funnel or quantized batch call: the pipeline's candidate
#: stage and rerank, one host read of each of its four outputs, one hydration
ADAPTIVE_SPANS = {"collection.validate": 1, "collection.normalize": 1,
                  "adaptive.candidates": 1, "adaptive.rerank": 1, "adaptive.wait": 4,
                  "collection.hydrate": 1}


@pytest.mark.parametrize("mode", ["quantized", "funnel"])
def test_adaptive_spans_per_call(flat, mode):
    col, x = flat
    call = getattr(col, f"{mode}_search_batch")
    calls = 3
    obs.reset()
    plain = [_hits(call(x[i:i + 4], limit=3, candidates=20)) for i in range(calls)]
    assert obs.snapshot() == {"spans": {}, "counters": {}}
    with _profiler():
        traced = [_hits(call(x[i:i + 4], limit=3, candidates=20)) for i in range(calls)]
    assert plain == traced
    snap = obs.snapshot()
    spans = snap["spans"]
    assert {n: s["count"] for n, s in spans.items()} == {
        f"collection.{mode}_search_batch": calls,
        **{n: calls * c for n, c in ADAPTIVE_SPANS.items()}}
    assert snap["counters"] == {"adaptive.fallbacks": 0}
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
    inside = sum(spans[n]["total_s"] for n in ADAPTIVE_SPANS)
    assert inside <= spans[f"collection.{mode}_search_batch"]["total_s"]


@pytest.mark.parametrize("mode", ["quantized", "funnel"])
def test_adaptive_fallbacks_count_host_routes(flat, mode, monkeypatch):
    """A query the device pipeline flags takes the host route: the counter
    reads 1, as ``host_routes`` moves, and the route lies outside the
    batch's hydration."""
    col, x = flat
    name = f"{mode}_pipeline_batch"
    real = getattr(pipe, name)

    def refuse_first(*args, **kwargs):
        top, raws, ranks, ok = real(*args, **kwargs)
        ok = ok.clone()
        ok[0] = False
        return top, raws, ranks, ok

    want = _hits(getattr(col, f"{mode}_search_batch")(x[:4], limit=3, candidates=20))
    monkeypatch.setattr(pipe, name, refuse_first)
    routes = col.host_routes
    with _profiler():
        got = _hits(getattr(col, f"{mode}_search_batch")(x[:4], limit=3, candidates=20))
    snap = obs.snapshot()
    assert col.host_routes - routes == 1
    assert snap["counters"]["adaptive.fallbacks"] == 1
    assert snap["spans"]["collection.hydrate"]["count"] == 1
    assert [[i for i, _s in row] for row in got] == [[i for i, _s in row] for row in want]


def test_hybrid_records_no_adaptive_span(colbert, flat):
    """The hybrid path calls the pipeline's generators and rerank itself: it
    records none of the funnel and quantized calls' spans or counter."""
    with _profiler():
        _colbert_call(colbert, 4)
        _colbert_call(colbert, 4, rerank="exact")
        flat[0].hybrid_search_batch(flat[1][:4], limit=3, generators=["funnel", "quantized"])
    snap = obs.snapshot()
    assert not [n for n in (*snap["spans"], *snap["counters"]) if n.startswith("adaptive.")]
    assert snap["spans"]["hybrid.funnel"]["count"] == 1
    assert snap["spans"]["hybrid.quantized"]["count"] == 3


def test_hybrid_candidates_count_the_union(colbert, monkeypatch):
    seen = []
    real = pipe.union_candidates

    def kept(blocks):
        out = real(blocks)
        seen.append(int(out[1].sum()))
        return out

    monkeypatch.setattr(pipe, "union_candidates", kept)
    with _profiler():
        _colbert_call(colbert, 4)
        _colbert_call(colbert, 6)
    snap = obs.snapshot()
    assert len(seen) == 2 and snap["counters"]["hybrid.candidates"] == sum(seen)
    # each query keeps at least one generator's candidates
    assert sum(seen) >= (4 + 6) * 40
    assert snap["counters"]["hybrid.reruns"] == 0


def test_token_fallbacks_count_the_per_token_loop(colbert):
    """``collection.token_fallbacks`` reads 0 for a batch of ndarray token
    sets (the block path) and 1 for the same batch with one token a list of
    floats (the per-token loop); both give the same answers."""
    col, tokens = colbert
    sets = [list(s) for s in tokens[:4] + 0.1 * np.random.default_rng(4).normal(
        size=tokens[:4].shape).astype(np.float32)]
    listed = [list(s) for s in sets]
    listed[2][1] = [float(v) for v in listed[2][1]]
    answers = []
    for query_sets, fallbacks in ((sets, 0), (listed, 1)):
        with _profiler():
            answers.append(_hits(col.hybrid_search_batch(
                np.stack([np.mean(s, axis=0) for s in sets]), limit=5,
                generators=COLBERT_GENS, rerank=("multi_vector", query_sets))))
        assert obs.snapshot()["counters"]["collection.token_fallbacks"] == fallbacks
    assert answers[0] == answers[1]


def test_hybrid_reruns_follow_host_routes():
    """Half the corpus is one repeated vector: the funnel's stage-1 ranks
    tie past the selection's slack, and the batch query re-runs alone."""
    rng = np.random.default_rng(4)
    n = 512
    data = rng.normal(size=(n, D)).astype(np.float32)
    data[: n // 2] = data[0]
    col = vt.Collection(name="spill", dimensions=D, device="cpu")
    col.put_matrix([f"r-{i:04d}" for i in rng.permutation(n)], data)
    queries = np.stack([data[0] + 0.01 * rng.normal(size=D), rng.normal(size=D)])
    gens = [("funnel", {"candidates": 20})]
    plain = col.hybrid_search_batch(queries, limit=5, generators=gens)
    routes = col.host_routes
    with _profiler():
        traced = col.hybrid_search_batch(queries, limit=5, generators=gens)
    snap = obs.snapshot()
    assert _hits(plain) == _hits(traced)
    reruns = snap["counters"]["hybrid.reruns"]
    # each re-run is one host route, and so is the host scan its funnel takes
    assert reruns >= 1 and col.host_routes - routes == 2 * reruns == routes
    # the re-run lies outside the batch's hydration
    assert snap["spans"]["collection.hydrate"]["count"] == 1


def test_a_new_session_starts_empty(flat):
    col, x = flat
    with _profiler():
        col.search_batch(x[:4], limit=3)
        col.search_batch(x[4:8], limit=3)
    assert obs.snapshot()["spans"]["collection.search_batch"]["count"] == 2
    col.search_batch(x[:4], limit=3)
    col.search(x[0], limit=3)
    with _profiler():
        col.search_batch(x[:4], limit=3)
    spans = obs.snapshot()["spans"]
    assert spans["collection.search_batch"]["count"] == 1
    assert spans["index.wait"]["count"] == 3 and "collection.search" not in spans


def test_every_recorded_name_is_declared(flat, hnsw, colbert):
    mesh, blocks, xm = _cpu_blocks(2)
    with _profiler():
        flat[0].search_batch(flat[1][:4], limit=3)
        flat[0].search(flat[1][0], limit=3)
        hnsw[0].search(hnsw[1][0], limit=3)
        hnsw[0].search_batch(hnsw[1][:4], limit=3)
        sharded_search(mesh, *blocks, xm[:4], metric="cosine", k=3)
        _colbert_call(colbert, 4)
        flat[0].hybrid_search_batch(flat[1][:4], limit=3, generators=["funnel", "search"])
        flat[0].quantized_search_batch(flat[1][:4], limit=3)
    snap = obs.snapshot()
    assert set(snap["spans"]) <= set(obs.SPANS)
    # the beam's captured graphs exist on CUDA devices only (the card tests
    # count them)
    assert set(snap["counters"]) == set(obs.COUNTERS) - {"hnsw.replays", "hnsw.captures"}
    assert len(set(obs.SPANS)) == len(obs.SPANS)


def test_undeclared_names_are_refused():
    with pytest.raises(KeyError):
        obs.span("index.nothing")
    with pytest.raises(KeyError):
        obs.observed("nothing")
    obs.count("hnsw.nothing")  # no profiler: the flag test alone
    with _profiler():
        with pytest.raises(KeyError):
            obs.span("index.nothing")
        with pytest.raises(KeyError):
            obs.count("hnsw.nothing")


def test_span_as_decorator_and_counter():
    @obs.span("index.assemble")
    def work(n):
        obs.count("hnsw.steps", n)
        obs.count("hnsw.nodes", torch.tensor(n))
        return n

    assert work(2) == 2
    with _profiler():
        assert work(3) == 3 and work(4) == 4
    snap = obs.snapshot()
    assert snap["spans"]["index.assemble"]["count"] == 2
    assert snap["counters"] == {"hnsw.steps": 7, "hnsw.nodes": 7}
    assert obs.snapshot()["counters"] == {"hnsw.steps": 7, "hnsw.nodes": 7}


def test_collection_stats_keep_their_meaning(flat):
    col, x = flat
    before = col.stats().get("search_batch", {"count": 0, "errors": 0})
    col.search_batch(x[:2], limit=3)
    with _profiler():
        col.search_batch(x[:2], limit=3)
        with pytest.raises(terr.DimensionMismatch):
            col.search_batch(x[:2, :4], limit=3)
    after = col.stats()["search_batch"]
    assert after["count"] == before["count"] + 3
    assert after["errors"] == before["errors"] + 1
    spans = obs.snapshot()["spans"]
    # the failed call closes its root span too
    assert spans["collection.search_batch"]["count"] == 2
    assert spans["collection.validate"]["count"] == 2


def test_threads_spans_add_up():
    threads, each = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    barrier = threading.Barrier(threads, timeout=60)

    def work(_):
        barrier.wait()
        for _ in range(each):
            with obs.span("mesh.launch"):
                with obs.span("mesh.wait"):
                    obs.count("hnsw.steps")
        return True

    try:
        with _profiler():
            with ThreadPoolExecutor(threads) as pool:
                done = list(pool.map(work, range(threads), timeout=120))
    finally:
        sys.setswitchinterval(old)
    assert done == [True] * threads
    snap = obs.snapshot()
    assert snap["spans"]["mesh.launch"]["count"] == threads * each
    assert snap["spans"]["mesh.wait"]["count"] == threads * each
    assert snap["counters"]["hnsw.steps"] == threads * each
    launch, wait = snap["spans"]["mesh.launch"], snap["spans"]["mesh.wait"]
    assert launch["self_s"] == pytest.approx(launch["total_s"] - wait["total_s"], abs=1e-6)


def test_documentation_example_runs():
    import doctest

    result = doctest.testmod(obs, optionflags=doctest.ELLIPSIS)
    assert result.failed == 0 and result.attempted > 0
