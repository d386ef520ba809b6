"""The port's HNSW host graph and batched beam search against the JAX
package's, on the CPU.

The same seeded numpy arrays go through ``vettore_tpu.index.hnsw`` and
``vettore_tpu_torch.index.hnsw``. Host code is copied, so levels, slot
order and host adjacency must be bit-equal. The beam runs on one graph in
both packages (a JAX ``DeviceGraph`` or ``BulkGraph`` carried across by
``convert.hnsw_graph_state``) and must give the same ids in the same order,
with raw scores within 1e-5 (f32 sums in another order), including on a
corpus of duplicated vectors where ranks tie exactly. Also: the wave build
and writes to a bulk graph, once refused as not ported yet, against the JAX
package's.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from vettore_tpu import errors as jerr
from vettore_tpu.index import hnsw as jhnsw
from vettore_tpu.index import hnsw_build as jbuild
from vettore_tpu.index import hnsw_device as jdev
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch.convert import hnsw_graph_state
from vettore_tpu_torch.index import hnsw as thnsw
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.index import hnsw_device as tdev

torch.set_num_threads(2)

RAW_TOL = 1e-5
PARAMS = {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 32}


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids(n, seed=0):
    """Ids of mixed lengths and scripts, in a shuffled order."""
    rng = np.random.default_rng(seed)
    out = [f"doc-{i:07d}" for i in range(n // 2)]
    out += [f"é-{i}" if i % 3 else f"{i}-ključ-{i * 7919}" for i in range(n - n // 2)]
    return [out[i] for i in rng.permutation(n)]


# ---------------------------------------------------------------------------
# host code: bit-equal
# ---------------------------------------------------------------------------


def test_fnv_and_levels_bit_equal_on_100k_ids():
    ids = _ids(100_000)
    for max_level in (12, 3):
        want = np.array([jhnsw.level_for(i, max_level) for i in ids], dtype=np.int32)
        np.testing.assert_array_equal(thnsw.levels_batch(ids, max_level), want)
    for i in ids[:2000]:
        assert thnsw.fnv1a_64(i.encode()) == jhnsw.fnv1a_64(i.encode())
        assert thnsw.level_for(i, 12) == jhnsw.level_for(i, 12)
    assert thnsw.levels_batch([], 12).shape == (0,)


def test_prep_order_bit_equal_on_100k_ids():
    ids = _ids(100_000, seed=1)
    got = tbuild._prep_order(ids, 12, len(ids))
    want = jbuild._prep_order(ids, 12, len(ids))
    assert got[0] == want[0]  # ids in slot order
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("options", [
    None, {"m": 8, "m0": 16}, {"traversal": "f32", "expand_w": 4, "build": "knn"},
    {"m": 0}, {"m0": 4}, {"ef_construction": 2}, {"ef_search": 0}, {"max_level": 65},
    {"expand_w": 300}, {"build": "magic"}, {"traversal": "f16"}, {"bogus": 1},
])
def test_validate_options_matches(options):
    try:
        want = jhnsw.validate_options(options)
    except jerr.InvalidHnswOptions:
        with pytest.raises(terr.InvalidHnswOptions):
            thnsw.validate_options(options)
        return
    assert thnsw.validate_options(options) == want


@pytest.mark.parametrize("metric", ["l2", "cosine", "inner_product"])
def test_host_inserts_give_identical_graphs(metric):
    rng = np.random.default_rng(3)
    data = _unit(rng, 300, 8) * rng.uniform(0.5, 2.0, (300, 1)).astype(np.float32)
    pairs = [(f"v{i:04d}", data[i]) for i in range(300)]
    j = jhnsw.HnswIndex(metric, PARAMS)
    t = thnsw.HnswIndex(metric, PARAMS, device="cpu")
    for index in (j, t):
        index.put_many(pairs[:200])
        for id, v in pairs[200:]:
            index.put(id, v)
        index.put("v0007", data[9])  # replace
        for id in ("v0003", "v0150", "v0299"):
            index.delete(id)
    assert t._connections == j._connections
    assert t._levels == j._levels and t._entry == j._entry and t._internal == j._internal
    q = _unit(rng, 5, 8).astype(np.float64)
    for qv in q:
        assert t.search(qv, 7) == j.search(qv, 7)  # below 2,048 nodes: the host search


# ---------------------------------------------------------------------------
# the beam on one graph
# ---------------------------------------------------------------------------


def _jax_search(g, q, *, ef, limit, traversal, hubs):
    bf16 = traversal == "bf16"
    kw = {}
    if hubs:
        slots, block = g.hubs(jnp.bfloat16 if bf16 else jnp.float32)
        kw = {"hub_slots": slots, "hub_x": block}
    ids, raws, ranks = jdev._search_kernel(
        g.x, g.a0, g.up_index, g.up_adj, g.lex_rank, g.entry_slot, g.entry_level,
        jnp.asarray(q), metric=g.metric, lmax=g.lmax, ef=ef, limit=limit,
        max_steps=jdev.step_bound(ef), xb=g.xb if bf16 else None, expand_w=8, **kw)
    return np.asarray(ids), np.asarray(raws), np.asarray(ranks)


def _torch_search(g, q, *, ef, limit, traversal, hubs):
    bf16 = traversal == "bf16"
    kw = {}
    if hubs:
        slots, block = g.hubs(torch.bfloat16 if bf16 else torch.float32)
        kw = {"hub_slots": slots, "hub_x": block, "hub_valid": g.hub_validity()}
    ids, raws, ranks = tdev.search_impl(
        g.x, g.a0, g.up_index, g.up_adj, g.lex_rank, g.entry_slot, g.entry_level,
        torch.from_numpy(q), metric=g.metric, lmax=g.lmax, ef=ef, limit=limit,
        max_steps=tdev.step_bound(ef), xb=g.xb if bf16 else None, expand_w=8,
        valid=g.valid, **kw)
    return ids.numpy(), raws.numpy(), ranks.numpy()


def _assert_same_results(jgraph, q, *, ef=32, limit=10, traversal="bf16", hubs=True):
    tgraph = hnsw_graph_state(jgraph, device="cpu")
    ji, jr, jk = _jax_search(jgraph, q, ef=ef, limit=limit, traversal=traversal, hubs=hubs)
    ti, tr, tk = _torch_search(tgraph, q, ef=ef, limit=limit, traversal=traversal, hubs=hubs)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jr)
    np.testing.assert_array_equal(np.isfinite(tr), fin)
    assert np.abs(tr[fin] - jr[fin]).max(initial=0.0) <= RAW_TOL
    np.testing.assert_array_equal(np.isfinite(tk), np.isfinite(jk))
    return ti


def _host_graph(metric, data, ids=None, params=PARAMS):
    index = jhnsw.HnswIndex(metric, params)
    index.put_many(zip(ids or [f"h{i:04d}" for i in range(len(data))], data))
    return jdev.DeviceGraph(index)


@pytest.fixture(scope="module")
def host_graphs():
    rng = np.random.default_rng(5)
    data = _unit(rng, 400, 16)
    q = _unit(rng, 24, 16)
    return {m: _host_graph(m, data) for m in ("cosine", "l2", "inner_product")}, q


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
@pytest.mark.parametrize("traversal", ["bf16", "f32"])
def test_beam_matches_on_a_host_graph(host_graphs, metric, traversal):
    graphs, q = host_graphs
    ids = _assert_same_results(graphs[metric], q, traversal=traversal)
    assert (ids >= 0).all()


@pytest.mark.parametrize("metric,traversal", [("cosine", "bf16"), ("l2", "f32")])
def test_greedy_descent_matches_without_hubs(host_graphs, metric, traversal):
    graphs, q = host_graphs
    _assert_same_results(graphs[metric], q, traversal=traversal, hubs=False)


def test_beam_matches_under_mass_ties():
    """60 distinct vectors, each stored 8 times under shuffled ids, and
    queries that equal stored vectors: every rank ties 8 ways, so the
    order rests on the lex tie-break and on every stable selection."""
    rng = np.random.default_rng(7)
    base = _unit(rng, 60, 16)
    data = np.repeat(base, 8, axis=0)
    ids = [f"t{i:04d}" for i in rng.permutation(len(data))]
    q = np.concatenate([base[:12], _unit(rng, 4, 16)])
    graph = _host_graph("cosine", data, ids)
    for traversal in ("bf16", "f32"):
        got = _assert_same_results(graph, q, ef=16, limit=12, traversal=traversal)
        # a query equal to a stored vector finds its 8 copies first, by id
        for b in range(12):
            top = [graph.ids[s] for s in got[b][:8]]
            assert top == sorted(top)


def test_index_search_batch_matches_above_the_device_threshold():
    """2,100 host inserts: both packages' ``search_batch`` take the device
    beam on the same host graph (the port's on the CPU)."""
    rng = np.random.default_rng(11)
    data = _unit(rng, 2100, 8)
    pairs = [(f"p{i:05d}", data[i]) for i in range(2100)]
    q = _unit(rng, 16, 8).astype(np.float64)
    j = jhnsw.HnswIndex("cosine", PARAMS)
    t = thnsw.HnswIndex("cosine", PARAMS, device="cpu")
    j.put_many(pairs)
    t.put_many(pairs)
    assert t._use_device() and j._use_device()
    want, got = j.search_batch(q, 10), t.search_batch(q, 10)
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        assert max(abs(g[1] - w[1]) for g, w in zip(grow, wrow)) <= RAW_TOL
    assert isinstance(t._device, tdev.DeviceGraph)
    assert [h[0] for h in t.search(q[0], 10)] == [h[0] for h in got[0]]
    slots, raws = t.search_batch_device(torch.from_numpy(q.astype(np.float32)), 10)
    assert [[t._device.ids[s] for s in row] for row in slots.tolist()] == \
        [[h[0] for h in row] for row in got]


def test_put_matrix_equals_put_many(monkeypatch):
    """The matrix path gives put_many's graph: bulk-built at the threshold
    (from the matrix as it is; with a repeated id through put_many, the
    last occurrence winning), host-built below it."""
    from vettore_tpu_torch.index import hnsw_knn_build as tknn

    monkeypatch.setattr(tknn, "MIN_NGB", 4)
    monkeypatch.setattr(tknn, "PROBES", 4)
    rng = np.random.default_rng(23)
    data = _unit(rng, 150, 8)
    ids = [f"r{i:03d}" for i in rng.permutation(150)]
    for n, threshold in ((150, 100), (150, 200), (40, 30)):
        rows, keys = data[:n], ids[:n]
        if n == 40:
            keys = keys[:-1] + [keys[0]]  # a repeated id: the last occurrence wins
        built = []
        for fill in ("put_matrix", "put_many"):
            index = thnsw.HnswIndex("cosine", {**PARAMS, "build": "knn"}, device="cpu")
            index.BULK_THRESHOLD = threshold
            if fill == "put_matrix":
                index.put_matrix(keys, rows)
            else:
                index.put_many(zip(keys, rows))
            built.append(index)
        a, b = built
        assert (a._bulk is None) == (b._bulk is None) == (n < threshold)
        if a._bulk is not None:
            assert a._bulk.ids == b._bulk.ids and torch.equal(a._bulk.a0, b._bulk.a0)
            assert torch.equal(a._bulk.x, b._bulk.x)
        else:
            assert a._connections == b._connections and a._internal == b._internal
    with pytest.raises(terr.InvalidVector):
        thnsw.HnswIndex("cosine", device="cpu").put_matrix(["a", "b"], np.zeros((3, 4)))


def test_chunks_do_not_change_results(monkeypatch):
    rng = np.random.default_rng(13)
    data = _unit(rng, 300, 8)
    t = thnsw.HnswIndex("l2", PARAMS, device="cpu")
    t.put_many((f"c{i:04d}", v) for i, v in enumerate(data))
    q = _unit(rng, 9, 8)
    whole = t.search_batch_device(torch.from_numpy(q), 5)
    monkeypatch.setattr(tdev, "_CHUNK_BYTES", 1)  # one query per chunk
    parts = t.search_batch_device(torch.from_numpy(q), 5)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# once refused as not ported yet: the wave build and writes to a bulk graph
# ---------------------------------------------------------------------------


def test_wave_build_is_not_ported_yet():
    """Ported now: ``build="wave"``, and ``"auto"`` below ``KNN_BUILD_MIN``,
    build the JAX package's wave graph (one wave at this size)."""
    data = _unit(np.random.default_rng(17), 64, 8)
    ids = [f"w{i}" for i in range(64)]
    want = jbuild.bulk_build("cosine", {**jhnsw.validate_options(PARAMS), "build": "wave"},
                             ids, data)
    for options in ({**PARAMS, "build": "wave"}, PARAMS):  # auto below KNN_BUILD_MIN: wave
        index = thnsw.HnswIndex("cosine", options, device="cpu")
        index.BULK_THRESHOLD = 2
        index.put_many(zip(ids, data))
        got = index._bulk
        assert got.ids == want.ids and len(index) == 64
        np.testing.assert_array_equal(got.a0.numpy(), np.asarray(want.a0))
        np.testing.assert_array_equal(got.up_adj.numpy(), np.asarray(want.up_adj))
        assert index.search(data[5].astype(np.float64), 1)[0][0] == "w5"


def test_mutating_a_bulk_graph_is_not_ported_yet(monkeypatch):
    """Ported now: put, put_many and delete on a kNN-built graph take the
    JAX package's incremental mutation, with its search results."""
    from vettore_tpu.index import hnsw_knn_build as jknn
    from vettore_tpu_torch.index import hnsw_knn_build as tknn

    for module in (jknn, tknn):
        monkeypatch.setattr(module, "MIN_NGB", 4)
        monkeypatch.setattr(module, "PROBES", 4)
    data = _unit(np.random.default_rng(19), 128, 8)
    indexes = (jhnsw.HnswIndex("cosine", {**PARAMS, "build": "knn"}),
               thnsw.HnswIndex("cosine", {**PARAMS, "build": "knn"}, device="cpu"))
    for index in indexes:
        index.BULK_THRESHOLD = 2
        index.put_many((f"b{i:03d}", v) for i, v in enumerate(data))
        assert index._bulk is not None and len(index) == 128
        index.put("new", -data[0])
        index.put_many([("new2", -data[1]), ("b002", -data[2])])
        index.delete("b001")
        index.delete("missing")  # a no-op
        assert index._bulk is not None and len(index) == 129
    jindex, index = indexes
    assert index.search(data[5].astype(np.float64), 1)[0][0] == "b005"
    assert index.search(-data[0].astype(np.float64), 1)[0][0] == "new"
    q = np.concatenate([data[:12], -data[:3]]).astype(np.float64)
    got, want = index.search_batch(q, 6), jindex.search_batch(q, 6)
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    assert "b001" not in {h[0] for row in got for h in row}
