"""The port's kNN bulk build (``index/hnsw_knn_build.py``) against the JAX
package's, on the CPU.

Both packages build from the same seeded corpus at the JAX tests' size
(640 x 16, with ``MIN_NGB``, ``PROBES`` and ``CHUNK_BLOCKS`` shrunk by
assignment in both, as ``tests/test_hnsw_knn_build.py`` shrinks them).
Levels, slot order, lex ranks and ``up_index`` must be bit-equal. The
adjacency may differ only in rows where f32 sums taken in another order
swap neighbours whose float64 ranks to the row lie within 1e-6; recall@10
of the two graphs within 0.01. The beam on the JAX graph, carried across by
``convert.hnsw_graph_state``, gives the JAX package's ids. On a mesh
shard's corpus of sparse clusters (10,240 x 64, clusters of 25 rows) the
two graphs agree as above and both fall short of the 0.95 recall bar.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from vettore_tpu.index import hnsw_device as jdev
from vettore_tpu.index import hnsw_knn_build as jknn
from vettore_tpu.index.hnsw import HnswIndex as JaxHnsw
from vettore_tpu_torch.convert import hnsw_graph_state
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.index import hnsw_device as tdev
from vettore_tpu_torch.index import hnsw_knn_build as tknn
from vettore_tpu_torch.index.hnsw import HnswIndex as TorchHnsw

torch.set_num_threads(2)

OPTS = {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 64, "build": "knn"}
N, D = 640, 16
NEAR_TIE = 1e-6


def _clustered(n, d, centers, seed):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    rows = c[rng.integers(0, centers, n)] + (0.25 / np.sqrt(d)) * rng.normal(
        size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows


@pytest.fixture(scope="module")
def small_buckets():
    saved = [(m, m.MIN_NGB, m.PROBES, m.CHUNK_BLOCKS) for m in (jknn, tknn)]
    for m in (jknn, tknn):
        m.MIN_NGB, m.PROBES, m.CHUNK_BLOCKS = 4, 4, 8
    yield
    for m, ngb, probes, chunk in saved:
        m.MIN_NGB, m.PROBES, m.CHUNK_BLOCKS = ngb, probes, chunk


def _build_both(metric, data, ids):
    j = JaxHnsw(metric, OPTS)
    t = TorchHnsw(metric, OPTS, device="cpu")
    for index in (j, t):
        index.BULK_THRESHOLD = 2
        index.put_many(zip(ids, data))
        assert index._bulk is not None
    return j, t


@pytest.fixture(scope="module")
def built(small_buckets):
    data = _clustered(N, D, 24, seed=5)
    ids = [f"id-{i:05d}" for i in range(N)]
    return (*_build_both("cosine", data, ids), ids, data)


def _f64_rank(metric, a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    if metric == "l2":
        return float(np.sqrt(np.sum((a - b) ** 2)))
    return 1.0 - float(a @ b) if metric == "cosine" else -float(a @ b)


def _assert_graphs_agree(metric, jg, tg):
    assert tg.ids == jg.ids
    np.testing.assert_array_equal(tg.levels, jg.levels)
    np.testing.assert_array_equal(tg.lex_rank.numpy(), np.asarray(jg.lex_rank))
    np.testing.assert_array_equal(tg.up_index.numpy(), np.asarray(jg.up_index))
    assert (tg.n, tg.lmax, tg.entry_slot, tg.entry_level) == (
        jg.n, jg.lmax, int(jg.entry_slot), int(jg.entry_level))
    x = np.asarray(jg.x)
    np.testing.assert_array_equal(tg.x.numpy(), x)
    rows = [(np.asarray(jg.a0), tg.a0.numpy())]
    up_j, up_t = np.asarray(jg.up_adj), tg.up_adj.numpy()
    assert up_j.shape == up_t.shape
    rows += [(up_j[:, layer], up_t[:, layer]) for layer in range(up_j.shape[1])]
    for want, got in rows:
        for slot in np.flatnonzero((want != got).any(axis=1)):
            # a differing row: the same number of neighbours, and the
            # neighbours that differ are f64 near-ties of each other
            a, b = set(want[slot][want[slot] >= 0]), set(got[slot][got[slot] >= 0])
            assert len(a) == len(b), (slot, want[slot], got[slot])
            ra = sorted(_f64_rank(metric, x[slot], x[s]) for s in a - b)
            rb = sorted(_f64_rank(metric, x[slot], x[s]) for s in b - a)
            assert np.allclose(ra, rb, rtol=0, atol=NEAR_TIE), (slot, ra, rb)


def _recall(index, ids, data, q):
    gt = np.argsort(-(q @ data.T), axis=1)[:, :10]
    hits = index.search_batch(q.astype(np.float64), 10)
    return np.mean([len({h[0] for h in row} & {ids[j] for j in gt[i]}) / 10
                    for i, row in enumerate(hits)])


def test_graph_matches_jax(built):
    j, t, ids, data = built
    _assert_graphs_agree("cosine", j._bulk, t._bulk)
    rng = np.random.default_rng(11)
    q = data[:128] + 0.03 * rng.normal(size=(128, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rec_t, rec_j = _recall(t, ids, data, q), _recall(j, ids, data, q)
    assert abs(rec_t - rec_j) <= 0.01 and rec_t >= 0.9


@pytest.mark.parametrize("metric", ["l2", "inner_product"])
def test_other_metrics_match_jax(small_buckets, metric):
    data = _clustered(320, D, 12, seed=9)
    ids = [f"m-{i:04d}" for i in np.random.default_rng(2).permutation(320)]
    j, t = _build_both(metric, data, ids)
    _assert_graphs_agree(metric, j._bulk, t._bulk)


def test_mass_ties_match_jax(small_buckets):
    """80 distinct rows stored 8 times each under shuffled ids. The beam on
    the JAX graph gives the JAX ids, every tie resting on the lex
    tie-breaks. The two builds agree on slots, levels and ranks, and their
    searches on the same queries agree; their adjacency may differ more
    than elsewhere, since the heuristic compares the ranks between copies
    of one row (0 in float64, a few 1e-8 either side in f32 sums of
    another order)."""
    rng = np.random.default_rng(4)
    data = np.repeat(_clustered(80, D, 10, seed=8), 8, axis=0)
    ids = [f"t-{i:04d}" for i in rng.permutation(len(data))]
    j, t = _build_both("cosine", data, ids)
    jg, tg = j._bulk, t._bulk
    assert tg.ids == jg.ids and np.array_equal(tg.levels, jg.levels)
    np.testing.assert_array_equal(tg.lex_rank.numpy(), np.asarray(jg.lex_rank))
    q = np.concatenate([data[::64], _clustered(6, D, 3, seed=1)])
    want = [[h[0] for h in row] for row in j.search_batch(q.astype(np.float64), 12)]
    assert [[h[0] for h in row] for row in t.search_batch(q.astype(np.float64), 12)] == want
    for row in want[:10]:  # a stored row's 8 copies come first, by id
        assert row[:8] == sorted(row[:8])
    on_jax_graph = hnsw_graph_state(jg, device="cpu")
    slots = tdev.search_impl(
        on_jax_graph.x, on_jax_graph.a0, on_jax_graph.up_index, on_jax_graph.up_adj,
        on_jax_graph.lex_rank, 0, on_jax_graph.entry_level, torch.from_numpy(q),
        metric="cosine", lmax=on_jax_graph.lmax, ef=64, limit=12,
        max_steps=tdev.step_bound(64), xb=on_jax_graph.xb,
        hub_slots=on_jax_graph.hubs()[0], hub_x=on_jax_graph.hubs()[1], expand_w=8)[0]
    jslots = np.asarray(j.search_batch_device(jnp.asarray(q), 12)[0])
    np.testing.assert_array_equal(slots.numpy(), jslots)


def test_adjacency_invariants(built):
    _j, t, _ids, _data = built
    g = t._bulk
    a0 = g.a0.numpy()
    assert a0.shape == (g.n, g.m0)
    for i in range(g.n):
        row = a0[i][a0[i] >= 0]
        assert len(set(row.tolist())) == len(row) and i not in row.tolist()
        assert (row < g.n).all()
    assert (np.diff(g.levels) <= 0).all()  # level-descending slot order
    cap_up = int((g.levels >= 1).sum())
    np.testing.assert_array_equal(g.up_index.numpy()[:cap_up], np.arange(cap_up))
    assert (g.up_index.numpy()[cap_up:] == -1).all()


def test_deterministic(built):
    _j, t, ids, data = built
    again = TorchHnsw("cosine", OPTS, device="cpu")
    again.BULK_THRESHOLD = 2
    again.put_many(zip(ids, data))
    assert torch.equal(again._bulk.a0, t._bulk.a0)
    assert torch.equal(again._bulk.up_adj, t._bulk.up_adj)


def test_beam_matches_on_the_jax_bulk_graph(built):
    j, _t, _ids, data = built
    jg = j._bulk
    tg = hnsw_graph_state(jg, device="cpu")
    assert isinstance(tg, tbuild.BulkGraph) and tg.live == jg.n
    q = data[::37] + 0.05 * np.random.default_rng(3).normal(size=(18, D)).astype(np.float32)
    for bf16 in (True, False):
        hubs = jg.hubs(jnp.bfloat16 if bf16 else jnp.float32)
        ji, jr, _ = jdev._search_kernel(
            jg.x, jg.a0, jg.up_index, jg.up_adj, jg.lex_rank, jg.entry_slot, jg.entry_level,
            jnp.asarray(q), metric="cosine", lmax=jg.lmax, ef=64, limit=10,
            max_steps=jdev.step_bound(64), xb=jg.xb if bf16 else None, hub_slots=hubs[0],
            hub_x=hubs[1], expand_w=8)
        th = tg.hubs(torch.bfloat16 if bf16 else torch.float32)
        ti, tr, _ = tdev.search_impl(
            tg.x, tg.a0, tg.up_index, tg.up_adj, tg.lex_rank, tg.entry_slot, tg.entry_level,
            torch.from_numpy(q), metric="cosine", lmax=tg.lmax, ef=64, limit=10,
            max_steps=tdev.step_bound(64), xb=tg.xb if bf16 else None, hub_slots=th[0],
            hub_x=th[1], expand_w=8)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-5


def test_auto_routes_by_scale(monkeypatch, small_buckets):
    calls = {"knn": 0}
    real = tknn.bulk_build_knn

    def spy(*a, **k):
        calls["knn"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tknn, "bulk_build_knn", spy)
    monkeypatch.setattr(tbuild, "KNN_BUILD_MIN", 64)
    data = _clustered(128, D, 8, seed=3)
    index = TorchHnsw("cosine", {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 32},
                      device="cpu")
    index.BULK_THRESHOLD = 2
    index.put_many((f"a-{i:04d}", v) for i, v in enumerate(data))
    assert calls["knn"] == 1 and index._bulk is not None


def _sparse_clusters(n, d, per, seed):
    """Unit rows in Gaussian clusters of ``per`` rows on average (sigma
    0.4/sqrt(d), ``chip_smoke.py``'s generator) and 128 queries near
    rows."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n // per, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    x = c[rng.integers(0, len(c), n)] + (0.4 / np.sqrt(d)) * rng.standard_normal(
        (n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 128)] + (0.1 / np.sqrt(d)) * rng.standard_normal(
        (128, d)).astype(np.float32)
    return x, q / np.linalg.norm(q, axis=1, keepdims=True)


def test_sparse_clusters_fall_short_in_both_packages(small_buckets):
    """A mesh shard's rows: clusters of 25 rows, smaller than a 64-row
    block and more of them than blocks (each shard of a clustered corpus
    holds a fraction of every cluster). With config 2's options both
    packages build the same kNN graph, and its recall@10 falls short of the
    0.95 bar in both, equal within 0.01: the shortfall is the build's, not
    the port's. A fix of the build turns the last assertion."""
    opts = {"m": 16, "m0": 32, "ef_construction": 100, "ef_search": 64, "build": "knn"}
    x, q = _sparse_clusters(10_240, 64, 25, seed=5)
    ids = [f"s-{i:05d}" for i in range(len(x))]
    t, j = TorchHnsw("cosine", opts, device="cpu"), JaxHnsw("cosine", opts)
    for index in (t, j):
        index.BULK_THRESHOLD = 2
        index.put_many(zip(ids, x))
    _assert_graphs_agree("cosine", j._bulk, t._bulk)
    rec_t, rec_j = _recall(t, ids, x, q), _recall(j, ids, x, q)
    assert abs(rec_t - rec_j) <= 0.01
    assert rec_t < 0.95 and rec_j < 0.95, (rec_t, rec_j)
