"""The port's ``Collection`` and ``FlatIndex`` against the JAX package's, on
the CPU: the same records and queries through ``vettore_tpu`` and
``vettore_tpu_torch`` (``device="cpu"``) give identical ids in identical
order, scores within 1e-5, and identical slot layouts. Also: the overflow
and tie-spill host routes, snapshots written by either package loaded by the
other, and the state converters of ``vettore_tpu_torch.convert``.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu.index.flat import FlatIndex as JFlat
from vettore_tpu.ops import flat_scan as jfs
from vettore_tpu_torch import convert
from vettore_tpu_torch.index.flat import FlatIndex as TFlat
from vettore_tpu_torch.ops import flat_scan as tfs

torch.set_num_threads(2)

F32_MAX = 3.4028234663852886e38
D = 32
SCORE_TOL = 1e-5


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, D)).astype(np.float32)
    # ids out of insertion order, so the lex permutation is not the identity
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    queries = data[rng.integers(0, n, 6)] + 0.3 * rng.normal(size=(6, D)).astype(np.float32)
    return ids, data, queries


def _hits(results):
    return [[(r.id, r.score) for r in row] for row in results]


def _assert_same_hits(got, want):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, g), (_, w) in zip(grow, wrow):
            assert abs(g - w) <= SCORE_TOL * max(1.0, abs(w))


def _pair(metric, n, seed=0):
    """The same mutations applied to a JAX and a port collection."""
    ids, data, queries = _corpus(n, seed)
    cols = (jvt.Collection(name="j", dimensions=D, metric=metric, index="flat"),
            tvt.Collection(name="t", dimensions=D, metric=metric, index="flat", device="cpu"))
    half = n // 2
    for col in cols:
        col.put_many([{"id": i, "vector": v, "metadata": {"n": k}}
                      for k, (i, v) in enumerate(zip(ids[:half], data[:half]))])
        col.put_matrix(ids[half:], data[half:])
        col.delete(ids[1])
        col.delete(ids[-2])
        col.delete(ids[3])
        col.put({"id": ids[3], "vector": data[7].tolist()})  # refills a freed slot
    return cols, queries


# (metric, n): n = 3000 reaches the fused kernels (cap >= 1024) for the
# matmul metrics; n = 50, and the other metrics at any size, take the plain route
CASES = [("cosine", 3000), ("l2", 3000), ("inner_product", 3000),
         ("negative_inner_product", 3000), ("l2_squared", 3000), ("manhattan", 3000),
         ("chebyshev", 3000), ("cosine", 50), ("l2", 50), ("hamming", 50), ("jaccard", 50)]


@pytest.mark.parametrize("metric,n", CASES)
def test_collection_matches_jax(metric, n):
    (jcol, tcol), queries = _pair(metric, n)
    fused = tcol.index._fused_eligible(16)
    assert fused == jcol.index._fused_eligible(16) == (n >= 1024 and metric in tfs.FUSED_METRICS)

    assert tcol.count() == jcol.count() == n - 2
    assert sorted(e.id for e in tcol.all()) == sorted(e.id for e in jcol.all())
    for id in (jcol.all()[0].id, jcol.all()[-1].id):
        te, je = tcol.get(id), jcol.get(id)
        assert te.metadata == je.metadata
        assert np.asarray(te.vector, np.float32).tobytes() == np.asarray(je.vector, np.float32).tobytes()
    assert tcol.index._slot_of == jcol.index._slot_of

    _assert_same_hits(_hits(tcol.search_batch(queries, limit=10)),
                      _hits(jcol.search_batch(queries, limit=10)))
    for q in queries[:2]:
        _assert_same_hits([[(r.id, r.score) for r in tcol.search(q.tolist(), limit=7)]],
                          [[(r.id, r.score) for r in jcol.search(q.tolist(), limit=7)]])
    assert tcol.index.host_routes == 0

    qn = np.stack([tcol.prepare_query(q) for q in queries]).astype(np.float32)
    t_slots, t_raws = tcol.index.search_batch_device(torch.from_numpy(qn), 10)
    j_slots, j_raws = jcol.index.search_batch_device(qn, 10)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    j_raws = np.asarray(j_raws)
    assert (np.abs(t_raws.numpy() - j_raws) <= SCORE_TOL * np.maximum(1.0, np.abs(j_raws))).all()


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_bf16_storage_view_matches_jax(metric):
    (jcol, tcol), queries = _pair(metric, 3000, seed=1)
    qn = np.stack([tcol.prepare_query(q) for q in queries])
    jview, tview = jcol.index.storage_view("bf16"), tcol.index.storage_view("bf16")
    assert tview._device[0].dtype == torch.bfloat16
    assert tview._fused_eligible(16)
    _assert_same_hits(tview.search_batch(qn, 10), jview.search_batch(qn, 10))
    assert tview.host_routes == 0


def test_unported_features_raise():
    """Mesh sharding is ported: a flat collection on ``["cpu"] * 2`` answers
    as the single-device one, and a ``device=`` other than the mesh's first
    device raises. An unknown storage mode still raises."""
    from vettore_tpu_torch.parallel import MeshFlatIndex, make_mesh

    errors = tvt.errors
    mesh = make_mesh(["cpu"] * 2)
    rng = np.random.default_rng(2)
    data = rng.normal(size=(40, 4)).astype(np.float32)
    ids = [f"m-{i:02d}" for i in range(40)]
    col = tvt.Collection(dimensions=4, mesh=mesh)
    single = tvt.Collection(dimensions=4, device="cpu")
    for c in (col, single):
        c.put_matrix(ids, data)
    assert isinstance(col.index, MeshFlatIndex) and col.device == mesh.first
    got, want = col.search_batch(data[:3], limit=5), single.search_batch(data[:3], limit=5)
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    with pytest.raises(errors.VettoreError, match="first device"):
        tvt.Collection(dimensions=4, mesh=mesh, device="meta")
    with pytest.raises(errors.InvalidFlatOptions, match="unknown storage"):
        TFlat("cosine", storage="int4", device="cpu")


def test_cuda_default_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tvt.Collection(dimensions=4)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        TFlat("cosine")


# ---------------------------------------------------------------------------
# overflow and host routes (the cases of tests/test_flat.py, both packages)
# ---------------------------------------------------------------------------


def _both(metric):
    return JFlat(metric), TFlat(metric, device="cpu")


def test_fused_overflow_takes_host_route():
    for index in _both("inner_product"):
        pairs = [(f"p{i:04d}", [1.0, 1.0]) for i in range(1100)]
        pairs.append(("big", [F32_MAX, F32_MAX]))
        index.put_many(pairs)
        assert index._fused_eligible(4)
        res = index.search_batch(np.array([[2.0, -2.0]]), 4)
        assert dict(res[0]).get("big") == 0.0
    assert index.host_routes == 1


def test_deleted_overflow_row_stays_on_device():
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(1100, 4)).astype(np.float32)
    queries = rng.normal(size=(3, 4))
    results = []
    for index in _both("inner_product"):
        index.put_many((f"p{i:04d}", row) for i, row in enumerate(rows))
        index.put("big", [F32_MAX] * 4)
        index.delete("big")
        assert not index._host_x[~index._valid].astype(np.float32).any()
        index._host_search = lambda *a, **k: pytest.fail("took the host route")
        results.append(index.search_batch(queries, 5))
    assert [[h[0] for h in r] for r in results[0]] == [[h[0] for h in r] for r in results[1]]


def test_recoverable_overflow_on_plain_route():
    for index in _both("inner_product"):
        index.put_many([("big", [F32_MAX, F32_MAX]), ("small", [1.0, 1.0])])
        assert not index._fused_eligible(2)
        assert dict(index.search([2.0, -2.0], 2))["big"] == 0.0
    assert index.host_routes == 1


def test_genuine_overflow_errors():
    for index, err in zip(_both("l2_squared"), (jvt.errors.MetricOverflow,
                                                tvt.errors.MetricOverflow)):
        index.put("big", [1.0e20])
        with pytest.raises(err):
            index.search([0.0], 1)


def test_mass_tie_takes_host_route_and_keeps_lex_order():
    n, d = 2048, 8
    for index in _both("cosine"):
        index.put_many((f"doc-{i:05d}", [1.0] + [0.0] * (d - 1)) for i in range(n))
        assert index._fused_eligible(8)
        hits = index.search([1.0] + [0.0] * (d - 1), 8)
        assert [h[0] for h in hits] == [f"doc-{i:05d}" for i in range(8)]
    assert index.host_routes == 1


def test_partial_tie_within_slack_stays_on_device():
    rng = np.random.default_rng(99)
    data = rng.normal(size=(2048, 8)).astype(np.float32)
    data[100] = data[500] = data[900]  # 3-way tie, within slack
    for index in _both("l2"):
        index.put_many((f"doc-{i:05d}", data[i]) for i in range(2048))
        hits = index.search(data[900], 5)
        assert [h[0] for h in hits[:3]] == ["doc-00100", "doc-00500", "doc-00900"]
    assert index.host_routes == 0


# ---------------------------------------------------------------------------
# snapshots and state conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_round_trip_across_packages(direction, tmp_path):
    (jcol, tcol), queries = _pair("cosine", 1500, seed=2)
    path = str(tmp_path / "c.vsnap")
    if direction == "jax_to_torch":
        jcol.snapshot(path)
        loaded = tvt.load_snapshot(path, device="cpu")
        reference = jcol
    else:
        tcol.snapshot(path)
        loaded = jvt.load_snapshot(path)
        reference = tcol
    assert loaded.count() == reference.count()
    assert loaded.get(jcol.all()[0].id).metadata == reference.get(jcol.all()[0].id).metadata
    _assert_same_hits(_hits(loaded.search_batch(queries, limit=10)),
                      _hits(reference.search_batch(queries, limit=10)))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_flat_index_from_numpy_keeps_slots(storage):
    ids, data, queries = _corpus(2500, seed=3)
    jidx = JFlat("l2", storage=storage)
    jidx.put_matrix(ids, data)
    for id in ids[::7]:
        jidx.delete(id)
    tidx = convert.flat_index_from_numpy("l2", jidx._ids, np.asarray(jidx._host_x),
                                         jidx._valid, storage=storage, device="cpu")
    assert tidx._slot_of == jidx._slot_of
    assert tidx._host_x.tobytes() == np.asarray(jidx._host_x, np.float32).tobytes()
    t_slots, t_raws = tidx.search_batch_device(torch.from_numpy(queries), 10)
    j_slots, j_raws = jidx.search_batch_device(queries, 10)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))
    np.testing.assert_allclose(t_raws.numpy(), np.asarray(j_raws), rtol=SCORE_TOL, atol=SCORE_TOL)
    # later inserts reuse free slots, and both indexes stay searchable
    tidx.put("new", data[0])
    assert tidx._valid[tidx._slot_of["new"]] and not tidx._host_x[~tidx._valid].any()
    assert tidx.search(data[0], 1)[0][0] in ("new", ids[0])


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_flat_device_state_parity(storage):
    ids, data, queries = _corpus(2048, seed=4)
    jidx = JFlat("cosine", storage=storage)
    jidx.put_matrix(ids, data)
    jidx.delete(ids[5])
    jidx._sync_device()
    jx = jidx._device[0]
    jxsq, jbias, jlex = jidx._device_scan
    x, xsq, bias, lex_rank = convert.flat_device_state(
        np.asarray(jx), np.asarray(jxsq), np.asarray(jbias), np.asarray(jlex), device="cpu")
    assert x.dtype == (torch.bfloat16 if storage == "bf16" else torch.float32)
    assert xsq.shape == bias.shape == lex_rank.shape == (2048,)
    q = queries.astype(np.float32)
    want = jfs.fused_flat_search(jx, jxsq, jbias, jlex, q, metric="cosine", k=16)
    got = tfs.fused_flat_search(x, xsq, bias, lex_rank, torch.from_numpy(q),
                                metric="cosine", k=16)
    assert bool(got[3]) == bool(want[3]) is True
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=SCORE_TOL)
