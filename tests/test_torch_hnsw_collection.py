"""``Collection(index="hnsw")`` of the port against the JAX package's, on
the CPU.

The same records and queries go through ``vettore_tpu.Collection`` and
``vettore_tpu_torch.Collection(device="cpu")`` with ``index="hnsw"``: a
small graph answered by the host search, a graph of more than 2,048 host
inserts answered by the device beam, and a bulk ingest through
``put_matrix`` (the kNN build, its thresholds shrunk in both packages).
The same ids in the same order, scores within 1e-5, also after writes to
the bulk graph. Also: option validation, snapshots, and the refusals of what
is not ported yet.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu import errors as jerr
from vettore_tpu.index import hnsw_knn_build as jknn
from vettore_tpu_torch.index import hnsw_knn_build as tknn
from vettore_tpu_torch.index.hnsw import HnswIndex

torch.set_num_threads(2)

D = 12
SCORE_TOL = 1e-5
OPTS = {"m": 6, "m0": 12, "ef_construction": 40, "ef_search": 40}


def _corpus(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(8, D)).astype(np.float32)
    data = centres[rng.integers(0, 8, n)] + 0.5 * rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    queries = data[rng.integers(0, n, 8)] + 0.2 * rng.normal(size=(8, D)).astype(np.float32)
    return ids, data, queries


def _cols(metric, options=OPTS):
    return (jvt.Collection(name="j", dimensions=D, metric=metric, index="hnsw",
                           index_options=options),
            tvt.Collection(name="t", dimensions=D, metric=metric, index="hnsw",
                           index_options=options, device="cpu"))


def _assert_same(got, want):
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert abs(g.score - w.score) <= SCORE_TOL * max(1.0, abs(w.score))
            assert g.metadata == w.metadata and g.value == w.value


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_small_graph_matches_jax(metric):
    """The host search (below 2,048 nodes), after inserts, deletes and a
    re-insert."""
    ids, data, queries = _corpus(300, seed=1)
    cols = _cols(metric)
    for col in cols:
        col.put_many([{"id": i, "vector": v, "metadata": {"k": k}}
                      for k, (i, v) in enumerate(zip(ids, data))])
        col.delete(ids[4])
        col.put({"id": ids[4], "vector": data[5].tolist()})
        col.delete(ids[9])
    jcol, tcol = cols
    assert tcol.count() == jcol.count() == 299
    assert len(tcol.index) == len(jcol.index) == 299
    _assert_same(tcol.search_batch(queries, limit=7), jcol.search_batch(queries, limit=7))
    _assert_same([tcol.search(queries[2].tolist(), limit=5)],
                 [jcol.search(queries[2].tolist(), limit=5)])


def test_device_beam_graph_matches_jax():
    """2,100 host inserts through ``put_matrix``: both packages answer by
    the batched beam on a snapshot of the same host graph."""
    ids, data, queries = _corpus(2100, seed=2)
    cols = _cols("cosine", {"m": 4, "m0": 8, "ef_construction": 16, "ef_search": 24})
    for col in cols:
        col.put_matrix(ids, data)
        assert col.index._bulk is None and col.index._use_device()
    jcol, tcol = cols
    _assert_same(tcol.search_batch(queries, limit=10), jcol.search_batch(queries, limit=10))
    qdev = torch.from_numpy(np.stack([tcol.prepare_query(q) for q in queries]))
    slots, raws = tcol.index.search_batch_device(qdev, 10)
    assert slots.shape == (8, 10) and raws.dtype == torch.float32
    want = jcol.search_batch(queries, limit=10)
    assert [[tcol.index._device.ids[s] for s in row] for row in slots.tolist()] == \
        [[r.id for r in row] for row in want]


@pytest.fixture
def small_knn(monkeypatch):
    for module in (jknn, tknn):
        monkeypatch.setattr(module, "MIN_NGB", 4)
        monkeypatch.setattr(module, "PROBES", 4)
        monkeypatch.setattr(module, "CHUNK_BLOCKS", 8)


def test_bulk_put_matrix_matches_jax(small_knn):
    ids, data, queries = _corpus(500, seed=3)
    cols = _cols("cosine", {**OPTS, "build": "knn"})
    for col in cols:
        col.index.BULK_THRESHOLD = 100
        col.put_matrix(ids, data)
        assert col.index._bulk is not None
    jcol, tcol = cols
    _assert_same(tcol.search_batch(queries, limit=10), jcol.search_batch(queries, limit=10))
    # the bulk graph takes further writes, as the JAX package's does: a new
    # record, a delete and re-insert, a delete, a missing id (a no-op)
    for col in cols:
        col.put({"id": "new", "vector": (-data[0]).tolist()})
        col.delete(ids[1])
        col.put({"id": ids[1], "vector": (-data[1]).tolist()})
        col.delete(ids[0])
        col.delete("never-stored")
        assert col.index._bulk is not None
    assert tcol.count() == jcol.count() == 500 == len(tcol.index)
    assert tcol.get("new").id == "new"
    q = np.concatenate([queries, -data[:2]])
    _assert_same(tcol.search_batch(q, limit=10), jcol.search_batch(q, limit=10))
    assert ids[0] not in {r.id for row in tcol.search_batch(q, limit=10) for r in row}


@pytest.mark.parametrize("options", [{"m": 0}, {"ef_search": 0}, {"traversal": "f16"},
                                     {"build": "magic"}, {"bogus": 1}])
def test_invalid_options_rejected_like_jax(options):
    with pytest.raises(jerr.InvalidHnswOptions):
        jvt.Collection(dimensions=4, index="hnsw", index_options=options)
    with pytest.raises(tvt.errors.InvalidHnswOptions):
        tvt.Collection(dimensions=4, index="hnsw", index_options=options, device="cpu")
    with pytest.raises(tvt.errors.UnsupportedHnswMetric):
        tvt.Collection(dimensions=4, index="hnsw", metric="manhattan", device="cpu")


def test_snapshot_restores_an_hnsw_collection(tmp_path):
    """A restore re-inserts the records in id order, so the graph differs
    from the written collection's; both packages restore the same one."""
    ids, data, queries = _corpus(200, seed=4)
    _jcol, tcol = _cols("cosine")
    tcol.put_matrix(ids, data)
    path = str(tmp_path / "hnsw.vsnap")
    tcol.snapshot(path)
    tloaded, jloaded = tvt.load_snapshot(path, device="cpu"), jvt.load_snapshot(path)
    assert tloaded.index_kind == jloaded.index_kind == "hnsw"
    assert isinstance(tloaded.index, HnswIndex) and tloaded.index.params == tcol.index.params
    _assert_same(tloaded.search_batch(queries, limit=5), jloaded.search_batch(queries, limit=5))


def test_unported_hnsw_features_raise():
    """Mesh sharding is ported: an HNSW collection on ``["cpu"] * 2`` finds
    each stored row first, and a ``device=`` other than the mesh's first
    device raises."""
    from vettore_tpu_torch.parallel import MeshHnswIndex, make_mesh

    mesh = make_mesh(["cpu"] * 2)
    ids, data, _queries = _corpus(200, seed=4)
    col = tvt.Collection(dimensions=data.shape[1], index="hnsw", mesh=mesh)
    col.put_matrix(ids, data)
    assert isinstance(col.index, MeshHnswIndex)
    hits = col.search_batch(data[:5], limit=3)
    assert [row[0].id for row in hits] == ids[:5]
    with pytest.raises(tvt.errors.VettoreError, match="first device"):
        tvt.Collection(dimensions=4, index="hnsw", mesh=mesh, device="meta")
