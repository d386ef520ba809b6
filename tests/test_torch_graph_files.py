"""HNSW graph files and ``Collection.attach_index`` in the port, against the
JAX package, on the CPU.

Both packages write one ``.npz`` layout (the same keys, dtypes and
``GRAPH_MAGIC``), read it with ``allow_pickle=False``, and search a loaded
graph as the graph they saved: a file written by either package loads in the
other with the same ids (raw scores within 1e-5 * max(1, |raw|)). The kNN
build's sizes are shrunk in both packages (``MIN_NGB``, ``PROBES``,
``CHUNK_BLOCKS``) so a 500-row graph takes the bulk build.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
from vettore_tpu import errors as jerr
from vettore_tpu.index import hnsw_build as jbuild
from vettore_tpu.index import hnsw_knn_build as jknn
from vettore_tpu.index.hnsw import HnswIndex as JHnsw
import vettore_tpu_torch as tvt
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.index import hnsw_knn_build as tknn
from vettore_tpu_torch.index.hnsw import HnswIndex as THnsw

torch.set_num_threads(2)

N, D = 500, 12
OPTS = {"m": 6, "m0": 12, "ef_construction": 40, "ef_search": 40, "build": "knn"}
TOL = 1e-5


@pytest.fixture(autouse=True)
def small_knn(monkeypatch):
    for module in (jknn, tknn):
        monkeypatch.setattr(module, "MIN_NGB", 4)
        monkeypatch.setattr(module, "PROBES", 4)
        monkeypatch.setattr(module, "CHUNK_BLOCKS", 8)


def _data(seed=3, n=N):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"id-{i:04d}" for i in rng.permutation(n)]
    queries = data[rng.integers(0, n, 8)] + 0.05 * rng.normal(size=(8, D)).astype(np.float32)
    return ids, data, queries


def _bulk(cls, metric="cosine", seed=3, **kw):
    ids, data, queries = _data(seed)
    index = cls(metric, OPTS, **kw)
    index.BULK_THRESHOLD = 100
    index.put_many(zip(ids, data))
    assert index._bulk is not None
    return index, queries


def _same_hits(got, want):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, g), (_, w) in zip(grow, wrow):
            assert abs(g - w) <= TOL * max(1.0, abs(w)), (g, w)


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_port_round_trip(tmp_path, metric):
    index, queries = _bulk(THnsw, metric, device="cpu")
    path = str(tmp_path / "g.npz")
    index.save_graph(path)
    assert not list(tmp_path.glob("*.tmp"))  # the tmp file was renamed into place
    loaded = THnsw.load_graph(metric, OPTS, path, device="cpu")
    g, h = index._bulk, loaded._bulk
    assert (h.ids, h.n, h.m, h.m0, h.lmax, h.metric, h.entry_slot, h.entry_level) == \
        (g.ids, g.n, g.m, g.m0, g.lmax, g.metric, g.entry_slot, g.entry_level)
    for name in ("x", "a0", "up_index", "up_adj", "lex_rank"):
        assert torch.equal(getattr(h, name), getattr(g, name)), name
    np.testing.assert_array_equal(h.levels, g.levels)
    assert h.valid is None and len(loaded) == len(index) == N
    assert loaded.search_batch(queries, 5) == index.search_batch(queries, 5)
    # without the vector block: the caller's block, shared, not copied
    index.save_graph(path, include_x=False)
    shared = THnsw.load_graph(metric, OPTS, path, x_device=g.x, device="cpu")
    assert shared._bulk.x is g.x
    assert shared.search_batch(queries, 5) == index.search_batch(queries, 5)


def test_load_refusals_match_jax(tmp_path):
    tindex, _q = _bulk(THnsw, device="cpu")
    no_x = str(tmp_path / "no_x.npz")
    tindex.save_graph(no_x, include_x=False)
    bogus = str(tmp_path / "bogus.npz")
    np.savez(bogus, magic=np.array("something-else"))
    for path in (no_x, bogus):
        with pytest.raises(ValueError):
            jbuild.load_graph(path)
        with pytest.raises(ValueError):
            tbuild.load_graph(path, device="cpu")
    with pytest.raises(ValueError, match="row count"):
        tbuild.load_graph(no_x, x_device=tindex._bulk.x[:10], device="cpu")
    with_x = str(tmp_path / "x.npz")
    tindex.save_graph(with_x)
    with pytest.raises(jerr.UnsupportedHnswMetric):
        JHnsw.load_graph("l2", OPTS, with_x)
    with pytest.raises(terr.UnsupportedHnswMetric):
        THnsw.load_graph("l2", OPTS, with_x, device="cpu")
    # only bulk-built graphs save
    host = THnsw("cosine", OPTS, device="cpu")
    host.put("a", [1.0] * D)
    with pytest.raises(terr.VettoreError) as err:
        host.save_graph(str(tmp_path / "h.npz"))
    assert err.value.reason == "not_bulk_built"
    with pytest.raises(jerr.VettoreError):
        JHnsw("cosine", OPTS).save_graph(str(tmp_path / "h.npz"))


def test_files_cross_between_the_packages(tmp_path):
    jindex, queries = _bulk(JHnsw)
    tindex, _q = _bulk(THnsw, device="cpu")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jindex.save_graph(jpath)
    tindex.save_graph(tpath)
    with np.load(jpath, allow_pickle=False) as jz, np.load(tpath, allow_pickle=False) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for key in jz.files:
            assert (jz[key].dtype, jz[key].shape) == (tz[key].dtype, tz[key].shape), key
        for key in ("magic", "ids", "n", "m", "m0", "lmax", "metric", "levels", "lex_rank",
                    "up_index", "entry_slot", "entry_level", "lex_spacing"):
            np.testing.assert_array_equal(jz[key], tz[key])
    # a JAX file searched by the port, a port file searched by JAX
    port_of_jax = THnsw.load_graph("cosine", OPTS, jpath, device="cpu")
    jax_of_port = JHnsw.load_graph("cosine", OPTS, tpath)
    _same_hits(port_of_jax.search_batch(queries, 7), jindex.search_batch(queries, 7))
    _same_hits(jax_of_port.search_batch(queries, 7), tindex.search_batch(queries, 7))
    slots, _raws = port_of_jax.search_batch_device(torch.from_numpy(
        queries / np.linalg.norm(queries, axis=1, keepdims=True)), 7)
    assert slots.dtype == torch.int64 and slots.shape == (8, 7)


def test_a_file_with_tombstones_loads_its_mask(tmp_path):
    """A JAX file carrying ``valid`` loads as a mask (with the mutation
    bookkeeping rebuilt from it), and its searches skip the deleted ids as
    JAX's do."""
    jindex, queries = _bulk(JHnsw)
    ids, _data_, _q = _data()
    gone = set(ids[:25])
    for i in gone:
        jindex.delete(i)
    path = str(tmp_path / "dead.npz")
    jindex.save_graph(path)
    with np.load(path) as z:
        assert "valid" in z.files and int((~z["valid"]).sum()) == len(gone)
    loaded = THnsw.load_graph("cosine", OPTS, path, device="cpu")
    assert loaded._bulk.valid is not None and len(loaded) == N - len(gone)
    got = loaded.search_batch(queries, 7)
    assert not gone & {h[0] for row in got for h in row}
    _same_hits(got, JHnsw.load_graph("cosine", OPTS, path).search_batch(queries, 7))
    # saved again, the mask survives
    loaded.save_graph(str(tmp_path / "again.npz"))
    with np.load(str(tmp_path / "again.npz")) as z:
        np.testing.assert_array_equal(z["valid"], np.load(path)["valid"])


def _flat_pair():
    ids, data, queries = _data()
    cols = (jvt.Collection(name="j", dimensions=D, metric="cosine"),
            tvt.Collection(name="t", dimensions=D, metric="cosine", device="cpu"))
    for col in cols:
        col.put_matrix(ids, data)
    return cols, queries


def test_attach_index_sets_the_kind_and_serves_the_hnsw_generator(tmp_path):
    (jcol, tcol), queries = _flat_pair()
    jindex, _q = _bulk(JHnsw)
    path = str(tmp_path / "g.npz")
    jindex.save_graph(path)
    assert tcol.index_kind == "flat" and tcol._default_generators() == ["funnel", "quantized"]
    with pytest.raises(terr.HnswIndexRequired):
        tcol.hybrid_search_batch(queries, generators=["hnsw"])
    jcol.attach_index(JHnsw.load_graph("cosine", OPTS, path))
    tcol.attach_index(THnsw.load_graph("cosine", OPTS, path, device="cpu"))
    assert tcol.index_kind == jcol.index_kind == "hnsw"
    assert tcol._config()["index"] == "hnsw"
    gens = [("hnsw", {"candidates": 40}), ("quantized", {"candidates": 40})]
    for got, want in zip(tcol.hybrid_search_batch(queries, limit=6, generators=gens),
                         jcol.hybrid_search_batch(queries, limit=6, generators=gens)):
        assert [r.id for r in got] == [r.id for r in want]
        assert all(abs(g.score - w.score) <= TOL for g, w in zip(got, want))
    assert tcol.host_routes == 0


def test_attach_index_refusals_match_jax():
    (jcol, tcol), _queries = _flat_pair()
    small_j, small_t = JHnsw("cosine", OPTS), THnsw("cosine", OPTS, device="cpu")
    for index in (small_j, small_t):
        index.put("a", [1.0] * D)
    cases = ((jcol, small_j, jerr.InvalidIndex), (tcol, small_t, terr.InvalidIndex),
             (jcol, object(), jerr.InvalidIndex), (tcol, object(), terr.InvalidIndex))
    for col, index, err in cases:
        with pytest.raises(err):
            col.attach_index(index)
        assert col.index_kind == "flat"
    flat = tvt.FlatIndex("cosine", device="cpu")
    ids, data, _q = _data()
    flat.put_matrix(ids, data)
    tcol.attach_index(flat)
    assert tcol.index_kind == "flat" and tcol.index is flat
