"""The port's sharded HNSW and IVF (``parallel/hnsw_mesh.py``,
``parallel/ivf_mesh.py``) against the JAX package's and the single-device
port, on the CPU.

HNSW: on an integer-grid corpus (every rank exact in f32, ties in masses)
both packages build the same shard graphs (adjacency, global lex and row
planes, entries) in waves of 64 and return the same hits; a JAX
``ShardedHnsw`` on random unit vectors, carried across by
``convert.sharded_hnsw_state``, returns JAX's ids in order with raws within
1e-5. Collections: the cases of ``tests/test_mesh_collection.py`` (self
hits, overlap with the single-device graph, tiny shards, deletes,
incremental ingest, a replace, a forced compaction of one shard, the hnsw
hybrid generator).

IVF: at full probe a mesh collection equals the single-device port's and
JAX's mesh collection (ids in order, scores within 1e-5); a JAX
``ShardedIvf`` carried across by ``convert.sharded_ivf_state`` returns
JAX's ids at n_probe 1 and 2 (raws within 1e-5); ``n_probe="auto"``,
deletes and snapshots on a mesh.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu.parallel import ShardedHnsw as JShardedHnsw
from vettore_tpu.parallel import make_mesh as jmake_mesh
from vettore_tpu.parallel.ivf_mesh import ShardedIvf as JShardedIvf
from vettore_tpu_torch import convert
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.parallel import MeshHnswIndex, ShardedFlat, ShardedHnsw, make_mesh
from vettore_tpu_torch.parallel.ivf_mesh import MeshIvfIndex, ShardedIvf

torch.set_num_threads(2)

D = 16
HNSW_OPTS = {"m": 4, "m0": 8, "ef_construction": 24, "ef_search": 40}


def _jmesh():
    return jmake_mesh(jax.devices()[:2])


def _unit(n, seed):
    x = np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_hits(got, want, tol=1e-5):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for g_row, w_row in zip(got, want):
        for (_, g), (_, w) in zip(g_row, w_row):
            assert abs(g - w) <= tol * max(1.0, abs(w))


# ---------------------------------------------------------------------------
# ShardedHnsw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_grid_shard_graphs_equal_jax(metric, monkeypatch):
    """Waves of 64 (JAX's ``VETTORE_BUILD_WAVE``, the port's
    ``_wave_width``) over 2 shards of 128 grid rows: the same graphs, planes
    and hits in both packages."""
    monkeypatch.setenv("VETTORE_BUILD_WAVE", "64")
    monkeypatch.setattr(tbuild, "_wave_width", lambda n: 64)
    rng = np.random.default_rng(11)
    data = rng.integers(-3, 4, size=(256, D)).astype(np.float32)
    ids = [f"g-{i:04d}" for i in rng.permutation(256)]
    opts = dict(HNSW_OPTS, build="wave", ef_construction=8)
    jsh = JShardedHnsw(metric, _jmesh(), ids, data, options=opts)
    tsh = ShardedHnsw(metric, make_mesh(["cpu"] * 2), ids, data, options=opts)
    for s in range(2):
        g = tsh._graphs[s]
        n = g.n
        np.testing.assert_array_equal(g.a0[:n].numpy(), np.asarray(jsh._a0[s])[:n])
        np.testing.assert_array_equal(tsh._lex[s].numpy(), np.asarray(jsh._lex[s])[:n])
        np.testing.assert_array_equal(tsh._rows[s].numpy(), np.asarray(jsh._rows[s])[:n])
        assert (g.entry_slot, g.entry_level) == tuple(int(v) for v in np.asarray(jsh._entries[s]))
    q = data[rng.integers(0, 256, 6)] + rng.integers(-1, 2, size=(6, D)).astype(np.float32)
    _assert_hits(tsh.search_batch(q, 10), jsh.search_batch(q, 10))


@pytest.fixture(scope="module")
def jax_hnsw():
    data = _unit(300, 5)
    ids = [f"doc-{i:03d}" for i in range(300)]
    jsh = JShardedHnsw("cosine", _jmesh(), ids, data, options=HNSW_OPTS)
    q = data[np.random.default_rng(6).integers(0, 300, 8)]
    return jsh, q, jsh.search_batch(q, 10)


@pytest.mark.parametrize("data", [1, 2])
def test_carried_sharded_hnsw_searches_as_jax(jax_hnsw, data):
    jsh, q, want = jax_hnsw
    mesh = make_mesh(["cpu"] * (2 * data), data=data)
    tsh = convert.sharded_hnsw_state(
        mesh, "cosine", HNSW_OPTS, jsh.ids, x=jsh._x, a0=jsh._a0, upi=jsh._upi, upa=jsh._upa,
        lex=jsh._lex, rows=jsh._rows, entries=jsh._entries, row_of=jsh._row_of)
    _assert_hits(tsh.search_batch(q, 10), want)
    with pytest.raises(ValueError, match="only searches"):
        tsh.incremental_delete(["doc-001"])


def _records(n=80, seed=11):
    vectors = _unit(n, seed)
    return ([{"id": f"doc-{i:03d}", "vector": [float(v) for v in vectors[i]]}
             for i in range(n)], vectors)


def _pair(index, data=2, shards=2, **opts):
    records, vectors = _records()
    sharded = tvt.Collection(name="m", dimensions=D, index=index,
                             mesh=make_mesh(["cpu"] * (shards * data), data=data), **opts)
    single = tvt.Collection(name="s", dimensions=D, index=index, device="cpu", **opts)
    sharded.put_many(records)
    single.put_many(records)
    return sharded, single, records, vectors


def _ids(rows):
    return [r.id for r in rows]


class TestMeshHnswCollection:
    OPTS = {"index_options": HNSW_OPTS}

    @pytest.mark.parametrize("data,shards", [(1, 2), (2, 2), (1, 4)])
    def test_self_hits_and_overlap(self, data, shards):
        sharded, single, _records_, vectors = _pair("hnsw", data, shards, **self.OPTS)
        assert isinstance(sharded.index, MeshHnswIndex)
        overlaps = []
        for qi in range(0, 80, 7):
            got = sharded.search(list(vectors[qi]), limit=5)
            assert got[0].id == f"doc-{qi:03d}"
            overlaps.append(len(set(_ids(got)) & set(_ids(single.search(list(vectors[qi]),
                                                                          limit=5)))) / 5)
        assert np.mean(overlaps) >= 0.9

    def test_tiny_corpus_few_rows_per_shard(self):
        vecs = _unit(10, 2)
        col = tvt.Collection(name="tiny", dimensions=D, index="hnsw",
                             mesh=make_mesh(["cpu"] * 4, data=2), **self.OPTS)
        col.put_many([{"id": f"t-{i:02d}", "vector": [float(v) for v in vecs[i]]}
                      for i in range(10)])
        got = col.search(list(vecs[4]), limit=5)
        assert got[0].id == "t-04" and len(got) == 5
        # an empty shard holds one '__pad__' row that never surfaces
        few = tvt.Collection(name="few", dimensions=D, index="hnsw",
                             mesh=make_mesh(["cpu"] * 4), **self.OPTS)
        few.put_many([{"id": f"t-{i:02d}", "vector": [float(v) for v in vecs[i]]}
                      for i in range(3)])
        assert _ids(few.search(list(vecs[1]), limit=5))[:1] == ["t-01"]
        assert len(few.search(list(vecs[1]), limit=5)) == 3

    def test_incremental_ingest_while_serving(self):
        sharded, single, _records_, vectors = _pair("hnsw", **self.OPTS)
        assert sharded.search(list(vectors[0]), limit=3)[0].id == "doc-000"  # builds
        built = sharded.index._sharded
        extra = _unit(6, 7)
        new = [{"id": f"new-{i}", "vector": [float(x) for x in v]} for i, v in enumerate(extra)]
        sharded.put_many(new)
        single.put_many(new)
        assert sharded.index._sharded is built  # mutated in place, no rebuild
        for i in (0, 3, 5):
            assert sharded.search(list(extra[i]), limit=3)[0].id == f"new-{i}"
        for c in (sharded, single):
            c.delete("new-2")
        assert "new-2" not in _ids(sharded.search(list(extra[2]), limit=5))
        # a replace: the id takes a new vector in place
        for c in (sharded, single):
            c.delete("doc-001")
            c.put({"id": "doc-001", "vector": [float(x) for x in extra[2]]})
        assert sharded.search(list(extra[2]), limit=3)[0].id == "doc-001"
        overlaps = [len(set(_ids(sharded.search(list(vectors[qi]), limit=5)))
                        & set(_ids(single.search(list(vectors[qi]), limit=5)))) / 5
                    for qi in range(0, 80, 9)]
        assert np.mean(overlaps) >= 0.85

    def test_shard_compaction_after_heavy_delete(self, monkeypatch):
        sharded, _single, records, vectors = _pair("hnsw", **self.OPTS)
        sharded.search(list(vectors[0]), limit=1)  # build
        monkeypatch.setattr(tbuild, "should_compact", lambda g: True)
        before = list(sharded.index._sharded._graphs)
        for i in range(40, 56):
            sharded.delete(f"doc-{i:03d}")
        after = sharded.index._sharded._graphs
        # the rows 40-55 live in shard 1: only that shard rebuilt
        assert after[0] is before[0] and after[1] is not before[1]
        ids = _ids(sharded.search(list(vectors[10]), limit=10))
        assert ids[0] == "doc-010"
        assert not any(f"doc-{i:03d}" in ids for i in range(40, 56))
        sharded.put(records[45])  # lands in a compacted shard and serves
        assert sharded.search(list(vectors[45]), limit=3)[0].id == "doc-045"

    def test_hnsw_generator_on_mesh(self):
        sharded, single, _records_, vectors = _pair("hnsw", **self.OPTS)
        qs = [list(map(float, v)) for v in vectors[[3, 30, 60]] + 0.05]
        gens = [("hnsw", {"candidates": 40}), ("quantized", {"candidates": 40})]
        got = sharded.hybrid_search_batch(qs, limit=5, generators=gens)
        want = single.hybrid_search_batch(qs, limit=5, generators=gens)
        assert [_ids(r) for r in got] == [_ids(r) for r in want]


# ---------------------------------------------------------------------------
# ShardedIvf
# ---------------------------------------------------------------------------


class TestMeshIvfCollection:
    OPTS = {"index_options": {"n_probe": 65_536, "kmeans_iters": 2}}

    @pytest.mark.parametrize("metric", ["cosine", "l2"])
    def test_full_probe_equals_single_device_and_jax(self, metric):
        # f32 rows: the raws are full f32 in all three
        opts = {"index_options": dict(self.OPTS["index_options"], storage="f32")}
        records, vectors = _records()
        mesh = make_mesh(["cpu"] * 4, data=2)
        sharded = tvt.Collection(name="m", dimensions=D, metric=metric, index="ivf",
                                 mesh=mesh, **opts)
        single = tvt.Collection(name="s", dimensions=D, metric=metric, device="cpu")
        jcol = jvt.Collection(name="j", dimensions=D, metric=metric, index="ivf",
                              mesh=_jmesh(), **opts)
        for c in (sharded, single, jcol):
            c.put_many(records)
        assert isinstance(sharded.index, MeshIvfIndex)
        qs = vectors[[3, 17, 42]]
        got = sharded.search_batch(qs, limit=7)
        for want in (single.search_batch(qs, limit=7), jcol.search_batch(qs, limit=7)):
            assert [_ids(r) for r in got] == [_ids(r) for r in want]
            for g_row, w_row in zip(got, want):
                for g, w in zip(g_row, w_row):
                    assert g.score == pytest.approx(w.score, abs=1e-5)

    def test_delete_then_insert(self):
        sharded, _single, records, vectors = _pair("ivf", **self.OPTS)
        sharded.search(list(vectors[0]), limit=1)
        built = sharded.index._sharded
        sharded.delete("doc-003")
        assert "doc-003" not in _ids(sharded.search(list(vectors[3]), limit=5))
        assert sharded.index._sharded is built  # a bias flip, no rebuild
        sharded.put(records[3])
        assert sharded.search(list(vectors[3]), limit=5)[0].id == "doc-003"

    def test_auto_n_probe_on_mesh(self):
        sharded, _single, _records_, vectors = _pair(
            "ivf", index_options={"n_probe": "auto", "kmeans_iters": 2, "target_recall": 0.9})
        assert len(sharded.search(list(vectors[4]), limit=5)) == 5
        sh = sharded.index._sharded
        assert sh.tuned is not None and sh.tuned["target"] == 0.9
        p = sh.effective_n_probe()
        assert p >= 1 and (sh.tuned["recall_at_10"] >= 0.9 or p >= sh.capb // 64)

    def test_snapshot_restore_on_mesh(self, tmp_path):
        sharded, single, _records_, vectors = _pair("ivf", **self.OPTS)
        path = str(tmp_path / "mesh-ivf.vsnap")
        sharded.snapshot(path)
        loaded = tvt.load_snapshot(path, mesh=sharded.mesh)
        assert loaded.index_kind == "ivf" and isinstance(loaded.index, MeshIvfIndex)
        assert loaded.search(list(vectors[5]), limit=3)[0].id == "doc-005"
        loaded.close()


@pytest.fixture(scope="module")
def jax_ivf():
    """A JAX ShardedIvf over 2 shards of 640 rows (10 blocks each)."""
    data = _unit(1280, 8)
    ids = [f"v-{i:04d}" for i in np.random.default_rng(3).permutation(1280)]
    return JShardedIvf("cosine", _jmesh(), ids, data, options={"kmeans_iters": 2}), data


@pytest.mark.parametrize("n_probe", [1, 2])
def test_carried_sharded_ivf_probes_as_jax(jax_ivf, n_probe):
    jsh, data = jax_ivf
    tsh = convert.sharded_ivf_state(
        make_mesh(["cpu"] * 2), "cosine", jsh.ids, x=jsh._x, xsq=jsh._xsq, bias=jsh._bias,
        lex=jsh._lex, rows=jsh._rows, bcb=jsh._bcb, csq=jsh._csq, bbias=jsh._bbias,
        options=jsh.params)
    q = data[np.random.default_rng(4).integers(0, 1280, 8)] + 0.05
    _assert_hits(tsh._probe_batch(q, 10, n_probe), jsh._probe_batch(q, 10, n_probe))


def test_sharded_ivf_build_matches_jax_blocks():
    """Each shard's cluster-major layout: the same rows (global row and lex
    planes) as JAX's build on a corpus whose k-means margins exceed f32
    noise (well-separated clusters)."""
    rng = np.random.default_rng(2)
    centres = rng.normal(size=(8, D)).astype(np.float32) * 10
    data = (centres[rng.integers(0, 8, 512)]
            + rng.normal(size=(512, D)).astype(np.float32) * 0.01)
    ids = [f"c-{i:03d}" for i in range(512)]
    opts = {"kmeans_iters": 2, "storage": "f32"}
    jsh = JShardedIvf("l2", _jmesh(), ids, data, options=opts)
    tsh = ShardedIvf("l2", make_mesh(["cpu"] * 2), ids, data, options=opts)
    for s in range(2):
        np.testing.assert_array_equal(tsh._shards[s]["rows"].numpy(), np.asarray(jsh._rows[s]))
        np.testing.assert_array_equal(tsh._shards[s]["lex"].numpy(), np.asarray(jsh._lex[s]))
    q = data[:6]
    _assert_hits(tsh.search_batch(q, 5), jsh.search_batch(q, 5))


# ---------------------------------------------------------------------------
# Data rows on distinct devices
# ---------------------------------------------------------------------------


def _tensors(obj):
    """Every tensor in an index's state (lists, tuples, dicts, ``Blocks``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif hasattr(obj, "parts"):
        yield from _tensors(obj.parts)


@pytest.mark.parametrize("kind", ["flat", "hnsw", "ivf"])
def test_data_rows_on_distinct_devices_read_placed_state(kind, monkeypatch):
    """data 2 x shard 2 with the data rows on distinct devices ("cpu" and
    "cpu:0" compare unequal, and a move between them copies): the second
    row searches the shard copies placed at build and after each delete, so
    no state tensor is copied during a search, and the hits equal those of
    a mesh on one device (ids in order, raws within 1e-5)."""
    x = _unit(300, seed=21)
    ids = [f"p-{i:04d}" for i in range(300)]
    q = np.concatenate([x[:4], _unit(4, seed=22)])
    build = {
        "flat": lambda m: ShardedFlat("cosine", m, ids, x),
        "hnsw": lambda m: ShardedHnsw("cosine", m, ids, x, options=dict(HNSW_OPTS, build="wave")),
        "ivf": lambda m: ShardedIvf("cosine", m, ids, x, options={"n_probe": 2}),
    }[kind]
    delete = {
        "flat": lambda index: index.invalidate_ids(ids[:2]),
        "hnsw": lambda index: index.incremental_delete(ids[:2]),
        "ivf": lambda index: index.invalidate_rows([0, 1]),
    }[kind]
    two = build(make_mesh(["cpu", "cpu", torch.device("cpu", 0), torch.device("cpu", 0)],
                          data=2))
    one = build(make_mesh(["cpu"] * 4, data=2))
    real = torch.Tensor.to
    copied = []

    def to(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if self.data_ptr() in state and out.data_ptr() != self.data_ptr():
            copied.append(tuple(self.shape))
        return out

    for step in ("built", "deleted"):
        if step == "deleted":
            delete(two)
            delete(one)
        state = {t.data_ptr() for t in _tensors(list(vars(two).values())) if t.numel()}
        monkeypatch.setattr(torch.Tensor, "to", to)
        got = two.search_batch(q, 5)
        monkeypatch.undo()
        assert copied == [], (step, copied)
        _assert_hits(got, one.search_batch(q, 5))
        assert not any(h[0] in ids[:2] for row in got for h in row) or step == "built"
