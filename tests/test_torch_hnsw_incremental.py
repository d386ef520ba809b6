"""Writes to a bulk-built HNSW graph in the port (``hnsw_build``'s
``incremental_put`` / ``incremental_delete`` / ``compact``) against the JAX
package's, on the CPU.

Each case of ``tests/test_hnsw_incremental.py`` runs here as a parity case:
both packages bulk-build the same seeded 300 x 16 corpus (``BULK_THRESHOLD =
2``, the wave build, built once per module and copied per case), take the
same writes, and must then hold the same graph (``_assert_graphs_agree``:
equal slots, levels, ranks and capacity, adjacency equal up to float64
near-ties), the same tombstones and entry, and return the same ids with raw
scores within 1e-5; the case's own checks run on the port. Also: a mutated
JAX graph carried across whole by ``convert.hnsw_graph_state``, graph files
written after mutation loaded by either package, ``bulk_ingest_device``, and
``Collection(index="hnsw")`` writes after a bulk build and after
``attach_index``, with the ``hnsw`` hybrid generator.
"""

import copy

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from test_torch_hnsw_knn_build import _assert_graphs_agree
from vettore_tpu.index import hnsw_build as jbuild
from vettore_tpu.index.hnsw import HnswIndex as JHnsw
from vettore_tpu.index.hnsw import level_for
from vettore_tpu_torch.convert import hnsw_graph_state
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.index.hnsw import HnswIndex as THnsw

torch.set_num_threads(2)

OPTS = {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 48}
N, D = 300, 16
RAW_TOL = 1e-5


def _unit(rows):
    rows = np.asarray(rows, np.float32)
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


def _build(n, seed=3):
    data = _unit(np.random.default_rng(seed).normal(size=(n, D)))
    pair = (JHnsw("cosine", OPTS), THnsw("cosine", OPTS, device="cpu"))
    for idx in pair:
        idx.BULK_THRESHOLD = 2
        idx.put_many((f"id-{i:05d}", v) for i, v in enumerate(data))
        assert idx._bulk is not None
    return pair, data


@pytest.fixture(scope="module")
def base():
    return _build(N)


@pytest.fixture
def pair(base):
    """A fresh copy of the module's two bulk-built indexes."""
    (j, t), data = base
    return copy.deepcopy(j), copy.deepcopy(t), data


def _both(pair, fn):
    for idx in pair[:2]:
        fn(idx)


def _hit_ids(idx, q, k):
    return [h[0] for h in idx.search(np.asarray(q, np.float64), k)]


def _same_state(j, t, queries, k=10, adjacency=True):
    """The same graph, tombstones and entry in both packages, and the same
    search results. ``adjacency=False`` skips the adjacency where the
    corpus holds one vector twice: the heuristic then compares the bf16
    rank of the copies to one base (a tie in float64) with their rank to
    each other, two f32 sums of one dot product in different orders, so a
    1-ulp difference keeps or prunes a copy (the kNN build's mass-tie test
    meets the same), while the search results stay equal."""
    jg, tg = j._bulk, t._bulk
    assert (jg is None) == (tg is None)
    if jg is not None and adjacency:
        _assert_graphs_agree("cosine", jg, tg)
    elif jg is not None:
        assert tg.ids == jg.ids and (tg.n, tg.lmax, tg.entry_slot, tg.entry_level) == (
            jg.n, jg.lmax, int(jg.entry_slot), int(jg.entry_level))
        np.testing.assert_array_equal(tg.levels, jg.levels)
        np.testing.assert_array_equal(tg.lex_rank.numpy(), np.asarray(jg.lex_rank))
    if jg is not None:
        assert tg.live == jg.live == len(t) == len(j)
        assert tg.lex_spacing == jg.lex_spacing
        if jg.valid is None:
            assert tg.valid is None
        else:
            np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
        assert (tg._mut is None) == (jg._mut is None)
        if jg._mut is not None:
            assert (tg._mut.dead, tg._mut.up_used) == (jg._mut.dead, jg._mut.up_used)
            assert tg._mut.slot_of == jg._mut.slot_of
            np.testing.assert_array_equal(tg._mut.sorted_ids, jg._mut.sorted_ids)
            np.testing.assert_array_equal(tg._mut.sorted_ranks, jg._mut.sorted_ranks)
    # always 16 queries: one compiled JAX search per graph shape
    q = np.resize(np.asarray(queries, np.float64), (16, D))
    got, want = t.search_batch(q, k), j.search_batch(q, k)
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, g), (_, w) in zip(grow, wrow):
            assert abs(g - w) <= RAW_TOL, (g, w)


# ---------------------------------------------------------------------------
# the cases of tests/test_hnsw_incremental.py, as parity cases
# ---------------------------------------------------------------------------


def test_put_stays_bulk_and_is_searchable(pair):
    j, t, data = pair
    v = _unit(data[0] + 0.7 * np.eye(D, dtype=np.float32)[3])
    _both(pair, lambda idx: idx.put("zz-new", v))
    assert t._bulk is not None and len(t) == N + 1
    assert _hit_ids(t, v, 1) == ["zz-new"]
    _same_state(j, t, np.concatenate([data[:16], v[None]]))


def test_put_many_batch_self_recall(pair):
    j, t, data = pair
    extra = _unit(np.random.default_rng(9).normal(size=(80, D)))
    _both(pair, lambda idx: idx.put_many((f"new-{i:04d}", v) for i, v in enumerate(extra)))
    assert len(t) == N + 80
    found = sum(_hit_ids(t, extra[i], 1) == [f"new-{i:04d}"] for i in range(80))
    assert found >= 76  # >= 95% self-recall on fresh inserts
    _same_state(j, t, np.concatenate([data[:8], extra[:24]]))


def test_replace_moves_vector(pair):
    j, t, data = pair
    target = _unit(-data[7])
    _both(pair, lambda idx: idx.put("id-00007", target))
    assert len(t) == N  # replace, not insert
    assert _hit_ids(t, target, 1) == ["id-00007"]
    assert "id-00007" not in _hit_ids(t, data[7], 5)
    _same_state(j, t, np.stack([target, data[7], data[8]]))


def test_duplicate_ids_in_batch_keep_last(pair):
    j, t, data = pair
    a, b = np.eye(D, dtype=np.float32)[:2]
    _both(pair, lambda idx: idx.put_many([("dup", a), ("dup", b)]))
    assert len(t) == N + 1
    assert _hit_ids(t, b, 1) == ["dup"]
    _same_state(j, t, np.stack([a, b, data[1]]))


def test_tie_break_by_id_across_incremental_inserts(pair):
    j, t, data = pair
    # two new ids share id-00011's exact vector: equal ranks order by id
    _both(pair, lambda idx: idx.put_many([("aa-dup", data[11]), ("zz-dup", data[11])]))
    assert _hit_ids(t, data[11], 3) == ["aa-dup", "id-00011", "zz-dup"]
    _same_state(j, t, data[9:14], adjacency=False)


def test_high_level_insert_grows_layers(pair):
    j, t, data = pair
    lmax = t._bulk.lmax
    new_id = next(f"lv-{i}" for i in range(100000) if level_for(f"lv-{i}", 12) > lmax)
    _both(pair, lambda idx: idx.put(new_id, _unit(np.ones(D, np.float32))))
    assert t._bulk.lmax > lmax
    assert t._bulk.entry_slot == t._bulk.n - 1  # the new entry
    assert _hit_ids(t, np.ones(D) / 4.0, 1) == [new_id]
    _same_state(j, t, np.concatenate([data[:8], np.ones((1, D), np.float32)]))


def test_capacity_growth(pair, monkeypatch):
    j, t, data = pair
    for module in (jbuild, tbuild):
        monkeypatch.setattr(module, "CAP_SLACK_MIN", 8)
    cap0 = t._bulk.x.shape[0]
    extra = _unit(np.random.default_rng(4).normal(size=(3 * cap0, D)))
    _both(pair, lambda idx: idx.put_many((f"grow-{i:05d}", v) for i, v in enumerate(extra)))
    assert t._bulk.x.shape[0] > cap0
    assert len(t) == N + 3 * cap0
    hit = sum(_hit_ids(t, extra[i], 1) == [f"grow-{i:05d}"] for i in range(0, 3 * cap0, 16))
    assert hit >= (3 * cap0 // 16) * 9 // 10
    _same_state(j, t, extra[::40])


def test_deleted_ids_never_surface(pair):
    j, t, data = pair
    _both(pair, lambda idx: [idx.delete(f"id-{i:05d}") for i in range(10)])
    assert len(t) == N - 10
    for i in range(10):
        assert f"id-{i:05d}" not in _hit_ids(t, data[i], 10)
    assert _hit_ids(t, data[0], 1)[0].startswith("id-")  # the nearest live one
    _same_state(j, t, data[:12])


def test_delete_missing_is_noop(pair):
    j, t, data = pair
    v = t._version
    _both(pair, lambda idx: idx.delete("nope"))
    assert len(t) == N and t._version == v
    _same_state(j, t, data[:4])


def test_entry_reelection(pair):
    j, t, data = pair
    g = t._bulk
    entry_id = g.ids[g.entry_slot]
    _both(pair, lambda idx: idx.delete(entry_id))
    assert g.ids[g.entry_slot] != entry_id
    assert len(_hit_ids(t, data[50], 5)) == 5
    _same_state(j, t, data[48:56])


def test_delete_all_resets_to_empty():
    (j, t), data = _build(40)
    for idx in (j, t):
        for i in range(40):
            idx.delete(f"id-{i:05d}")
    assert len(t) == len(j) == 0
    assert t._bulk is None and t.dimension is None
    for idx in (j, t):
        idx.put("fresh", [1.0, 0.0])  # the host path takes a new dimension
    assert _hit_ids(t, [1.0, 0.0], 1) == _hit_ids(j, [1.0, 0.0], 1) == ["fresh"]


def test_compaction_rebuilds_live_set(pair):
    j, t, data = pair
    _both(pair, lambda idx: [idx.delete(f"id-{i:05d}") for i in range(80)])  # > 0.25 * 300
    g = t._bulk
    assert g.n < N  # a compaction dropped the tombstoned slots
    assert (g._mut.dead if g._mut is not None else 0) <= max(64, 0.25 * g.n)
    assert len(t) == N - 80
    ok = sum(_hit_ids(t, data[i], 1) == [f"id-{i:05d}"] for i in range(80, N, 10))
    assert ok >= 20
    _same_state(j, t, data[::25])


def test_reinsert_after_delete(pair):
    j, t, data = pair
    _both(pair, lambda idx: idx.delete("id-00042"))
    assert "id-00042" not in _hit_ids(t, data[42], 5)
    _both(pair, lambda idx: idx.put("id-00042", data[42]))
    assert _hit_ids(t, data[42], 1) == ["id-00042"]
    assert len(t) == N
    _same_state(j, t, data[40:45], adjacency=False)


def test_save_load_preserves_tombstones(pair, tmp_path):
    j, t, data = pair
    late = _unit(np.ones(D, np.float32))
    _both(pair, lambda idx: (idx.delete("id-00003"), idx.put("zz-late", late)))
    path = str(tmp_path / "g.npz")
    t.save_graph(path)
    loaded = THnsw.load_graph("cosine", OPTS, path, device="cpu")
    assert len(loaded) == N
    assert "id-00003" not in _hit_ids(loaded, data[3], 10)
    assert _hit_ids(loaded, np.ones(D) / 4.0, 1) == ["zz-late"]
    # loaded graphs stay mutable, as the JAX package's
    jloaded = JHnsw.load_graph("cosine", OPTS, path)
    _same_state(jloaded, loaded, data[:6])
    for idx in (loaded, jloaded):
        idx.delete("zz-late")
    assert len(loaded) == N - 1
    _same_state(jloaded, loaded, np.concatenate([data[:6], late[None]]))


def test_gap_exhaustion_respaces(pair):
    j, t, data = pair
    st = tbuild._ensure_mutable(t._bulk)
    # more than 1,024 ids between "id-00000" and "id-00001" exhaust the gap
    extra = _unit(np.random.default_rng(11).normal(size=(1200, D)))
    _both(pair, lambda idx: idx.put_many((f"id-00000a{i:05d}", v) for i, v in enumerate(extra)))
    assert len(t) == N + 1200
    assert np.all(np.diff(st.sorted_ranks) > 0)  # strictly increasing
    pos = np.searchsorted(st.sorted_ids, "id-00000a00500")
    assert st.sorted_ids[pos] == "id-00000a00500"
    _same_state(j, t, extra[::100])


# ---------------------------------------------------------------------------
# the lex bookkeeping, the migration, graphs carried across packages
# ---------------------------------------------------------------------------


def test_assign_lex_widens_sorted_ids_before_insert(pair):
    """``np.insert`` truncates strings longer than the array's width: a
    longer new id must widen ``sorted_ids`` first, as in the JAX package."""
    j, t, data = pair
    long_id = "id-00000-" + "x" * 40
    _both(pair, lambda idx: idx.put(long_id, data[0]))
    st = t._bulk._mut
    assert long_id in st.sorted_ids.tolist() and st.sorted_ids.dtype.itemsize >= 4 * len(long_id)
    assert _hit_ids(t, data[0], 2) == ["id-00000", long_id]
    _same_state(j, t, data[:3], adjacency=False)


def test_migration_pads_to_capacity(pair):
    j, t, data = pair
    jst, tst = jbuild._ensure_mutable(j._bulk), tbuild._ensure_mutable(t._bulk)
    g = t._bulk
    cap = tbuild._capacity(N)
    assert cap == jbuild._capacity(N) and g.x.shape[0] == cap
    assert g.a0.shape[0] == cap + 1 and g._xb.shape[0] == cap  # + the trash row
    assert g.up_adj.shape == np.asarray(j._bulk.up_adj).shape
    assert tst.up_used == jst.up_used and g.lex_spacing == j._bulk.lex_spacing > 1
    np.testing.assert_array_equal(g.lex_rank.numpy(), np.asarray(j._bulk.lex_rank))
    assert len(g.hubs()[0]) == len(np.asarray(j._bulk.hubs()[0]))
    _same_state(j, t, data[:4])


def test_incremental_hub_set_is_sized_by_capacity(pair, monkeypatch):
    """An incremental wave seeds from ``hub_count(capacity)`` hubs, as the
    JAX package's (``hub_count(graph.x.shape[0])``); the two counts differ
    only past 65,536 rows, so this is checked on the call."""
    _j, t, data = pair
    seen = []
    real = tbuild._wave_step

    def spy(*args, **kw):
        seen.append(kw["hub_cap"])
        return real(*args, **kw)

    monkeypatch.setattr(tbuild, "_wave_step", spy)
    t.put("zz-hub", -data[0])
    assert seen == [tbuild.hub_count(t._bulk.x.shape[0])] and t._bulk.x.shape[0] > t._bulk.n


def test_mutated_jax_graph_carries_across_whole(pair):
    """A mutated JAX graph converted by ``hnsw_graph_state`` keeps its
    capacity, trash rows, ranks and tombstones, so the same writes after
    the conversion give equal graphs (the capacity sizes the hub set)."""
    j, _t, data = pair
    extra = _unit(np.random.default_rng(21).normal(size=(40, D)))
    j.put_many((f"c-{i:03d}", v) for i, v in enumerate(extra[:20]))
    for i in range(5):
        j.delete(f"id-{i:05d}")
    t = THnsw("cosine", OPTS, device="cpu")
    t._bulk = t._device = hnsw_graph_state(j._bulk, device="cpu")
    t._dim = D
    assert t._bulk.x.shape[0] == np.asarray(j._bulk.x).shape[0] > t._bulk.n
    _same_state(j, t, data[:6])
    for idx in (j, t):
        idx.put_many((f"c-{i:03d}", v) for i, v in enumerate(extra[20:], 20))
        idx.delete("id-00010")
        idx.put("id-00011", -data[11])
    _same_state(j, t, np.concatenate([data[8:14], -data[11:12], extra[::5]]))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_after_mutation_load_in_either_package(pair, tmp_path, writer):
    """The same writes, then each package saves: both files load into equal
    graphs in either package, and a loaded graph takes further puts."""
    j, t, data = pair
    extra = _unit(np.random.default_rng(5).normal(size=(30, D)))
    for idx in (j, t):
        idx.put_many((f"f-{i:03d}", v) for i, v in enumerate(extra))
        for i in range(0, 30, 3):
            idx.delete(f"id-{i:05d}")
    paths = {name: str(tmp_path / f"{name}.npz") for name in ("jax", "port")}
    j.save_graph(paths["jax"])
    t.save_graph(paths["port"])
    with np.load(paths["jax"]) as jz, np.load(paths["port"]) as tz:
        assert sorted(jz.files) == sorted(tz.files) and "valid" in tz.files
        for key in jz.files:
            if key != "x":
                np.testing.assert_array_equal(jz[key], tz[key], err_msg=key)
    jl = JHnsw.load_graph("cosine", OPTS, paths[writer])
    tl = THnsw.load_graph("cosine", OPTS, paths[writer], device="cpu")
    _same_state(jl, tl, np.concatenate([data[:6], extra[:4]]))
    for idx in (jl, tl):
        idx.put("zz-new", list(data[1]))
    assert len(tl) == len(t) + 1
    assert "zz-new" in _hit_ids(tl, data[1], 2)
    _same_state(jl, tl, data[:3], adjacency=False)


def test_bulk_ingest_device_matches_jax(base):
    _pair, data = base
    ids = [f"d-{i:04d}" for i in range(N)]
    j, t = JHnsw("cosine", OPTS), THnsw("cosine", OPTS, device="cpu")
    j.bulk_ingest_device(ids, jnp.asarray(data))
    t.bulk_ingest_device(ids, torch.from_numpy(data))
    _same_state(j, t, data[::20])
    with pytest.raises(tvt.errors.VettoreError):
        t.bulk_ingest_device(ids, torch.from_numpy(data))


# ---------------------------------------------------------------------------
# the collection: writes after a bulk build and after attach_index
# ---------------------------------------------------------------------------


def _col_pair(**kw):
    return (jvt.Collection(name="j", dimensions=D, metric="cosine", **kw),
            tvt.Collection(name="t", dimensions=D, metric="cosine", device="cpu", **kw))


def _same_results(got, want):
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert abs(g.score - w.score) <= RAW_TOL


def _write(col, data, extra):
    col.put({"id": "new-a", "vector": extra[0].tolist()})
    col.put_many([{"id": f"new-{i}", "vector": v.tolist()} for i, v in enumerate(extra[1:6])])
    col.put_matrix([f"mat-{i}" for i in range(6)], extra[6:12])
    col.delete("id-00001")
    col.delete("id-00002")
    col.delete("id-00002")  # already gone: a no-op


@pytest.mark.parametrize("route", ["bulk build", "attach_index"])
def test_collection_writes_match_jax(base, tmp_path, route):
    """``put`` / ``put_many`` / ``put_matrix`` / ``delete`` on an HNSW
    collection whose graph was bulk-built, or loaded and attached to a flat
    collection: the same results as the JAX package's, and the ``hnsw``
    hybrid generator (through ``index_slot_table``, which keeps tombstoned
    ids in the graph's table) gives JAX's ids."""
    (j0, _t0), data = base
    ids = [f"id-{i:05d}" for i in range(N)]
    extra = _unit(np.random.default_rng(12).normal(size=(12, D)))
    if route == "bulk build":
        cols = _col_pair(index="hnsw", index_options=OPTS)
        for col in cols:
            col.index.BULK_THRESHOLD = 2
            col.put_matrix(ids, data)
            assert col.index._bulk is not None
    else:
        path = str(tmp_path / "g.npz")
        j0.save_graph(path)
        cols = _col_pair()
        for col in cols:
            col.put_matrix(ids, data)
        cols[0].attach_index(JHnsw.load_graph("cosine", OPTS, path))
        cols[1].attach_index(THnsw.load_graph("cosine", OPTS, path, device="cpu"))
    for col in cols:
        _write(col, data, extra)
        assert col.index._bulk is not None and col.index_kind == "hnsw"
    jcol, tcol = cols
    assert tcol.count() == jcol.count() == len(tcol.index) == N + 10
    queries = np.concatenate([data[:6], extra[::2]])
    _same_results(tcol.search_batch(queries, limit=8), jcol.search_batch(queries, limit=8))
    gens = [("hnsw", {"candidates": 24}), ("quantized", {"candidates": 24})]
    got = tcol.hybrid_search_batch(queries, limit=6, generators=gens)
    _same_results(got, jcol.hybrid_search_batch(queries, limit=6, generators=gens))
    assert not {"id-00001", "id-00002"} & {r.id for row in got for r in row}
    assert "new-a" in {r.id for r in got[6]}
    assert tcol.host_routes == 0
