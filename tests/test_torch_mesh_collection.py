"""``Collection(mesh=...)`` of the port against a JAX mesh collection and
against the single-device port, on the CPU: the cases of
``tests/test_mesh_fast.py``, ``tests/test_adaptive_mesh.py`` and
``tests/test_mesh_collection.py``.

The JAX collections sit on a 2-device JAX mesh (module fixtures: its
``shard_map`` programs compile once per mode); the port's meshes are
``["cpu"] * n`` grids of 2-4 virtual shards and data 1-2. Every mode must
return the same ids in the same order as both; scores agree within 1e-4
relative and 1e-5 absolute (f32 sums of another order). On the kernel
routes (the fused thresholds lowered) the shards run the kernels' plain
versions, and the collection must still equal the single-device port.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu.parallel import make_mesh as jmake_mesh
from vettore_tpu_torch.index import flat as tflat
from vettore_tpu_torch.ops import flat_scan
from vettore_tpu_torch.ops import pipeline as pipe
from vettore_tpu_torch.parallel import MeshFlatIndex, make_mesh

torch.set_num_threads(2)

DIMS = 16
N_DOCS = 70
LAYOUTS = [(2, 1), (2, 2), (4, 1)]


def _records(n=N_DOCS, seed=3):
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, DIMS)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    records = []
    for i in range(n):
        toks = vectors[i][None, :] + 0.1 * rng.normal(size=(1 + i % 3, DIMS))
        records.append({"id": f"doc-{i:03d}", "vector": [float(v) for v in vectors[i]],
                        "vectors": [[float(x) for x in row] for row in toks]})
    qs = vectors[rng.integers(0, n, 5)] + 0.05 * rng.normal(size=(5, DIMS))
    return records, vectors, [list(map(float, q)) for q in qs]


RECORDS, VECTORS, QUERIES = _records()
QSETS = [[q, [v * 0.5 for v in q]] for q in QUERIES]
GENS = [("funnel", {"candidates": 16}), ("quantized", {"candidates": 16})]
MODES = {
    "search": lambda c: c.search_batch(QUERIES, limit=5),
    "search_one": lambda c: [c.search(QUERIES[0], limit=7)],
    "funnel": lambda c: c.funnel_search_batch(QUERIES, limit=4, candidates=16,
                                              stages=[8, DIMS]),
    "funnel_one": lambda c: [c.funnel_search(QUERIES[1], limit=5, candidates=30)],
    "funnel_all": lambda c: c.funnel_search_batch(QUERIES[:2], limit=10, candidates=N_DOCS),
    "quantized": lambda c: c.quantized_search_batch(QUERIES, limit=4, candidates=16),
    "quantized_one": lambda c: [c.quantized_search(QUERIES[2], limit=5)],
    "multi_vector": lambda c: c.multi_vector_search_batch(QSETS, limit=4),
    "multi_vector_ip": lambda c: c.multi_vector_search_batch(QSETS, limit=4,
                                                             metric="inner_product"),
    "multi_vector_one": lambda c: [c.multi_vector_search(QSETS[0], limit=5)],
    "hybrid": lambda c: c.hybrid_search_batch(QUERIES, limit=4, generators=GENS),
    "hybrid_search": lambda c: c.hybrid_search_batch(
        QUERIES, limit=4, generators=GENS + [("search", {"candidates": 8})]),
    "hybrid_mv": lambda c: c.hybrid_search_batch(QUERIES, limit=4, generators=GENS,
                                                 rerank=("multi_vector", QSETS)),
    "hybrid_one": lambda c: [c.hybrid_search(QUERIES[3], limit=5, generators=GENS)],
}


def _rows_equal(got, want):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [r.id for r in g_row] == [r.id for r in w_row]
        for g, w in zip(g_row, w_row):
            assert g.score == pytest.approx(w.score, rel=1e-4, abs=1e-5)


def _port(mesh=None, index="flat", metric="cosine", records=RECORDS, **opts):
    col = tvt.Collection(name="tm", dimensions=DIMS, metric=metric, index=index,
                         mesh=mesh, device=None if mesh is not None else "cpu", **opts)
    col.put_many(records)
    return col


@pytest.fixture(scope="module")
def jax_flat():
    """A JAX flat collection on a 2-device mesh and its results per mode."""
    col = jvt.Collection(name="jm", dimensions=DIMS, metric="cosine", index="flat",
                         mesh=jmake_mesh(jax.devices()[:2]))
    col.put_many(RECORDS)
    return {mode: fn(col) for mode, fn in MODES.items()}


@pytest.fixture(scope="module")
def single_flat():
    col = _port()
    return {mode: fn(col) for mode, fn in MODES.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shards,data", LAYOUTS)
def test_flat_modes_equal_jax_mesh_and_single_device(mode, shards, data, jax_flat, single_flat):
    col = _port(make_mesh(["cpu"] * (shards * data), data=data))
    got = MODES[mode](col)
    _rows_equal(got, single_flat[mode])
    _rows_equal(got, jax_flat[mode])
    assert col.host_routes == 0


def test_full_candidates_equal_exact():
    col = _port(make_mesh(["cpu"] * 2))
    _rows_equal(col.quantized_search_batch(QUERIES, limit=5, candidates=N_DOCS),
                col.search_batch(QUERIES, limit=5))


def test_odd_batch_on_two_data_rows():
    # B = 5 is not a multiple of data = 2: the pad row never leaks
    col, single = _port(make_mesh(["cpu"] * 4, data=2)), _port()
    got = col.funnel_search_batch(QUERIES, limit=4, candidates=20)
    assert len(got) == 5
    _rows_equal(got, single.funnel_search_batch(QUERIES, limit=4, candidates=20))


def test_device_batches_need_whole_data_rows():
    col = _port(make_mesh(["cpu"] * 4, data=2))
    q = torch.from_numpy(np.stack([col.prepare_query(v) for v in QUERIES]).astype(np.float32))
    out = col.funnel_search_batch_device(q[:4], limit=3)
    assert out[0].device == col.mesh.first and out[0].shape == (4, 3)
    _rows_equal(col.results_from_device(out), _port().funnel_search_batch(QUERIES[:4], limit=3))
    with pytest.raises(ValueError, match="multiple of data"):
        col.quantized_search_batch_device(q, limit=3)


def test_delete_then_adaptive_and_reinsert():
    mesh = make_mesh(["cpu"] * 2)
    col, single = _port(mesh), _port()
    for c in (col, single):
        c.delete("doc-007")
    got = col.quantized_search_batch(QUERIES, limit=5, candidates=40)
    _rows_equal(got, single.quantized_search_batch(QUERIES, limit=5, candidates=40))
    assert all("doc-007" not in [r.id for r in row] for row in got)
    _rows_equal(col.search_batch([VECTORS[7].tolist()], limit=5),
                single.search_batch([VECTORS[7].tolist()], limit=5))
    col.put(RECORDS[7])  # a reinsert reshards
    assert col.search(VECTORS[7].tolist(), limit=3)[0].id == "doc-007"


def test_cache_blocks_are_row_sharded():
    col = _port(make_mesh(["cpu"] * 4))
    col.funnel_search_batch(QUERIES, limit=3)
    cache = col._scan_cache()
    x, _valid = cache.vectors()
    assert cache.cap % (4 * flat_scan.GROUP) == 0
    assert [x.shard(s).shape[0] for s in range(4)] == [cache.cap // 4] * 4
    assert cache.signs().rows == cache.cap // 4
    tokens, counts = cache.multi_vectors()
    assert tokens.rows == counts.rows == cache.cap // 4


def test_compressed_mesh_stores_bf16_shards():
    records = [{"id": r["id"], "vector": r["vector"]} for r in RECORDS]
    col = _port(make_mesh(["cpu"] * 2), records=records, compressed=True)
    single = _port(records=records, compressed=True)
    assert isinstance(col.index, MeshFlatIndex) and col.index.storage == "bf16"
    _rows_equal(col.search_batch(QUERIES, limit=5), single.search_batch(QUERIES, limit=5))
    assert col.index._sharded._x.shard(0).dtype == torch.bfloat16


@pytest.fixture
def kernel_routes(monkeypatch):
    """The fused thresholds lowered in the port (JAX's mesh never reads
    them): every shard of 64 rows and more runs the kernel routes; the
    wrappers count their calls."""
    monkeypatch.setattr(tflat, "FUSED_ROWS_MIN", 64)
    monkeypatch.setattr(pipe, "_FUSED_STAGE_MIN", 64)
    monkeypatch.setattr(pipe, "_GROUP_COVER_MIN", 64)
    calls = {}
    for name in ("fused_flat_search", "fused_stage_candidates", "fused_sign_scan",
                 "extract_group_rows"):
        real = getattr(flat_scan, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(flat_scan, name, counted)
    return calls


@pytest.mark.parametrize("shards,data", [(2, 1), (2, 2), (4, 1)])
def test_kernel_routes_equal_single_device(kernel_routes, shards, data):
    records, _vectors, queries = _records(n=700, seed=9)
    col, single = _port(make_mesh(["cpu"] * (shards * data), data=data), records=records), \
        _port(records=records)
    _rows_equal(col.search_batch(queries, limit=7), single.search_batch(queries, limit=7))
    _rows_equal(col.funnel_search_batch(queries, limit=5, candidates=20, stages=[8, DIMS]),
                single.funnel_search_batch(queries, limit=5, candidates=20, stages=[8, DIMS]))
    # the group cover needs more 64-row groups per shard than candidates
    _rows_equal(col.quantized_search_batch(queries, limit=2, candidates=3),
                single.quantized_search_batch(queries, limit=2, candidates=3))
    gens = [("funnel", {"candidates": 3}), ("quantized", {"candidates": 3})]
    _rows_equal(col.hybrid_search_batch(queries, limit=3, generators=gens),
                single.hybrid_search_batch(queries, limit=3, generators=gens))
    qsets = [[q, [v * 0.5 for v in q]] for q in queries]
    _rows_equal(col.multi_vector_search_batch(qsets, limit=4),
                single.multi_vector_search_batch(qsets, limit=4))
    for name in ("fused_flat_search", "fused_stage_candidates", "fused_sign_scan",
                 "extract_group_rows"):
        assert kernel_routes.get(name, 0) > 0, name
    assert col.host_routes == 0 and col.index.reruns == 0


def test_flagged_batch_query_reruns_on_the_host(monkeypatch):
    """A query the sharded hybrid flags re-runs alone on the host oracles
    and counts in ``host_routes`` (JAX's ``_hybrid_fallback``)."""
    col, single = _port(make_mesh(["cpu"] * 2)), _port()
    real = pipe._subset_raw_rank

    def flag_all(*args, **kwargs):
        raw, rank, finite = real(*args, **kwargs)
        return raw, rank, torch.zeros_like(finite)

    monkeypatch.setattr(pipe, "_subset_raw_rank", flag_all)
    got = col.hybrid_search_batch(QUERIES[:2], limit=4, generators=GENS)
    monkeypatch.undo()
    assert col.host_routes == 2
    _rows_equal(got, single.hybrid_search_batch(QUERIES[:2], limit=4, generators=GENS))


def test_mesh_collection_device_must_be_the_mesh_first():
    mesh = make_mesh(["cpu"] * 2)
    col = tvt.Collection(dimensions=DIMS, mesh=mesh, device="cpu")
    assert col.device == mesh.first == torch.device("cpu")
    with pytest.raises(tvt.errors.VettoreError, match="first device"):
        tvt.Collection(dimensions=DIMS, mesh=mesh, device="meta")


def test_snapshot_restore_on_mesh(tmp_path):
    mesh = make_mesh(["cpu"] * 4, data=2)
    col, single = _port(mesh), _port()
    path = str(tmp_path / "mesh.vsnap")
    col.snapshot(path)
    loaded = tvt.load_snapshot(path, mesh=mesh)
    assert isinstance(loaded.index, MeshFlatIndex) and loaded.mesh is mesh
    _rows_equal(loaded.search_batch(QUERIES, limit=5), single.search_batch(QUERIES, limit=5))
    _rows_equal(loaded.multi_vector_search_batch(QSETS, limit=4),
                single.multi_vector_search_batch(QSETS, limit=4))
    # a mesh snapshot loads on one device, and a JAX mesh's loads on a mesh
    plain = tvt.load_snapshot(path, device="cpu")
    _rows_equal(plain.search_batch(QUERIES, limit=5), single.search_batch(QUERIES, limit=5))
    jcol = jvt.Collection(name="js", dimensions=DIMS, metric="cosine",
                          mesh=jmake_mesh(jax.devices()[:2]))
    jcol.put_many(RECORDS)
    jpath = str(tmp_path / "jax-mesh.vsnap")
    jcol.snapshot(jpath)
    _rows_equal(tvt.load_snapshot(jpath, mesh=make_mesh(["cpu"] * 2)).search_batch(
        QUERIES, limit=5), jcol.search_batch(QUERIES, limit=5))
    with pytest.raises(tvt.errors.VettoreError, match="first device"):
        tvt.load_snapshot(path, mesh=mesh, device="meta")
