"""The port's columnar store (``vettore_tpu_torch/store/columnar.py``) and
``ops/transport.round_to_bf16`` against the JAX package's, on the CPU: the
cases of ``tests/test_columnar.py`` run on a store of each package with the
same writes, and their records, block state and errors must be identical
(the store is host code: no tolerance). ``round_to_bf16`` must be bit-equal
to the JAX package's on ties to even, subnormals, -0.0, ``F32_MAX``, the
values just below it, infinities and NaNs. Also: the port's
``Collection`` with ``store="columnar"`` and ``compressed=True`` against the
JAX one (ids equal, scores within 1e-5; the compressed ids equal a float64
oracle over the bf16-rounded rows).
"""

import threading

import ml_dtypes
import numpy as np
import pytest

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu import errors as jerrors
from vettore_tpu.ops.transport import round_to_bf16 as j_round
from vettore_tpu.store.columnar import ColumnarStore as JColumnar
from vettore_tpu_torch import errors
from vettore_tpu_torch.embedding import Embedding
from vettore_tpu_torch.ops.transport import round_to_bf16 as t_round
from vettore_tpu_torch.store.columnar import ColumnarStore
from vettore_tpu_torch.store.memory import MemoryStore

F32_MAX = np.finfo(np.float32).max
SCORE_TOL = 1e-5


def record(id, vec=None, **kw):
    if vec is None:
        vec = [1.0, 0.0]
    return Embedding(id=id, value=kw.get("value", id), vector=vec, **{
        k: v for k, v in kw.items() if k != "value"
    })


def both(dtype="f32", config=None):
    return JColumnar(dict(config or {}), dtype=dtype), ColumnarStore(dict(config or {}),
                                                                      dtype=dtype)


def view(e):
    """A hydrated record as plain values (the two packages' Embedding
    classes differ; their fields must not)."""
    def arr(v):
        return None if v is None else np.asarray(v).tolist()
    return (e.id, e.value, arr(e.vector), e.vectors, arr(e.binary_vector), e.metadata)


def same(jstore, tstore):
    assert tstore.count() == jstore.count()
    assert sorted(map(view, tstore.all())) == sorted(map(view, jstore.all()))
    js, ts = jstore._state, tstore._state
    assert (ts.used, ts.dead, ts.d, ts.words) == (js.used, js.dead, js.d, js.words)
    assert ts.slot_of == js.slot_of
    if js.block is not None:
        assert ts.block.dtype == js.block.dtype
        np.testing.assert_array_equal(ts.block, js.block)


def run(stores, fn):
    for s in stores:
        fn(s)
    same(*stores)


# ---------------------------------------------------------------------------
# round_to_bf16
# ---------------------------------------------------------------------------


def edge_values():
    tiny = np.finfo(np.float32).tiny
    bits = np.array([
        0x3F808000,  # 1 + 2**-8: a tie, even below -> down
        0x3F818000,  # a tie, odd below -> up
        0x3F807FFF, 0x3F808001,  # just below and above a tie
        0x00000001, 0x00008000, 0x00018000, 0x007FFFFF,  # subnormals, ties among them
        0x80000000, 0x80008000,  # -0.0, a negative subnormal tie
        0x7F7FFFFF, 0x7F7F7FFF, 0x7F7F8000, 0x7F7EFFFF,  # F32_MAX and just below it
        0xFF7FFFFF,  # -F32_MAX
        0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001, 0xFFFFFFFF,  # infs, NaNs
    ], dtype=np.uint32)
    rng = np.random.default_rng(0)
    rand = rng.standard_normal(4096).astype(np.float32) * np.float32(3.7)
    return np.concatenate([bits.view(np.float32), rand, np.float32([tiny, -tiny, F32_MAX])])


def test_round_to_bf16_bit_equal_to_jax():
    x = edge_values()
    got = t_round(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), j_round(x).view(np.uint32))
    # the named cases: ties to even, -0.0 kept, F32_MAX to +inf (the formula's
    # carry), values just below F32_MAX to the largest bf16
    b = got.view(np.uint32)
    assert b[0] == 0x3F800000 and b[1] == 0x3F820000
    assert b[8] == 0x80000000
    assert b[10] == 0x7F800000 and b[13] == 0x7F7F0000
    # finite values round as a bf16 cast does, as long as they stay finite
    fin = np.isfinite(x) & np.isfinite(got)
    want = x[fin].astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got[fin].view(np.uint32), want.view(np.uint32))


def test_round_to_bf16_shapes():
    x = np.arange(24, dtype=np.float64).reshape(2, 3, 4) / 7
    got = t_round(x)
    assert got.shape == (2, 3, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), j_round(x).view(np.uint32))


# ---------------------------------------------------------------------------
# the Store behaviour surface (test_columnar.py's TestBehaviourParity)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
class TestBehaviourParity:
    def test_crud_surface(self, dtype):
        stores = both(dtype, {"metric": "l2"})
        for s in stores:
            s.put(record("a"))
            s.put_many([record("b"), record("c")])
            assert s.get("a").id == "a"
            assert s.count() == 3
            assert s.fold(lambda e, acc: acc + 1, 0) == 3
        same(*stores)
        run(stores, lambda s: s.delete("b"))
        jstore, tstore = stores
        with pytest.raises(errors.NotFound):
            tstore.get("b")
        run(stores, lambda s: s.delete("missing"))  # idempotent
        assert sorted(e.id for e in tstore.all()) == ["a", "c"]

    def test_batch_insert_is_atomic_on_duplicates(self, dtype):
        stores = both(dtype)
        run(stores, lambda s: s.put(record("a")))
        for batch in ([record("b"), record("a")], [record("x"), record("x")]):
            with pytest.raises(errors.DuplicateId) as got:
                stores[1].put_many(batch)
            with pytest.raises(jerrors.DuplicateId) as want:
                stores[0].put_many(batch)
            assert str(got.value) == str(want.value)
        same(*stores)
        assert stores[1].count() == 1

    def test_closed(self, dtype, tmp_path):
        store = both(dtype)[1]
        store.put(record("a"))
        store.close()
        store.close()
        assert not store.alive()
        for op in [
            lambda: store.get("a"),
            lambda: store.put(record("b")),
            lambda: store.all(),
            lambda: store.delete("a"),
            lambda: store.count(),
            lambda: store.snapshot(str(tmp_path / "never.snap")),
        ]:
            with pytest.raises(errors.Closed):
                op()

    def test_record_roundtrip_fields(self, dtype):
        stores = both(dtype)
        run(stores, lambda s: s.put(record("r", vec=[0.5, -0.25], value="payload",
                                           metadata={"k": 1})))
        e = stores[1].get("r")
        assert e.value == "payload" and e.metadata == {"k": 1}
        # 0.5/-0.25 are bf16-exact, so both dtypes round-trip exactly
        assert np.asarray(e.vector, dtype=np.float32).tolist() == [0.5, -0.25]

    def test_replace_points_id_at_new_row(self, dtype):
        stores = both(dtype)
        run(stores, lambda s: s.put(record("a", vec=[1.0, 0.0])))
        old = stores[1].get("a")
        run(stores, lambda s: s.replace(record("a", vec=[0.0, 1.0], metadata={"v": 2})))
        tstore = stores[1]
        assert np.asarray(tstore.get("a").vector).tolist() == [0.0, 1.0]
        assert tstore.get("a").metadata == {"v": 2}
        # the previously hydrated record still sees its original row
        assert np.asarray(old.vector).tolist() == [1.0, 0.0]
        assert tstore.count() == 1 and tstore._state.dead == 1

    def test_snapshot_roundtrip(self, dtype, tmp_path):
        config = {"metric": "cosine", "compressed": dtype == "bf16"}
        stores = both(dtype, config)
        run(stores, lambda s: s.put_many([
            record("a", vec=[0.5, 0.5], metadata={"i": 0}),
            record("b", vec=[-0.25, 1.0], value="bee"),
        ]))
        path = str(tmp_path / "col.snap")
        stores[1].snapshot(path)
        loaded, got_config = ColumnarStore.load_snapshot(path)
        jloaded, want_config = JColumnar.load_snapshot(path)  # the JAX store reads it
        assert loaded._dtype == jloaded._dtype == dtype  # compressed config selects bf16
        assert got_config == want_config and got_config["metric"] == "cosine"
        same(jloaded, loaded)
        assert loaded.get("b").value == "bee"
        assert np.asarray(loaded.get("a").vector).tolist() == [0.5, 0.5]


# ---------------------------------------------------------------------------
# columnar specifics (test_columnar.py's TestColumnarSpecifics)
# ---------------------------------------------------------------------------


def test_bf16_mode_rounds_to_nearest():
    stores = both("bf16")
    val = 1.0 + 2**-9  # not bf16-representable; nearest-even -> 1.0
    run(stores, lambda s: s.put(record("x", vec=[val, 3.0000001, -F32_MAX])))
    got = np.asarray(stores[1].get("x").vector, dtype=np.float32)
    want = np.array([val, 3.0000001], np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
    assert got[:2].tolist() == want.tolist()
    assert got[2] == -np.inf  # the formula carries -F32_MAX past the largest bf16


def test_f32_mode_is_lossless_views():
    stores = both("f32")
    vecs = np.random.default_rng(0).normal(size=(32, 8)).astype(np.float32)
    run(stores, lambda s: s.put_many([record(f"r{i}", vec=vecs[i]) for i in range(32)]))
    for i in range(32):
        assert np.array_equal(np.asarray(stores[1].get(f"r{i}").vector), vecs[i])


def test_binary_vector_column():
    stores = both("f32")
    words = list(range(2))  # d=128 -> 2 u64 words
    run(stores, lambda s: s.put(Embedding(id="p", value="p", vector=[0.25] * 128,
                                          binary_vector=words)))
    got = stores[1].get("p").binary_vector
    assert np.asarray(got, dtype=np.uint64).tolist() == words
    # a record without a packed vector hydrates None
    run(stores, lambda s: s.put(Embedding(id="q", value="q", vector=[0.5] * 128)))
    assert stores[1].get("q").binary_vector is None
    # a nonstandard word count keeps the record whole
    run(stores, lambda s: s.put(Embedding(id="w", value="w", vector=[0.5] * 128,
                                          binary_vector=[1, 2, 3])))
    assert 2 in stores[1]._state.odd


def test_odd_records_survive_whole():
    stores = both("f32")
    run(stores, lambda s: s.put(record("base", vec=[1.0, 2.0])))
    run(stores, lambda s: s.put(Embedding(id="odd", value="odd", vector=[1.0, 2.0, 3.0])))
    assert np.asarray(stores[1].get("odd").vector).tolist() == [1.0, 2.0, 3.0]
    run(stores, lambda s: s.put(Embedding(id="mv", value="mv", vector=[1.0, 0.0],
                                          vectors=[[1.0, 0.0], [0.0, 1.0]])))
    assert stores[1].get("mv").vectors == [[1.0, 0.0], [0.0, 1.0]]


def test_compaction_preserves_readers_and_records():
    stores = both("f32")
    n = 10_000
    vecs = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    run(stores, lambda s: s.put_many([record(f"{i:05d}", vec=vecs[i]) for i in range(n)]))
    store = stores[1]
    held = store.get("00007")

    def deletes(s):
        # delete 60% -> dead outnumbers live, triggering compaction
        for i in range(n):
            if i % 5 != 2 and i % 5 != 4:
                s.delete(f"{i:05d}")
    run(stores, deletes)
    st = store._state
    # compaction ran: tombstones stay bounded by max(chunk, live)
    assert st.dead <= max(4096, len(st.slot_of))
    assert store.count() == n * 2 // 5
    assert np.asarray(store.get("00002").vector).tolist() == [4.0, 5.0]
    assert np.asarray(held.vector).tolist() == [14.0, 15.0]
    # block shrank back toward the live set
    assert store._state.block.shape[0] <= n


def test_concurrent_readers_during_writes():
    store = ColumnarStore({}, dtype="f32")
    store.put_many([record(f"{i:03d}") for i in range(64)])
    stop = threading.Event()
    failures = []

    def reader():
        while not stop.is_set():
            try:
                rows = store.all()
                assert len(rows) >= 64
                store.get("000")
            except Exception as exc:  # pragma: no cover
                failures.append(exc)
                return

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    for i in range(64, 256):
        store.put(record(f"{i:03d}"))
    stop.set()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not failures
    assert store.count() == 256


def test_columnar_ram_is_block_plus_epsilon():
    """The per-record bookkeeping must be O(maps), not O(objects): every
    value==id, metadata=None record costs zero dict entries."""
    stores = both("f32")
    n, d = 4096, 32
    vecs = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    run(stores, lambda s: s.put_many([record(f"{i:05d}", vec=vecs[i]) for i in range(n)]))
    st = stores[1]._state
    assert not st.values and not st.meta and not st.mv and not st.odd
    assert st.block.nbytes <= (n + 4096) * d * 4


def test_bad_dtype_raises():
    with pytest.raises(ValueError, match="f32|bf16"):
        ColumnarStore({}, dtype="int8")


# ---------------------------------------------------------------------------
# collection integration (test_columnar.py's TestCollectionIntegration)
# ---------------------------------------------------------------------------


def cols(**kw):
    return (jvt.Collection(name="c", dimensions=4, metric="cosine", **kw),
            tvt.Collection(name="c", dimensions=4, metric="cosine", device="cpu", **kw))


def ids(results):
    return [r.id for r in results]


def test_store_columnar_option():
    jc, tc = cols(store="columnar")
    assert isinstance(tc._store, ColumnarStore) and tc._store._dtype == "f32"
    for col in (jc, tc):
        col.put({"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]})
        col.put({"id": "b", "vector": [0.0, 1.0, 0.0, 0.0]})
    q = [1.0, 0.0, 0.0, 0.0]
    assert ids(tc.search(q, limit=1)) == ["a"] == ids(jc.search(q, limit=1))
    for col in (jc, tc):
        col.delete("a")
    assert ids(tc.search(q, limit=1)) == ["b"] == ids(jc.search(q, limit=1))


def test_compressed_collection_defaults_to_columnar_bf16():
    jc, tc = cols(compressed=True)
    assert isinstance(tc._store, ColumnarStore) and tc._store._dtype == "bf16"
    assert tc.index.storage == "bf16"
    for col in (jc, tc):
        col.put({"id": "a", "vector": [1.0, 0.0, 0.0, 0.0]})
    assert ids(tc.search([1.0, 0.0, 0.0, 0.0], limit=1)) == ["a"]
    # compressed with store="columnar" is bf16 too; another index keeps the
    # bf16 store
    _j, tc2 = cols(compressed=True, store="columnar", index="hnsw")
    assert tc2._store._dtype == "bf16"


def test_memory_store_remains_default():
    assert isinstance(cols()[1]._store, MemoryStore)


def test_columnar_snapshot_roundtrip_via_collection(tmp_path):
    jc, tc = cols(store="columnar")
    for col in (jc, tc):
        col.put_many([{"id": f"doc-{i}", "vector": [float(i == j) for j in range(4)]}
                      for i in range(4)])
    path = str(tmp_path / "col.snap")
    tc.snapshot(path)
    loaded = tvt.load_snapshot(path, store="columnar", device="cpu")
    assert isinstance(loaded._store, ColumnarStore)
    assert ids(loaded.search([0.0, 1.0, 0.0, 0.0], limit=1)) == ["doc-1"]
    # the default MemoryStore reads the same file, and so does the JAX package
    loaded2 = tvt.load_snapshot(path, device="cpu")
    assert ids(loaded2.search([0.0, 0.0, 1.0, 0.0], limit=1)) == ["doc-2"]
    jloaded = jvt.load_snapshot(path, store="columnar")
    assert ids(jloaded.search([0.0, 0.0, 1.0, 0.0], limit=1)) == ["doc-2"]


def test_compressed_collection_equals_bf16_oracle_and_jax(tmp_path):
    """``compressed=True`` at the size that takes the fused kernels' route
    (2,048 rows): the ids equal a float64 oracle over the bf16-rounded rows
    (the compressed semantics) and the JAX collection's; the snapshot keeps
    the compression."""
    n, d = 2048, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    names = [f"doc-{i:05d}" for i in rng.permutation(n)]
    qs = x[:8] + np.float32(0.05) * rng.standard_normal((8, d)).astype(np.float32)
    jc = jvt.Collection(name="z", dimensions=d, metric="cosine", compressed=True)
    tc = tvt.Collection(name="z", dimensions=d, metric="cosine", compressed=True, device="cpu")
    for col in (jc, tc):
        col.put_matrix(names, x)
    got = tc.search_batch(qs, limit=10)
    assert tc.index._fused_eligible(16) and tc.index.host_routes == 0
    stored = np.stack([np.asarray(tc.get(i).vector, np.float64) for i in names])
    np.testing.assert_array_equal(stored, t_round(x / np.linalg.norm(x, axis=1,
                                                                      keepdims=True)))
    q64 = qs.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    sims = q64 @ stored.T
    for b, row in enumerate(got):
        order = sorted(range(n), key=lambda i: (-sims[b, i], names[i]))[:10]
        assert ids(row) == [names[i] for i in order]
        np.testing.assert_allclose([r.score for r in row], sims[b, order], rtol=0, atol=1e-2)
    want = jc.search_batch(qs, limit=10)
    assert [ids(r) for r in got] == [ids(r) for r in want]
    for grow, wrow in zip(got, want):
        np.testing.assert_allclose([r.score for r in grow], [r.score for r in wrow],
                                   rtol=0, atol=SCORE_TOL)
    path = str(tmp_path / "z.snap")
    tc.snapshot(path)
    # as in the JAX package, the default loader keeps a MemoryStore of the
    # (bf16-exact) records and rebuilds a bf16 index; store="columnar" loads
    # the bf16 store
    for store, kind in ((None, MemoryStore), ("columnar", ColumnarStore)):
        loaded = tvt.load_snapshot(path, store=store, device="cpu")
        assert loaded.compressed and loaded.index.storage == "bf16"
        assert isinstance(loaded._store, kind)
        assert [ids(r) for r in loaded.search_batch(qs, limit=10)] == [ids(r) for r in got]
    assert loaded._store._dtype == "bf16"
