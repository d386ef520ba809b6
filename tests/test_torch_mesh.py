"""The port's mesh (``vettore_tpu_torch/parallel/mesh.py``) against the JAX
package's and against the single-device port, on the CPU.

``make_mesh`` over ``["cpu"] * n``: its grid, repeated devices and the
``data`` error. ``ShardedFlat``: the cases of ``tests/test_mesh.py`` (three
metrics, ties across shard boundaries, uneven rows, the merge's cost model)
over S in {1, 2, 3, 4, 8} virtual CPU shards and data in {1, 2}, against
the single-device ``FlatIndex`` (same ids in order, raws within 1e-5
relative) and against JAX's ``ShardedFlat`` on a 2-device JAX mesh (the
same ids, raws within 1e-5). With the fused threshold lowered the shards
run the kernel route (K1 + K2's plain versions on the CPU); a batch whose
fused search is not ``ok`` (a 64-way tie) reruns on the plain scan and is
counted. ``sharded_search(mesh, x, valid, lex_rank, queries, *, metric,
k)`` against JAX's on the same numpy blocks (2 and 4 virtual devices, data
1 and 2, f32 and bf16 rows, mass ties, shards on the plain scan and on the
fused search): the same slots, raws within 1e-6. The fused search's row
norms and bias are derived once for a block: repeated calls run no norm
pass, one distinct shard tensor one pass; an in-place write, a write
through a view or a replaced part of ``x`` or ``valid`` derives them anew,
and the search answers for the changed block as JAX's does.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

jax = pytest.importorskip("jax")

from vettore_tpu.parallel import ShardedFlat as JShardedFlat
from vettore_tpu.parallel import make_mesh as jmake_mesh
from vettore_tpu_torch import observability as obs
from vettore_tpu_torch.index import flat as tflat
from vettore_tpu_torch.index.flat import FlatIndex
from vettore_tpu_torch.ops import flat_scan
from vettore_tpu_torch.parallel import ShardedFlat, make_mesh, sharded_search
from vettore_tpu_torch.parallel import mesh as tmesh
from vettore_tpu_torch.parallel.cost import expected_merge_bytes, gathered_bytes

torch.set_num_threads(2)

METRICS = ("cosine", "l2", "inner_product")
LAYOUTS = [(s, d) for s in (1, 2, 3, 4, 8) for d in (1, 2)]


def corpus(n=100, d=16, seed=3):
    rng = np.random.default_rng(seed)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    ids = [f"doc-{i:03d}" for i in range(n)]
    return ids, vectors


def queries(count=5, d=16, seed=7):
    return np.random.default_rng(seed).normal(size=(count, d)).astype(np.float32)


def cpu_mesh(shards, data=1):
    return make_mesh(["cpu"] * (shards * data), data=data)


def single(metric, ids, vectors):
    index = FlatIndex(metric, device="cpu")
    index.put_many(zip(ids, vectors))
    return index


def assert_hits(got, want, rel=1e-5):
    """The same ids in order; raws within ``rel`` relative (min 1)."""
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for g_row, w_row in zip(got, want):
        for (_, g), (_, w) in zip(g_row, w_row):
            assert abs(g - w) <= rel * max(1.0, abs(w))


@pytest.mark.parametrize("devices,data,grid", [
    (["cpu"], 1, [["cpu"]]),
    (["cpu"] * 4, 1, [["cpu"] * 4]),
    (["cpu"] * 4, 2, [["cpu"] * 2, ["cpu"] * 2]),
    (["cpu"] * 8, 4, [["cpu"] * 2] * 4),
])
def test_make_mesh_grid(devices, data, grid):
    mesh = make_mesh(devices, data=data)
    assert [[str(d) for d in row] for row in mesh.devices] == grid
    assert mesh.shape == {"data": data, "shard": len(grid[0])}
    assert mesh.first == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu")]


@pytest.mark.parametrize("n,data", [(3, 2), (4, 3), (0, 1)])
def test_make_mesh_data_must_divide(n, data):
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(["cpu"] * n, data=data)


def test_make_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_repeated_devices_share_one_tensor_per_device():
    mesh = cpu_mesh(2, data=2)
    blocks = mesh.shard_rows(torch.arange(8.0).reshape(8, 1))
    assert blocks.rows == 4
    # both data rows hold shard s on the same device: one tensor
    assert blocks.shard(0, 0) is blocks.shard(0, 1)
    assert torch.equal(blocks.shard(1, 1)[:, 0], torch.arange(4.0, 8.0))


@pytest.fixture(scope="module")
def jax_results():
    """JAX's ShardedFlat on a 2-device mesh, per metric (one compile each)."""
    ids, vectors = corpus()
    mesh = jmake_mesh(jax.devices()[:2])
    return {m: JShardedFlat(m, mesh, ids, vectors).search_batch(queries(), 10)
            for m in METRICS}


@pytest.mark.parametrize("shards,data", LAYOUTS)
@pytest.mark.parametrize("metric", METRICS)
def test_sharded_equals_single_device_and_jax(metric, shards, data, jax_results):
    ids, vectors = corpus()
    sharded = ShardedFlat(metric, cpu_mesh(shards, data), ids, vectors)
    got = sharded.search_batch(queries(), 10)
    want = single(metric, ids, vectors).search_batch(queries(), 10)
    assert_hits(got, want)
    assert_hits(got, jax_results[metric])


@pytest.mark.parametrize("shards", [2, 8])
def test_sharded_tie_break_matches(shards):
    # duplicate vectors: ids order across shard boundaries, as in JAX
    ids = [f"t-{i:02d}" for i in range(64)]
    vectors = np.ones((64, 4), dtype=np.float32)
    sharded = ShardedFlat("l2", cpu_mesh(shards), ids, vectors)
    hits = sharded.search_batch(np.ones((1, 4), dtype=np.float32), 10)[0]
    assert [h[0] for h in hits] == ids[:10]
    jmesh = jmake_mesh(jax.devices()[:2])
    jhits = JShardedFlat("l2", jmesh, ids, vectors).search_batch(np.ones((1, 4), np.float32), 10)
    assert [h[0] for h in hits] == [h[0] for h in jhits[0]]


@pytest.mark.parametrize("shards", [3, 8])
def test_uneven_rows_pad(shards):
    ids, vectors = corpus(n=13)
    sharded = ShardedFlat("cosine", cpu_mesh(shards), ids, vectors)
    hits = sharded.search_batch(vectors[3][None, :], 5)[0]
    assert hits[0][0] == "doc-003"
    assert len(hits) == 5
    # every shard pads to whole 64-row groups
    assert sharded._x.rows % flat_scan.GROUP == 0


@pytest.mark.parametrize("data,k", [(1, 5), (2, 10)])
def test_merge_cost_model(data, k):
    """The stated merge cost model equals the bytes the gathers moved, with
    int32 lex and slot planes (JAX's ``test_ici_merge_cost_model``), for
    ``sharded_search`` over a ``ShardedFlat``'s blocks and for its own
    ``search_device``."""
    ids, vectors = corpus(n=64)
    mesh = cpu_mesh(4, data)
    sharded = ShardedFlat("cosine", mesh, ids, vectors)
    b = 4
    q = torch.from_numpy(vectors[:b])
    want = expected_merge_bytes(mesh.shape["shard"], b // data, k)
    assert gathered_bytes(mesh, sharded_search, mesh, sharded._x, sharded._valid, sharded._lex,
                          q, metric="cosine", k=k) == want
    assert gathered_bytes(mesh, sharded.search_device, q, k) == want


def test_sharded_search_refuses_another_mesh():
    """Blocks placed on another mesh (or not placed at all) are refused."""
    x, valid, lex, q = blocks_of(*raw_blocks(2, 64, 16))
    mesh, other = cpu_mesh(2), cpu_mesh(2)
    bx, bv, bl = mesh.shard_rows(x), mesh.shard_rows(valid), mesh.shard_rows(lex)
    with pytest.raises(ValueError, match="another mesh"):
        sharded_search(other, bx, bv, bl, q, metric="cosine", k=3)
    with pytest.raises(ValueError, match="another mesh"):
        sharded_search(mesh, bx, other.shard_rows(valid), bl, q, metric="cosine", k=3)
    with pytest.raises(ValueError, match="not placed"):
        sharded_search(mesh, x, bv, bl, q, metric="cosine", k=3)


# ---------------------------------------------------------------------------
# sharded_search(mesh, x, valid, lex_rank, queries, *, metric, k) against
# JAX's on the same numpy blocks: 2 and 4 (virtual) devices, data 1 and 2,
# f32 and bf16 rows, a mass-tie corpus, shards below FUSED_ROWS_MIN (the
# plain scan) and above it (lowered in the port only: the fused K1 + K2
# search). Slots equal, raws within 1e-6 where a slot is set.
# ---------------------------------------------------------------------------

JAX_LAYOUTS = [(2, 1), (2, 2), (4, 1), (4, 2)]  # (devices, data)


def raw_blocks(shards, rows, d, *, seed=11, ties=False):
    """A ``[shards * rows, d]`` block of unit rows (all ones under ``ties``),
    its validity (the last rows of every shard pads, a few live rows
    invalid) and its lex ranks (a permutation over the live rows, 2**31 - 1
    on pads), and 6 unit queries."""
    rng = np.random.default_rng(seed)
    n = shards * rows
    if ties:
        x = np.ones((n, d), np.float32)
        q = np.ones((6, d), np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        q = rng.normal(size=(6, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pad = (np.arange(n) % rows) >= rows - 3
    x[pad] = 0.0
    valid = ~pad
    valid[rng.choice(np.flatnonzero(valid), 4, replace=False)] = False
    lex = np.full(n, 2**31 - 1, np.int32)
    live = np.flatnonzero(~pad)
    lex[live] = rng.permutation(len(live)).astype(np.int32)
    return x, valid, lex, q


def blocks_of(x, valid, lex, q):
    return (torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(lex),
            torch.from_numpy(q))


def jax_search(devices, data, x, valid, lex, q, *, metric, k, bf16=False):
    import jax.numpy as jnp

    from vettore_tpu.parallel.mesh import sharded_search as jsharded_search

    jmesh = jmake_mesh(jax.devices()[:devices], data=data)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    slots, raws = jsharded_search(jmesh, jx, jnp.asarray(valid), jnp.asarray(lex),
                                  jnp.asarray(q), metric=metric, k=k)
    return np.asarray(slots), np.asarray(raws)


def port_search(devices, data, x, valid, lex, q, *, metric, k, bf16=False):
    mesh = cpu_mesh(devices // data, data)
    tx, tv, tl, tq = blocks_of(x, valid, lex, q)
    if bf16:
        tx = tx.to(torch.bfloat16)
    slots, raws = sharded_search(mesh, mesh.shard_rows(tx), mesh.shard_rows(tv),
                                 mesh.shard_rows(tl), tq, metric=metric, k=k)
    assert slots.dtype == torch.int32 and slots.device == mesh.first
    return slots.numpy(), raws.numpy(), mesh


def assert_same_search(got, want):
    g_slots, g_raws = got
    w_slots, w_raws = want
    assert np.array_equal(g_slots, w_slots)
    hit = w_slots >= 0
    assert np.abs(g_raws[hit] - w_raws[hit]).max(initial=0.0) <= 1e-6


@pytest.fixture(params=["plain", "fused"])
def route(request, monkeypatch):
    """Shards of 128 rows: the plain scan at the default FUSED_ROWS_MIN,
    the fused search with it lowered to 64 (the kernels' plain versions on
    the CPU). Counts the fused calls."""
    calls = {"n": 0, "route": request.param}
    if request.param == "fused":
        monkeypatch.setattr(tflat, "FUSED_ROWS_MIN", 64)
    real = flat_scan.fused_flat_search

    def counted(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(flat_scan, "fused_flat_search", counted)
    return calls


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("devices,data", JAX_LAYOUTS)
def test_sharded_search_equals_jax(route, devices, data, metric):
    blocks = raw_blocks(devices // data, 128, 16)
    got = port_search(devices, data, *blocks, metric=metric, k=10)
    assert_same_search(got[:2], jax_search(devices, data, *blocks, metric=metric, k=10))
    fused = route["route"] == "fused"
    assert route["n"] == (devices if fused else 0) and got[2].reruns == 0


@pytest.mark.parametrize("devices,data", JAX_LAYOUTS)
def test_sharded_search_bf16_rows_equal_jax(route, devices, data):
    x, valid, lex, q = raw_blocks(devices // data, 128, 16, seed=5)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # bf16-exact rows
    got = port_search(devices, data, x, valid, lex, q, metric="cosine", k=10, bf16=True)
    want = jax_search(devices, data, x, valid, lex, q, metric="cosine", k=10, bf16=True)
    assert_same_search(got[:2], want)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("devices,data", JAX_LAYOUTS)
def test_sharded_search_mass_ties_equal_jax(route, devices, data, metric):
    """Every live row ties: the (rank, lex rank) merge orders them, and a
    fused shard batch spills past its slack and reruns on the plain scan."""
    blocks = raw_blocks(devices // data, 128, 8, ties=True)
    got = port_search(devices, data, *blocks, metric=metric, k=10)
    assert_same_search(got[:2], jax_search(devices, data, *blocks, metric=metric, k=10))
    assert got[2].reruns == (devices if route["route"] == "fused" else 0)


@pytest.mark.parametrize("k", [5, 200])
def test_sharded_search_small_shards_equal_jax(k):
    """Shards of 40 rows (no whole 64-row group) and k past a shard's rows:
    the plain scan, as JAX's ``_local_topk``."""
    blocks = raw_blocks(4, 40, 16, seed=2)
    got = port_search(4, 1, *blocks, metric="cosine", k=k)
    assert_same_search(got[:2], jax_search(4, 1, *blocks, metric="cosine", k=k))


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_sharded_search_on_sharded_flat_blocks(route, metric):
    """``sharded_search`` over a ``ShardedFlat``'s own blocks returns its
    hits: global slot shard * rows + row there, shard * per + row in the
    index's layout."""
    ids, vectors = corpus(n=700)
    mesh = cpu_mesh(3)
    sharded = ShardedFlat(metric, mesh, ids, vectors)
    q = torch.from_numpy(queries())
    slots, raws = sharded_search(mesh, sharded._x, sharded._valid, sharded._lex, q,
                                 metric=metric, k=10)
    want_slots, want_raws = sharded.search_device(q, 10)
    rows = sharded._x.rows
    mapped = torch.where(slots >= 0, slots // rows * sharded.per + slots % rows, -1)
    assert torch.equal(mapped, want_slots) and torch.allclose(raws, want_raws, atol=1e-6)


def test_invalidate_ids_masks_rows():
    ids, vectors = corpus()
    sharded = ShardedFlat("cosine", cpu_mesh(4), ids, vectors)
    reference = single("cosine", ids, vectors)
    sharded.invalidate_ids(["doc-003", "doc-077", "missing"])
    reference.delete("doc-003")
    reference.delete("doc-077")
    assert_hits(sharded.search_batch(vectors[[3, 77]], 10), reference.search_batch(vectors[[3, 77]], 10))


@pytest.fixture
def fused_shards(monkeypatch):
    """Shards of 64 rows and more take the kernel route (on the CPU, the
    kernels' plain versions)."""
    monkeypatch.setattr(tflat, "FUSED_ROWS_MIN", 64)
    calls = {"n": 0}
    real = flat_scan.fused_flat_search

    def counted(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(flat_scan, "fused_flat_search", counted)
    return calls


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("shards,data", [(2, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_kernel_route_equals_single_device(fused_shards, metric, shards, data, storage):
    ids, vectors = corpus(n=700)
    sharded = ShardedFlat(metric, cpu_mesh(shards, data), ids, vectors, storage=storage)
    reference = FlatIndex(metric, storage=storage, device="cpu")
    reference.put_many(zip(ids, vectors))
    got = sharded.search_batch(queries(), 10)
    assert fused_shards["n"] == shards * data
    assert sharded.reruns == 0
    assert_hits(got, reference.search_batch(queries(), 10), rel=1e-5 if storage == "f32" else 1e-2)


def test_fused_tie_spill_reruns_on_the_plain_scan(fused_shards):
    """A 64-way tie at every shard's k-th place spills past the fused
    slack: each shard batch reruns on the plain scan, whose (rank, id)
    order is exact, and is counted."""
    ids = [f"t-{i:03d}" for i in range(256)]
    vectors = np.ones((256, 4), dtype=np.float32)
    sharded = ShardedFlat("l2", cpu_mesh(2), ids, vectors)
    hits = sharded.search_batch(np.ones((1, 4), dtype=np.float32), 10)[0]
    assert [h[0] for h in hits] == ids[:10]
    assert fused_shards["n"] == 2 and sharded.reruns == 2


# ---------------------------------------------------------------------------
# The fused search's row norms and row bias, derived once for a block
# (``Blocks.derived``) and kept while its shard tensors are unchanged: an
# in-place write, a write through a view or a replaced part derives them
# again, and the next search answers for the changed block as JAX does.
# ---------------------------------------------------------------------------

ROWS = 128
#: the written row is ``NEAR * q_0``: query 0's best row under l2 (squared
#: distance 0.09), and far enough from q_0 that JAX's expanded distance
#: (which cancels near 0) and the port's direct one agree within 1e-6
NEAR = 0.7


def placed(mesh, x, valid, lex, q):
    """The numpy blocks placed shard by shard, each shard a tensor of its
    own (a write to one leaves the others' versions), and the queries."""
    shards = mesh.shape["shard"]
    return (*(mesh.place([torch.from_numpy(p.copy()) for p in np.split(a, shards)])
              for a in (x, valid, lex)), torch.from_numpy(q))


def norm_passes(search):
    """``search()``'s slots and raws as numpy arrays, and the norm passes
    it ran (``mesh.norms`` under a profiler)."""
    with profile(activities=[ProfilerActivity.CPU]):
        slots, raws = search()
    return (slots.numpy(), raws.numpy()), obs.snapshot()["counters"].get("mesh.norms")


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("devices,data", JAX_LAYOUTS)
def test_repeated_searches_run_the_norm_pass_once(fused_shards, devices, data, metric):
    """Three calls over the same blocks answer as JAX's and as fresh
    blocks; the first runs one norm pass a distinct shard tensor (the data
    rows of a CPU mesh share one), the others none."""
    blocks = raw_blocks(devices // data, ROWS, 16)
    want = jax_search(devices, data, *blocks, metric=metric, k=10)
    mesh = cpu_mesh(devices // data, data)
    bx, bv, bl, tq = placed(mesh, *blocks)
    passes = []
    for _ in range(3):
        got, n = norm_passes(lambda: sharded_search(mesh, bx, bv, bl, tq, metric=metric, k=10))
        assert_same_search(got, want)
        passes.append(n)
    assert passes == [devices // data, 0, 0]
    fresh = port_search(devices, data, *blocks, metric=metric, k=10)
    assert np.array_equal(got[0], fresh[0]) and np.array_equal(got[1], fresh[1])


def _x_row_copy(bx, bv, i, near, top):
    """Shard 1's long row := ``near`` by ``copy_``."""
    bx.shard(1)[i].copy_(near)
    return 1


def _x_view_write(bx, bv, i, near, top):
    """The same, by slice assignment into a flat view of the shard."""
    d = near.shape[0]
    bx.shard(1).view(-1)[i * d:(i + 1) * d] = near
    return 1


def _x_mul(bx, bv, i, near, top):
    """The long row scaled by ``mul_`` to about ``near``."""
    bx.shard(1)[i].mul_(NEAR / 3)
    return 1


def _x_part_replaced(bx, bv, i, near, top):
    """Shard 1 replaced in ``parts`` (every data row) by a copy whose long
    row is ``near``."""
    new = bx.shard(1).clone()
    new[i] = near
    for row in bx.parts:
        row[1] = new
    return 1


def _valid_write(bx, bv, i, near, top):
    """Query 0's best row marked invalid in place."""
    bv.shard(top // ROWS)[top % ROWS] = False
    return 0


def _valid_part_replaced(bx, bv, i, near, top):
    """The same, the shard's validity replaced in ``parts``."""
    new = bv.shard(top // ROWS).clone()
    new[top % ROWS] = False
    for row in bv.parts:
        row[top // ROWS] = new
    return 0


WRITES = [_x_row_copy, _x_view_write, _x_mul, _x_part_replaced, _valid_write,
          _valid_part_replaced]


@pytest.mark.parametrize("write", WRITES, ids=lambda w: w.__name__.lstrip("_"))
@pytest.mark.parametrize("devices,data", [(2, 1), (4, 2)])
def test_a_changed_shard_is_never_served_stale_norms_or_bias(fused_shards, devices, data, write):
    """A live row of shard 1 starts as 3 q_0 (squared norm 9). Each write
    either makes it about ``NEAR * q_0``, query 0's best row, which the norm
    kept from before the write (9) would rank last in its shard, or marks
    query 0's best row invalid, which the bias kept from before would still
    let through. The next search equals JAX's on the changed block, not
    what the kept norms and bias give, and runs a norm pass on a changed
    ``x`` shard alone."""
    x, valid, lex, q = raw_blocks(devices // data, ROWS, 16, seed=4)
    i = int(np.flatnonzero(valid[ROWS:2 * ROWS])[0])
    x[ROWS + i] = 3 * q[0]
    mesh = cpu_mesh(devices // data, data)
    bx, bv, bl, tq = placed(mesh, x, valid, lex, q)
    search = lambda: sharded_search(mesh, bx, bv, bl, tq, metric="l2", k=10)  # noqa: E731
    before, passes = norm_passes(search)
    assert passes == devices // data
    kept = bx.derived("row_sq", None), bv.derived("bias", None)
    changed = write(bx, bv, i, NEAR * tq[0], int(before[0][0, 0]))
    got, passes = norm_passes(search)
    assert passes == changed
    x, valid = (torch.cat([b.shard(s) for s in range(mesh.shape["shard"])]).numpy()
                for b in (bx, bv))
    assert_same_search(got, jax_search(devices, data, x, valid, lex, q, metric="l2", k=10))
    stale, _raws, _reruns = tmesh._search_shards(mesh, bx, bv, bl, tq, metric="l2", k=10,
                                                 stride=ROWS, xsq=kept[0], bias=kept[1])
    assert not np.array_equal(got[0], stale.numpy())


def test_derived_keeps_one_entry_per_distinct_tensor():
    """Two data rows on one device share each shard's tensor, and its
    derived tensor: ``fn`` runs once a distinct tensor, again on a later
    call only for a tensor written since (shards cut from one tensor are
    views of it: a write to it is a write to each)."""
    mesh = cpu_mesh(2, data=2)
    base = torch.arange(8.0).reshape(8, 1)
    blocks = mesh.shard_rows(base)
    calls = []

    def twice(t):
        calls.append(t)
        return 2 * t

    first = blocks.derived("twice", twice)
    assert len(calls) == 2 and first.shard(0, 0) is first.shard(0, 1)
    again = blocks.derived("twice", twice)
    assert len(calls) == 2
    assert all(again.shard(s, r) is first.shard(s, r) for s in range(2) for r in range(2))
    blocks.derived("other", twice)
    assert len(calls) == 4
    base[0] = 7.0
    fresh = blocks.derived("twice", twice)
    assert len(calls) == 6 and fresh.shard(0, 1)[0].item() == 14.0


def test_derived_runs_on_every_call_over_inference_tensors():
    """A tensor made under ``torch.inference_mode`` keeps no version: its
    derived tensor is made anew each call, never kept."""
    with torch.inference_mode():
        blocks = cpu_mesh(2).shard_rows(torch.arange(8.0).reshape(8, 1))
    calls = []
    for _ in range(2):
        blocks.derived("twice", lambda t: calls.append(t) or 2 * t)
    assert len(calls) == 4
