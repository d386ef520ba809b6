"""The HNSW beam's captured steps against its eager loop, on the card.

On a CUDA device ``hnsw_device.search_impl`` replays each block of
``_DONE_EVERY`` layer-0 steps as a captured CUDA graph when the caller keeps
a ``BeamGraphs`` (the index's ``DeviceGraph.beams``, one per mesh shard).
Here the replayed search must give bit for bit what the eager loop gives at
the same shapes (the batch padded to its bucket by repeats of its first
query): on a 100,000-row bulk graph at B = 1, 7 and 512, in bf16 and f32
traversal, and with a step bound that ends on a one-step block. The step's
bf16 product with f32 output stays within 1e-5 of the widened product (the
CPU's), and a search of 512 queries finds the same ids through either. A
second call of a bucket captures nothing and replays; searches at many
``ef`` keep at most ``_BEAMS_KEPT`` beams, and the card's reserved memory
stays where those few put it; a ``put_many`` into the collection drops the
captures, and the next search captures anew and still equals the eager
loop; each shard of a mesh over two cards keeps its captures on its own
card. Every test needs a CUDA card and skips without one (the ``gpu``
marker)::

    python -m pytest -m gpu tests/test_torch_hnsw_graph_gpu.py -q
"""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import vettore_tpu_torch as vt
from vettore_tpu_torch import observability as obs
from vettore_tpu_torch.index import hnsw_device as hd

pytestmark = pytest.mark.gpu

N, D = 100_000, 96
OPTIONS = {"m": 16, "m0": 32, "ef_construction": 100, "ef_search": 64}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corpus(n, d, seed):
    """Unit rows in 100-row clusters, and queries near rows."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n // 100, d)).astype(np.float32)
    x = np.repeat(centres, 100, axis=0) + 0.4 * rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 512)] + 0.05 * rng.normal(size=(512, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


def _collection(device, seed=0):
    x, q = _corpus(N, D, seed)
    col = vt.Collection(name="g", dimensions=D, metric="cosine", index="hnsw",
                        index_options=OPTIONS, device=device)
    col.put_matrix([f"r{i:06d}" for i in range(N)], x)
    return col, x, q


@pytest.fixture(scope="module")
def bulk(cuda):
    col, x, q = _collection(cuda)
    assert col.index._bulk is not None
    return col, torch.from_numpy(q).to(cuda)


def _search(graph, q, *, beams, traversal="bf16", max_steps=None, ef=64):
    bf16 = traversal == "bf16"
    slots, block = graph.hubs(torch.bfloat16 if bf16 else torch.float32)
    return hd.search_impl(
        graph.x, graph.a0, graph.up_index, graph.up_adj, graph.lex_rank, graph.entry_slot,
        graph.entry_level, q, metric=graph.metric, lmax=graph.lmax, ef=ef, limit=10,
        max_steps=max_steps or hd.step_bound(ef), xb=graph.xb if bf16 else None,
        hub_slots=slots, hub_x=block, hub_valid=graph.hub_validity(), valid=graph.valid,
        beams=beams)


def _eager(graph, q, **kw):
    """The eager loop at the replay's shapes: ``q`` padded to its bucket by
    repeats of its first row, the pad rows' answers dropped."""
    b = q.shape[0]
    pad = hd._bucket(b) - b
    padded = torch.cat([q, q[:1].expand(pad, -1)]) if pad else q
    return tuple(t[:b] for t in _search(graph, padded, beams=None, **kw))


def _counted(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
        torch.cuda.synchronize()
    counters = obs.snapshot()["counters"]
    return out, counters.get("hnsw.captures", 0), counters.get("hnsw.replays", 0)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("traversal", ["bf16", "f32"])
@pytest.mark.parametrize("b", [1, 7, 512])
def test_replay_equals_the_eager_loop(bulk, b, traversal):
    col, q = bulk
    graph = col.index._device
    beams = hd.BeamGraphs()
    q = q[:b]
    want = _eager(graph, q, traversal=traversal)
    first, captures, replays = _counted(lambda: _search(graph, q, beams=beams,
                                                        traversal=traversal))
    assert captures == 1 and replays >= 1
    _assert_equal(first, want)
    # a second call of the bucket captures nothing and replays
    again, captures, replays = _counted(lambda: _search(graph, q, beams=beams,
                                                        traversal=traversal))
    assert captures == 0 and replays >= 1
    _assert_equal(again, want)
    ((key, beam),) = beams._beams.items()
    assert key[1] == hd._bucket(b) and beam.graph is not None and beam.d.is_cuda
    assert (want[0][:, 0] >= 0).all()


@pytest.mark.parametrize("metric", ["cosine", "inner_product", "l2"])
def test_traversal_rank_matches_the_widened_product(bulk, metric):
    """A step's scores of bf16 rows: the card's bf16 product with f32 output
    (dot metrics) against the widened f32 product, on gathered rows of the
    graph: exact products, f32 sums in another order."""
    col, q = bulk
    graph = col.index._device
    slots = torch.randint(0, graph.n, (64, 256), device=q.device)
    rows = graph.xb.index_select(0, slots.reshape(-1)).reshape(64, 256, -1)
    qt = q[:64].to(torch.bfloat16)
    got = hd._traversal_rank(rows, qt, metric)
    want = hd._rank_rows(rows, qt, metric)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5
    if metric == "l2":
        assert torch.equal(got, want)


def test_the_card_traversal_finds_what_the_widened_product_finds(bulk, monkeypatch):
    """The eager loop at B = 512 with the card's bf16 product, against the
    same loop with the CPU's widened product: the same ids and raw scores
    (the f32 epilogue scores whatever ids the traversal found)."""
    col, q = bulk
    graph = col.index._device
    got = _search(graph, q, beams=None)
    monkeypatch.setattr(hd, "_traversal_rank", hd._rank_rows)
    want = _search(graph, q, beams=None)
    _assert_equal(got, want)


def test_many_ef_keep_a_bounded_cache_and_bounded_memory(bulk):
    """Each ``ef`` above ``ef_search`` (a limit above it) is a key of its
    own: after three times ``_BEAMS_KEPT`` of them at B = 512, the graph
    keeps ``_BEAMS_KEPT`` beams, and once the allocator's cache is emptied
    the card holds what the first ``_BEAMS_KEPT`` held (each beam's bitset
    and its graph's memory pool, ~40 MB here, so the 3 x growth of a cache
    without a bound would show). The answers still equal the eager loop."""
    col, q = bulk
    graph = col.index._device
    beams = hd.BeamGraphs()
    kept = hd._BEAMS_KEPT
    efs = range(65, 65 + 3 * kept)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    base = reserved()
    for i, ef in enumerate(efs):
        got = _search(graph, q, beams=beams, ef=ef)
        if i == kept - 1:
            first = reserved()
    assert len(beams._beams) == kept
    assert [key[2] for key in beams._beams] == list(efs[-kept:])
    assert first > base
    assert reserved() - base <= (first - base) * 1.25
    _assert_equal(got, _eager(graph, q, ef=efs[-1]))


def test_a_bound_ending_on_a_one_step_block(bulk):
    """``max_steps`` 5: two replays, then one step run eagerly on the
    captured buffers."""
    col, q = bulk
    graph = col.index._device
    beams = hd.BeamGraphs()
    want = _eager(graph, q[:7], max_steps=5)
    for _ in range(2):
        got, _captures, replays = _counted(lambda: _search(graph, q[:7], beams=beams,
                                                           max_steps=5))
        _assert_equal(got, want)
    assert replays == 2


def test_collection_search_replays_with_one_capture_a_bucket(bulk):
    col, q = bulk
    qh = q[:64].cpu().numpy()
    col.search_batch(qh, limit=10)
    hits, captures, replays = _counted(lambda: col.search_batch(qh, limit=10))
    assert captures == 0 and replays >= 1
    assert all(len(row) == 10 for row in hits)
    slots, raws = hd.search_tensors(col.index, q[:64], 10)
    want = _eager(col.index._device, q[:64])
    assert torch.equal(slots, want[0]) and torch.equal(raws, want[1])


def test_put_many_drops_the_captures_and_the_next_search_recaptures(cuda):
    col, x, _q = _collection(cuda, seed=1)
    rng = np.random.default_rng(2)
    new = x[:300] + 0.01 * rng.normal(size=(300, D)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    qd = torch.from_numpy(new[:32]).to(cuda)
    hd.search_tensors(col.index, qd, 10)
    before = col.index._device.beams
    assert before._beams
    col.put_many([{"id": f"new{i:04d}", "vector": v.tolist()} for i, v in enumerate(new)])
    graph = col.index._device
    assert graph.beams is not before and not graph.beams._beams
    (slots, raws), captures, replays = _counted(lambda: hd.search_tensors(col.index, qd, 10))
    assert captures == 1 and replays >= 1
    want = _eager(graph, qd)
    assert torch.equal(slots, want[0]) and torch.equal(raws, want[1])
    # each query is a new row: it finds itself first
    assert [graph.ids[s] for s in slots[:, 0].tolist()] == [f"new{i:04d}" for i in range(32)]


def test_each_mesh_shard_captures_on_its_own_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from vettore_tpu_torch.parallel import make_mesh
    from vettore_tpu_torch.parallel.hnsw_mesh import ShardedHnsw

    x, q = _corpus(60_000, D, seed=3)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    sh = ShardedHnsw("cosine", make_mesh(cards), [f"m{i:05d}" for i in range(len(x))], x,
                     options=OPTIONS)
    qd = torch.from_numpy(q[:8])
    first = sh.search_device(qd, ef=64, k=10)
    again = sh.search_device(qd, ef=64, k=10)
    for s, card in enumerate(cards):
        ((key, beam),) = sh._beams[s]._beams.items()
        assert key[0] == card and beam.graph is not None
        assert beam.d.device == card and beam.visited.device == card
    caches = sh._beams
    sh._beams = [None, None]  # the eager loop on each shard
    want = sh.search_device(qd, ef=64, k=10)
    sh._beams = caches
    _assert_equal(first, want)
    _assert_equal(again, want)
