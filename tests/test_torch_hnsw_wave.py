"""The port's wave build (``index/hnsw_build.py``: ``bulk_build`` with
``build="wave"``, ``_wave_step``) against the JAX package's, on the CPU.

Both packages build from the same seeded 300 x 16 corpus in waves of 64
(the JAX ``bulk_build``'s ``wave=`` argument, the port's ``_wave_width``
patched: at the default width a corpus this small is a single wave, which
runs no beam). On integer-grid
corpora every rank is exact in f32 and bf16 and ties come in masses, so the
adjacency, levels, ranks, ``up_index`` and entry must be equal array for
array. On random unit vectors the graphs may differ only in rows where f32
sums of another order swap float64 near-ties (``_assert_graphs_agree``),
and recall@10 must lie within 0.01 of the JAX graph's. The port's graph
must not depend on how its work is split: the wave's true top level against
the JAX package's power-of-two bucket, the lane chunks, and how often the
beam reads its convergence flags. The build's layer beam, which takes the
search's step, is held bit for bit against the loop it replaced
(``_loop_beam_layer``, kept as it was).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from test_torch_hnsw_knn_build import _assert_graphs_agree
from vettore_tpu.index import hnsw_build as jbuild
from vettore_tpu.index.hnsw import HnswIndex as JHnsw
from vettore_tpu.index.hnsw import validate_options
from vettore_tpu_torch.index import hnsw_build as tbuild
from vettore_tpu_torch.index import hnsw_device as tdev
from vettore_tpu_torch.index.hnsw import HnswIndex as THnsw
from vettore_tpu_torch.ops.topk import smallest

torch.set_num_threads(2)

#: a narrow construct beam (ef_construction 8): where it starts decides what
#: it finds, so a wrong entry or descent shows in the graph
OPTS = {"m": 4, "m0": 8, "ef_construction": 8, "ef_search": 48, "build": "wave"}
PARAMS = validate_options(OPTS)
N, D, WAVE = 300, 16, 64
METRICS = ("cosine", "l2", "inner_product")
_REAL_WAVE_WIDTH = tbuild._wave_width


def _ids(seed):
    return [f"id-{i:05d}" for i in np.random.default_rng(seed).permutation(N)]


def _grid(seed):
    """Integer coordinates in [-3, 3]: exact in bf16, every dot product and
    squared distance an exact small integer, and many equal ranks."""
    return np.random.default_rng(seed).integers(-3, 4, size=(N, D)).astype(np.float32)


def _unit(seed):
    x = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module", autouse=True)
def waves_of_64():
    real = tbuild._wave_width
    tbuild._wave_width = lambda n: WAVE
    yield
    tbuild._wave_width = real


def _port(metric, data, ids):
    return tbuild.bulk_build(metric, PARAMS, ids, data, device="cpu")


@pytest.fixture(scope="module")
def grid_graphs(waves_of_64):
    """Both packages' graphs of one grid corpus per metric (one JAX compile
    set per metric, shared by the random corpora below)."""
    out = {}
    for k, metric in enumerate(METRICS):
        data, ids = _grid(k), _ids(k)
        out[metric] = (jbuild.bulk_build(metric, PARAMS, ids, data, wave=WAVE),
                       _port(metric, data, ids), data, ids)
    return out


@pytest.mark.parametrize("metric", METRICS)
def test_grid_graphs_equal_array_for_array(grid_graphs, metric):
    jg, tg, _data, _ids_ = grid_graphs[metric]
    assert tg.ids == jg.ids and tg.n == jg.n == N and tg.lmax == jg.lmax
    np.testing.assert_array_equal(tg.levels, jg.levels)
    for name in ("a0", "up_adj", "up_index", "lex_rank", "x"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert (tg.entry_slot, tg.entry_level) == (int(jg.entry_slot), int(jg.entry_level))
    assert tg.lmax >= 2 and (tg.a0.numpy() >= 0).sum(axis=1).min() >= 1


def _recall(cls, graph, metric, data, ids, queries):
    """recall@10 of a bulk graph, served by ``cls``'s index, against exact."""
    index = cls(metric, OPTS, **({"device": "cpu"} if cls is THnsw else {}))
    index._bulk = index._device = graph
    index._dim = D
    if metric == "l2":
        order = np.argsort(((queries[:, None] - data[None]) ** 2).sum(-1), axis=1)
    else:
        order = np.argsort(-(queries @ data.T), axis=1)
    hits = index.search_batch(queries.astype(np.float64), 10)
    return np.mean([len({h[0] for h in row} & {ids[j] for j in order[i, :10]}) / 10
                    for i, row in enumerate(hits)])


@pytest.mark.parametrize("metric", METRICS)
def test_random_graphs_agree(grid_graphs, metric):
    # the grid corpus's ids: the same levels, so the same JAX compile set
    ids = grid_graphs[metric][3]
    data = _unit(10 + len(metric))
    jg = jbuild.bulk_build(metric, PARAMS, ids, data, wave=WAVE)
    tg = _port(metric, data, ids)
    _assert_graphs_agree(metric, jg, tg)
    queries = data[::10] + 0.05 * np.random.default_rng(1).normal(size=(30, D)).astype(np.float32)
    rec_t = _recall(THnsw, tg, metric, data, ids, queries)
    rec_j = _recall(JHnsw, jg, metric, data, ids, queries)
    assert abs(rec_t - rec_j) <= 0.01 and rec_t >= 0.9, (rec_t, rec_j)


def _bucketed(lmax_wave, lmax):
    """The JAX package's power-of-two bucket of a wave's top level."""
    if lmax_wave > 2:
        b = 4
        while b < lmax_wave:
            b <<= 1
        return min(b, lmax)
    return lmax_wave


SPLITS = {
    "lmax_wave bucketed": lambda mp: mp.setattr(
        tbuild, "_wave_step", _with_lmax_wave(tbuild._wave_step, _bucketed)),
    "lmax_wave at lmax": lambda mp: mp.setattr(
        tbuild, "_wave_step", _with_lmax_wave(tbuild._wave_step, lambda lw, lmax: lmax)),
    "lanes in chunks of 7": lambda mp: mp.setattr(tbuild, "_lane_chunk", lambda n, **kw: 7),
    "lanes one by one": lambda mp: mp.setattr(tbuild, "_lane_chunk", lambda n, **kw: 1),
    "convergence read every step": lambda mp: mp.setattr(tbuild, "_DONE_EVERY", 1),
    "convergence read every 5 steps": lambda mp: mp.setattr(tbuild, "_DONE_EVERY", 5),
}


def _with_lmax_wave(step, top):
    def call(*args, **kw):
        return step(*args, **{**kw, "lmax_wave": top(kw["lmax_wave"], kw["lmax"])})
    return call


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_graph_does_not_depend_on_the_split(grid_graphs, monkeypatch, split, metric):
    """The same graph from the port whatever the split: the layers above
    the wave's true top level are fully masked, lanes search independently,
    and a converged lane's steps change nothing."""
    _jg, tg, data, ids = grid_graphs[metric]
    assert tg.levels[WAVE] < tg.lmax  # a wave below the top level
    SPLITS[split](monkeypatch)
    again = _port(metric, data, ids)
    for name in ("a0", "up_adj"):
        assert torch.equal(getattr(again, name), getattr(tg, name)), name


def test_wave_width_and_step_bound_follow_jax(monkeypatch):
    assert tbuild.BUILD_EXPAND_W == jbuild.BUILD_EXPAND_W
    for efc in (16, 32, 100, 400):
        assert tbuild.build_step_bound(efc) == jbuild.build_step_bound(efc)
    monkeypatch.setattr(tbuild, "_wave_width", _REAL_WAVE_WIDTH)
    widths = {n: tbuild._wave_width(n) for n in (300, 2**14, 2**17, 2**19, 10**6)}
    assert widths == {300: 1024, 2**14: 2048, 2**17: 4096, 2**19: 8192, 10**6: 8192}
    assert tbuild.INCR_WAVE_BUCKETS == jbuild.INCR_WAVE_BUCKETS
    for name in ("GROW_CHUNK", "REBUILD_FRACTION", "CAP_SLACK_MIN", "KNN_BUILD_MIN"):
        assert getattr(tbuild, name) == getattr(jbuild, name), name


def test_default_width_builds_through_the_index(grid_graphs, monkeypatch):
    """``build="wave"`` through ``HnswIndex`` and ``"auto"`` below
    ``KNN_BUILD_MIN`` take the wave build at the JAX package's width for
    the size (one wave of 1,024 here; ``test_torch_hnsw.py`` holds a
    one-wave graph against the JAX package's)."""
    _jg, _tg, data, ids = grid_graphs["cosine"]
    monkeypatch.setattr(tbuild, "_wave_width", lambda n: 1024)
    want = tbuild.bulk_build("cosine", PARAMS, ids, data, device="cpu")
    monkeypatch.setattr(tbuild, "_wave_width", _REAL_WAVE_WIDTH)
    for options in (OPTS, {k: v for k, v in OPTS.items() if k != "build"}):
        index = THnsw("cosine", options, device="cpu")
        index.BULK_THRESHOLD = 2
        index.put_matrix(ids, data)
        assert torch.equal(index._bulk.a0, want.a0)
        assert torch.equal(index._bulk.up_adj, want.up_adj)


def _loop_beam_layer(xt, adj, q, g, start, *, metric, ef, words, max_steps, seeds=None):
    """The build's layer beam as it was before it took the search's step:
    its own step body, the ``nbrs < start`` mask on the layer's rows
    (``adj`` without ``start``) and the pairwise ``[b, E, E]`` duplicate
    mask. Returns ``(dists [b, ef], slots [b, ef])``."""
    inf = float("inf")
    b, dev = q.shape[0], q.device
    W = min(tbuild.BUILD_EXPAND_W, ef)
    beam_d = torch.full((b, ef), inf, device=dev)
    beam_id = torch.full((b, ef), -1, dtype=torch.int64, device=dev)
    beam_exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((b, words), dtype=torch.int64, device=dev)
    if seeds is None:
        beam_d[:, 0] = tdev._rank_rows(xt[g][:, None, :], q, metric)[:, 0]
        beam_id[:, 0] = g
        tdev._set_bits(visited, g[:, None], torch.ones((b, 1), dtype=torch.bool, device=dev))
    else:
        sd, si = seeds
        ok = torch.isfinite(sd) & (si >= 0)
        beam_d[:, :sd.shape[1]] = sd.masked_fill(~ok, inf)
        beam_id[:, :sd.shape[1]] = si.masked_fill(~ok, -1)
        tdev._set_bits(visited, si.clamp_min(0), ok)

    final_d, final_id = beam_d.clone(), beam_id.clone()
    lanes = torch.arange(b, device=dev)
    earlier = None
    for step in range(max_steps):
        top_d, jpos = smallest(beam_d.masked_fill(beam_exp | (beam_id < 0), inf), W)
        done = torch.isinf(top_d[:, 0]) | (top_d[:, 0] > beam_d[:, -1])
        n_done = int(done.sum()) if step and step % tdev._DONE_EVERY == 0 else 0
        if n_done:
            order = torch.sort(done.to(torch.int8), stable=True).indices
            keep, gone = order[:done.numel() - n_done], order[done.numel() - n_done:]
            final_d[lanes[gone]], final_id[lanes[gone]] = beam_d[gone], beam_id[gone]
            if not keep.numel():
                break
            lanes, beam_d, beam_id = lanes[keep], beam_d[keep], beam_id[keep]
            beam_exp, visited, q = beam_exp[keep], visited[keep], q[keep]
            top_d, jpos, done = top_d[keep], jpos[keep], done[keep]
        expand_ok = torch.isfinite(top_d) & ~done[:, None]
        nodes = beam_id.gather(1, jpos).clamp_min(0)
        nbrs = adj(nodes)  # [b, W, deg]
        ok = ((nbrs >= 0) & (nbrs < start) & expand_ok[..., None]).flatten(1)
        nbrs = nbrs.flatten(1)
        E = nbrs.shape[1]
        if earlier is None:
            earlier = torch.ones((E, E), dtype=torch.bool, device=dev).tril(-1)  # j < i
        key = nbrs.masked_fill(~ok, -1)
        dup = ((key[:, None, :] == key[:, :, None]) & earlier).any(dim=2)
        safe = nbrs.clamp_min(0)
        word, shift = safe >> 5, safe & 31
        seen = (visited.gather(1, word) >> shift) & 1
        fresh = ok & ~dup & (seen == 0)
        visited.scatter_add_(1, word, fresh.long() << shift)
        rows = xt.index_select(0, safe.reshape(-1)).reshape(*safe.shape, -1)
        nd = tdev._rank_rows(rows, q, metric).masked_fill(~fresh, inf)
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_id = torch.cat([beam_id, nbrs.masked_fill(~fresh, -1)], dim=1)
        cat_exp = torch.cat([beam_exp.scatter(1, jpos, beam_exp.gather(1, jpos) | expand_ok),
                             torch.zeros_like(fresh)], dim=1)
        beam_d, keep = smallest(cat_d, ef)
        beam_id = cat_id.gather(1, keep)
        beam_exp = cat_exp.gather(1, keep)
    final_d[lanes], final_id[lanes] = beam_d, beam_id
    return final_d, final_id


@pytest.mark.parametrize("ef", [tbuild.BUILD_EXPAND_W, 16])
@pytest.mark.parametrize("start", ["half the graph", "the whole graph"])
@pytest.mark.parametrize("seeding,layer", [("entry", 0), ("entry", 1), ("hubs", 0)])
@pytest.mark.parametrize("metric", METRICS)
def test_layer_beam_equals_the_loop_it_replaced(grid_graphs, metric, seeding, layer, start, ef):
    """The build's ``_beam_layer`` on the search's step, held bit for bit
    against its own loop: 48 lanes of the grid graph (mass ties), from
    entry slots or from hub seeds as ``_construct_search`` makes them. With
    half the graph inserted, the rows of expanded nodes hold slots past
    ``start`` (ineligible) besides the neighbours they share; ``ef`` equal
    to W expands every entry of the beam at each step."""
    _jg, tg, _data, _ids = grid_graphs[metric]
    n, xt = tg.n, tg.xb
    # the layer's nodes are a slot prefix; an upper node's row is its slot
    nl = n if layer == 0 else int((tg.up_index >= 0).sum())
    cut = nl // 2 if start == "half the graph" else n
    rows = tg.a0[:nl] if layer == 0 else tg.up_adj[:nl, layer - 1]
    if cut < n:
        assert (rows[:cut] >= cut).any()
    q = xt[n - 48:]
    words = (n + 31) // 32
    g = torch.from_numpy(np.random.default_rng(layer).integers(0, min(cut, nl), size=48))
    seeds = None
    if seeding == "hubs":
        hd = tdev._rank_matrix(q, xt[:64], metric)
        hd[:, cut:] = float("inf")
        seed_d, hpos = smallest(hd, 4)
        seeds = (seed_d, torch.where(torch.isfinite(seed_d), hpos, -1))
    kw = {"metric": metric, "ef": ef, "words": words, "max_steps": tbuild.build_step_bound(ef),
          "seeds": seeds}
    got = tbuild._beam_layer(xt, tdev._adjacency(tg.a0, tg.up_adj, tg.up_index, layer, cut),
                             q, g, **kw)
    want = _loop_beam_layer(xt, tdev._adjacency(tg.a0, tg.up_adj, tg.up_index, layer), q, g,
                            cut, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[1][:, 0] >= 0).all() and (got[1] < cut).all()
