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
beam reads its convergence flags.
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
from vettore_tpu_torch.index.hnsw import HnswIndex as THnsw

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
