"""The port's IVF index (``vettore_tpu_torch/index/ivf.py``,
``ops/ivf.py``) against the JAX package's, on the CPU: the cases of
``tests/test_ivf.py`` and the IVF cases of ``tests/test_cov_gaps.py`` run
through both packages on the same numpy inputs, and the device ops as
functions on the same arrays. JAX runs its Pallas K2 in interpret mode; the
port runs K2's plain version.

Tolerances: k-means assignments and the cluster-major permutation are equal
(the corpora are laid out so every row's margin between its two nearest
centroids exceeds f32 summation noise, checked); centroids, row norms and raw
scores agree within 1e-6 (f32 sums in another order); bf16 routing
centroids are bit-equal; search ids are equal, in order.
"""

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu.index.flat import FlatIndex as JFlat
from vettore_tpu.index.ivf import IvfIndex as JIvf
from vettore_tpu.index.ivf import validate_options as j_validate
from vettore_tpu.ops import ivf as jops
from vettore_tpu_torch import convert
from vettore_tpu_torch.errors import (
    DimensionMismatch,
    InvalidIvfOptions,
    InvalidVector,
    UnsupportedIvfMetric,
)
from vettore_tpu_torch.index.flat import FlatIndex as TFlat
from vettore_tpu_torch.index.ivf import IvfIndex as TIvf
from vettore_tpu_torch.index.ivf import validate_options as t_validate
from vettore_tpu_torch.ops import ivf as tops

jnp = pytest.importorskip("jax.numpy")

torch.set_num_threads(2)

#: centroids, row norms and raw scores: f32 sums in another order
TOL = 1e-6


def clustered(n, d, centers=32, radius=0.35, seed=0, major=False):
    """Unit rows around ``centers`` unit centres (sigma radius/sqrt(d)).
    ``major`` lays the rows out cluster by cluster in equal runs, so the
    strided k-means init over ``centers`` centroids takes one row of each
    cluster and every row's nearest centroid wins by a wide margin."""
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((centers, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    a = np.repeat(np.arange(centers), n // centers) if major else rng.integers(0, centers, n)
    x = c[a] + np.float32(radius / np.sqrt(d)) * rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def uniform(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def ids_for(n):
    return [f"doc-{i:05d}" for i in range(n)]


def near(x, count, seed, noise=0.2):
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    qs = x[rng.integers(0, x.shape[0], count)] + np.float32(noise / np.sqrt(d)) * \
        rng.standard_normal((count, d)).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


def pair(metric, options):
    return JIvf(metric, options), TIvf(metric, options, device="cpu")


def assert_same(got, want, tol=TOL):
    """Hit lists of both packages: ids equal in order, raws within ``tol``."""
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        np.testing.assert_allclose([h[1] for h in grow], [h[1] for h in wrow],
                                   rtol=0, atol=tol)


def overlap(got, truth, k=10):
    return float(np.mean([len({i for i, _ in g} & {i for i, _ in t}) / k
                          for g, t in zip(got, truth)]))


def carried(j):
    """A port IvfIndex over ``j``'s records with ``j``'s build carried across
    by ``convert.ivf_state``."""
    t = TIvf(j.metric, dict(j.params), device="cpu")
    m = j._mirror
    live = [s for s, id in enumerate(m._ids) if id is not None]
    t.put_matrix([m._ids[s] for s in live], np.asarray(m._host_x, np.float32)[live])
    tail = None
    if j._tail is not None:
        tail = (j._tail._ids, np.asarray(j._tail._host_x), j._tail._valid)
    return convert.ivf_state(
        t, xb=np.asarray(j._xb), xsq=np.asarray(j._xsq), bias=np.asarray(j._bias),
        lex=np.asarray(j._lex), bcb=np.asarray(j._bcb), csq=np.asarray(j._csq),
        bbias=np.asarray(j._bbias), block_ids=j._block_ids, tuned=j.tuned, tail=tail,
        tombstoned=j._tombstoned)


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------


GOOD = [None, {"n_probe": 4}, {"n_probe": "auto"}, {"target_recall": 1},
        {"storage": "f32", "min_rows": 1, "rebuild_fraction": 1.0, "kmeans_iters": 64}]
BAD = [{"n_probe": 0}, {"n_probe": -1}, {"n_probe": True}, {"n_probe": 1 << 20},
       {"kmeans_iters": 0}, {"kmeans_iters": 65}, {"storage": "int4"}, {"min_rows": 0},
       {"rebuild_fraction": 0.0}, {"rebuild_fraction": 1.5}, {"rebuild_fraction": True},
       {"bogus": 1}, {"n_probe": "Auto"}, {"n_probe": "all"}, {"target_recall": 0.0},
       {"target_recall": 1.5}, {"target_recall": True}, {"target_recall": "high"}]


def test_option_validation_matrix():
    for good in GOOD:
        assert t_validate(good) == j_validate(good)
    for bad in BAD:
        with pytest.raises(InvalidIvfOptions) as got:
            t_validate(bad)
        with pytest.raises(jvt.errors.InvalidIvfOptions) as want:
            j_validate(bad)
        assert str(got.value) == str(want.value)


def test_metric_restriction():
    for metric in ("cosine", "l2", "inner_product", "negative_inner_product", "l2_squared"):
        JIvf(metric)
        TIvf(metric, device="cpu")
    for metric in ("hamming", "manhattan"):
        with pytest.raises(UnsupportedIvfMetric):
            TIvf(metric, device="cpu")
        with pytest.raises(jvt.errors.UnsupportedIvfMetric):
            JIvf(metric)


# ---------------------------------------------------------------------------
# small collections: exact delegation
# ---------------------------------------------------------------------------


def test_small_index_is_exact():
    x = clustered(200, 16, seed=1)
    pairs = list(zip(ids_for(200), x))
    j, t = pair("cosine", {"min_rows": 4096})
    flat = TFlat("cosine", device="cpu")
    for index in (j, t, flat):
        index.put_many(pairs)
    assert not t.built
    qs = clustered(5, 16, seed=2)
    got = t.search_batch(qs, 7)
    assert got == flat.search_batch(qs, 7)
    assert_same(got, j.search_batch(qs, 7))


# ---------------------------------------------------------------------------
# device ops as functions on the same arrays
# ---------------------------------------------------------------------------


def test_kmeans_assign_and_update_equal_jax():
    n, d, c = 1536, 32, 24
    x = clustered(n, d, centers=c, seed=3, major=True)
    valid = np.ones(n, bool)
    valid[-40:] = False  # dead rows ride along as zero rows
    x[~valid] = 0.0
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for metric in ("cosine", "l2"):
        got = tops.kmeans_assign(tx, torch.from_numpy(valid), n_cent=c, iters=3, metric=metric)
        want = jops.kmeans_assign(jx, jnp.asarray(valid), n_cent=c, iters=3, metric=metric)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[~valid] == c).all()
    # one update from the same assignment: centroids within TOL
    assign = np.asarray(want)
    assign = np.where(valid, assign, 0).astype(np.int32)
    cent0 = x[:: n // c][:c].copy()
    w = valid.astype(np.float32)
    got = tops._update_centroids(torch.from_numpy(cent0), tx, torch.from_numpy(w),
                                 torch.from_numpy(assign), n_cent=c)
    want = jops._update_centroids(jnp.asarray(cent0), jx, jnp.asarray(w), jnp.asarray(assign),
                                  n_cent=c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # the margin the equality rests on: each live row's best centroid beats
    # its second by far more than f32 summation noise (float64 here)
    cent = got.numpy().astype(np.float64)
    dots = np.sort(x[valid].astype(np.float64) @ cent.T, axis=1)
    assert (dots[:, -1] - dots[:, -2]).min() > 1e-3
    # one chunk's assignment from the same centroids, both routings
    for spherical in (True, False):
        csq = (cent0 * cent0).sum(axis=1)
        got = tops._assign_chunk(tx, torch.from_numpy(cent0), torch.from_numpy(csq),
                                 spherical=spherical)
        want = jops._assign_chunk(jx, jnp.asarray(cent0).astype(jnp.bfloat16).T,
                                  jnp.asarray(csq), spherical=spherical)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_update_centroids_ties_first_and_empty_keep():
    """An empty cluster keeps its centroid; argmax ties go to the first
    centroid in both packages."""
    x = np.array([[1, 0], [1, 0], [0, 1]], np.float32)
    cent = np.array([[1, 0], [1, 0], [5, 5]], np.float32)  # 0 and 1 tie
    for spherical in (True, False):
        csq = (cent * cent).sum(axis=1)
        got = tops._assign_chunk(torch.from_numpy(x), torch.from_numpy(cent),
                                 torch.from_numpy(csq), spherical=spherical)
        want = jops._assign_chunk(jnp.asarray(x), jnp.asarray(cent).astype(jnp.bfloat16).T,
                                  jnp.asarray(csq), spherical=spherical)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assign = np.array([0, 0, 0], np.int32)
    w = np.ones(3, np.float32)
    got = tops._update_centroids(torch.from_numpy(cent), torch.from_numpy(x),
                                 torch.from_numpy(w), torch.from_numpy(assign), n_cent=3)
    want = jops._update_centroids(jnp.asarray(cent), jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(assign), n_cent=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert got[1].tolist() == [1.0, 0.0] and got[2].tolist() == [5.0, 5.0]


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_build_blocks_and_gather_equal_jax(metric):
    n, d = 640, 24
    x = clustered(n, d, seed=4)
    x[::7] *= 3.0  # norms other than 1: the cosine routing centroids renormalise
    idx = np.arange(n, dtype=np.int32)[::-1].copy()
    idx[-70:] = -1  # pad rows: the last block is all dead
    got = tops.gather_lex_rows(torch.from_numpy(x), torch.from_numpy(idx))
    want = jops.gather_lex_rows(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    valid = idx >= 0
    got = tops.build_blocks(got, torch.from_numpy(valid), metric=metric)
    want = jops.build_blocks(want, jnp.asarray(valid), metric=metric)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0]).astype(np.float32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(-1), rtol=TOL, atol=TOL)
    assert np.isinf(got[2].numpy()[-1]) and np.isinf(got[4].numpy()[-70:]).all()


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_merge_with_tail_equals_jax(metric):
    rng = np.random.default_rng(5)
    b, k, kt, capb = 4, 6, 5, 128
    slots = rng.integers(0, capb, (b, k)).astype(np.int32)
    raws = rng.standard_normal((b, k)).astype(np.float32)
    ranks = {"cosine": 1.0 - raws, "inner_product": -raws}.get(metric, raws).astype(np.float32)
    ranks[0, -2:] = np.inf  # fewer built hits than k
    ranks[1, :] = ranks[1, 0]  # rank ties: broken by the lex keys
    lex = rng.permutation(capb)[slots].astype(np.int32)
    t_slots = rng.integers(0, 9, (b, kt)).astype(np.int32)
    t_slots[2, -2:] = -1  # tail pads
    t_raws = rng.standard_normal((b, kt)).astype(np.float32)
    t_raws[1, :2] = raws[1, 0]  # a tail row tied with built rows: built first
    got = tops.merge_with_tail(*(torch.from_numpy(a) for a in (slots, raws, ranks, lex,
                                                               t_slots, t_raws)),
                               metric=metric, k=k, capb=capb)
    want = jops.merge_with_tail(*(jnp.asarray(a) for a in (slots, raws, ranks, lex, t_slots,
                                                           t_raws)),
                                metric=metric, k=k, capb=capb)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# built path: one pair per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """The JAX tests' built pair (1536 x 32 cosine, f32 storage, n_probe 6,
    3 k-means iterations) in both packages, on a cluster-major corpus (24
    clusters for the 24 blocks), and exact flat indexes of both."""
    n, d = 1536, 32
    x = clustered(n, d, centers=24, seed=6, major=True)
    ids = ids_for(n)
    opts = {"min_rows": 256, "n_probe": 6, "kmeans_iters": 3, "storage": "f32"}
    j, t = pair("cosine", opts)
    jflat, tflat = JFlat("cosine"), TFlat("cosine", device="cpu")
    for index in (j, t, jflat, tflat):
        index.put_matrix(ids, x)
    j.rebuild()
    t.rebuild()
    return {"j": j, "t": t, "jflat": jflat, "tflat": tflat, "x": x, "ids": ids,
            "qs": near(x, 16, seed=7)}


def test_build_equals_jax(built):
    j, t = built["j"], built["t"]
    np.testing.assert_array_equal(t._lex.numpy(), np.asarray(j._lex))
    assert t._block_ids == j._block_ids
    assert t._block_slot_of == j._block_slot_of
    np.testing.assert_array_equal(t._xb.numpy(), np.asarray(j._xb))
    np.testing.assert_array_equal(t._bcb.float().numpy(), np.asarray(j._bcb).astype(np.float32))
    for got, want in ((t._xsq, j._xsq), (t._csq, j._csq), (t._bias, j._bias),
                      (t._bbias, j._bbias)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1), rtol=0, atol=TOL)


def test_built_recall_against_flat(built):
    t, qs = built["t"], built["qs"]
    truth = built["tflat"].search_batch(qs, 10)
    got = t.search_batch(qs, 10)
    assert t.built
    assert overlap(got, truth) >= 0.9
    assert_same(got, built["j"].search_batch(qs, 10))


@pytest.mark.parametrize("nprobe", [1, 2, 6])
def test_search_on_carried_build_equals_jax(built, nprobe):
    """The JAX build carried across: every probe count gives the same ids and
    raws within TOL, through the index and through ``ivf_search`` itself."""
    j, qs = built["j"], built["qs"]
    t = carried(j)
    j.params["n_probe"] = t.params["n_probe"] = nprobe
    try:
        assert_same(t.search_batch(qs, 10), j.search_batch(qs, 10))
        got = tops.ivf_search(t._xb, t._xsq, t._bias, t._lex, t._bcb, t._csq, t._bbias,
                              torch.from_numpy(qs), metric="cosine", nprobe=nprobe, k=10)
        want = jops.ivf_search(j._xb, j._xsq, j._bias, j._lex, j._bcb, j._csq, j._bbias,
                               jnp.asarray(qs), metric="cosine", nprobe=nprobe, k=10)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    finally:
        j.params["n_probe"] = 6


def test_full_probe_equals_exact_flat(built):
    """n_probe >= n_blocks probes everything: results equal the exact flat
    scan including raw values and (rank, id) tie order."""
    x, ids, qs = built["x"], built["ids"], built["qs"]
    j, t = pair("cosine", {"min_rows": 256, "n_probe": 65_536, "kmeans_iters": 2,
                           "storage": "f32"})
    j.put_matrix(ids, x)
    t.put_matrix(ids, x)
    got = t.search_batch(qs, 10)
    assert_same(got, built["tflat"].search_batch(qs, 10), tol=1e-5)
    assert_same(got, j.search_batch(qs, 10))


def test_full_probe_tie_order():
    """Duplicate vectors force rank ties; full-probe IVF breaks them by id
    exactly like the flat oracle (flat.rs:34-40), in both packages."""
    d = 16
    row = np.ones(d, np.float32) / np.sqrt(d)
    n = 512
    x = np.tile(row, (n, 1))
    ids = [f"tie-{i:04d}" for i in range(n)][::-1]  # inserted out of id order
    j, t = pair("cosine", {"min_rows": 64, "n_probe": 65_536})
    flat = TFlat("cosine", device="cpu")
    for index in (j, t, flat):
        index.put_matrix(ids, x)
    got = t.search_batch(np.stack([row, -row]), 5)
    assert got[0] == flat.search(row, 5)
    assert [id for id, _ in got[0]] == [f"tie-{i:04d}" for i in range(5)]
    assert [id for id, _ in got[1]] == [f"tie-{i:04d}" for i in range(5)]
    assert_same(got, j.search_batch(np.stack([row, -row]), 5))


def test_mass_ties_at_full_probe_on_carried_build():
    """512 copies of four rows: every rank ties 128 ways, across blocks; the
    port on JAX's build gives JAX's ids at every probe count up to every
    block, each hit at the best distance. (IVF sorts only the ``k +
    TIE_PAD`` best candidates by id, as in the JAX package, so past that
    many ties its ids need not be the flat scan's lowest.)"""
    d = 8
    base = np.eye(4, d, dtype=np.float32)
    x = np.repeat(base, 128, axis=0)
    ids = [f"m-{i:04d}" for i in np.random.default_rng(8).permutation(512)]
    j = JIvf("l2", {"min_rows": 64, "n_probe": 65_536, "storage": "f32"})
    j.put_matrix(ids, x)
    j.rebuild()
    t = carried(j)
    qs = base + np.float32(0.01)
    for p in (3, 65_536):
        j.params["n_probe"] = t.params["n_probe"] = p
        got = t.search_batch(qs, 20)
        assert_same(got, j.search_batch(qs, 20))
    flat = TFlat("l2", device="cpu")
    flat.put_matrix(ids, x)
    for grow, wrow in zip(got, flat.search_batch(qs, 20)):
        np.testing.assert_allclose([h[1] for h in grow], [h[1] for h in wrow], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "inner_product", "l2_squared"])
def test_full_probe_other_metrics(metric):
    n, d = 768, 24
    x = clustered(n, d, seed=9)
    ids = ids_for(n)
    j, t = pair(metric, {"min_rows": 128, "n_probe": 65_536, "storage": "f32"})
    flat = TFlat(metric, device="cpu")
    for index in (j, t, flat):
        index.put_matrix(ids, x)
    qs = clustered(4, d, seed=10)
    got = t.search_batch(qs, 8)
    assert_same(got, flat.search_batch(qs, 8), tol=1e-5)
    assert_same(got, j.search_batch(qs, 8))


# ---------------------------------------------------------------------------
# mutations after build
# ---------------------------------------------------------------------------


def full_pair(built, **extra):
    """A full-probe pair over the built corpus, built."""
    j, t = pair("cosine", {"min_rows": 256, "n_probe": 65_536, "storage": "f32", **extra})
    for index in (j, t):
        index.put_matrix(built["ids"], built["x"])
        index.search(built["x"][0], 1)  # build is lazy: first search constructs
    assert j.built and t.built
    return j, t


def test_insert_after_build_merges_tail(built):
    x, ids = built["x"], built["ids"]
    j, t = full_pair(built)
    fresh = clustered(8, x.shape[1], seed=99)
    fresh_ids = [f"new-{i}" for i in range(8)]
    for index in (j, t):
        index.put_many(list(zip(fresh_ids, fresh)))
    qs = np.stack([fresh[0], x[5]])
    got = t.search_batch(qs, 3)
    assert got[0][0][0] == "new-0" and got[1][0][0] == ids[5]
    assert len(t._tail) == 8
    assert_same(got, j.search_batch(qs, 3))


def test_replace_after_build_uses_new_vector(built):
    x, ids = built["x"], built["ids"]
    j, t = full_pair(built)
    target = -x[7] / np.linalg.norm(x[7])
    slot = t._block_slot_of[ids[7]]
    for index in (j, t):
        index.put(ids[7], target)
    # the built row is tombstoned in place; the new vector waits in the tail
    assert np.isinf(t._bias[slot].item()) and t._block_ids[slot] is None
    assert ids[7] not in t._block_slot_of and t._tombstoned == 1 and len(t._tail) == 1
    qs = np.stack([target, x[7]])
    got = t.search_batch(qs, 5)
    assert got[0][0][0] == ids[7]
    returned = dict(got[1])
    if ids[7] in returned:  # only legal if the new vector genuinely ranks
        assert returned[ids[7]] == pytest.approx(float(x[7] @ target), abs=1e-3)
    assert_same(got, j.search_batch(qs, 5))


def test_delete_after_build_excludes_id(built):
    x, ids = built["x"], built["ids"]
    j, t = full_pair(built)
    slot = t._block_slot_of[ids[3]]
    for index in (j, t):
        index.delete(ids[3])
    assert np.isinf(t._bias[slot].item()) and t._block_ids[slot] is None
    got = t.search_batch(x[3][None], 5)
    assert all(id != ids[3] for id, _ in got[0])
    assert len(t) == len(ids) - 1
    assert_same(got, j.search_batch(x[3][None], 5))


def test_rebuild_trigger_after_heavy_mutation():
    n, d = 1024, 16
    x = clustered(n, d, seed=11)
    ids = ids_for(n)
    j, t = pair("cosine", {"min_rows": 128, "n_probe": 65_536, "rebuild_fraction": 0.1,
                           "storage": "f32"})
    extra = clustered(256, d, seed=5)
    extra_ids = [f"x-{i}" for i in range(256)]
    for index in (j, t):
        index.put_matrix(ids, x)
        index.search(x[0], 1)
        assert index.built
        index.put_many(list(zip(extra_ids, extra)))
    # 256 > max(64, 0.1 * 1024): the next search rebuilds (tail folded in)
    got = t.search_batch(x[:2], 3)
    assert t._tail is None or not len(t._tail)
    assert len(t._block_slot_of) == n + 256
    assert_same(got, j.search_batch(x[:2], 3))


def test_delete_everything_resets():
    n, d = 512, 8
    x = clustered(n, d, seed=12)
    ids = ids_for(n)
    t = TIvf("cosine", {"min_rows": 64, "n_probe": 4}, device="cpu")
    t.put_matrix(ids, x)
    t.search(x[0], 1)
    assert t.built
    for id in ids:
        t.delete(id)
    assert len(t) == 0
    assert not t.built and t._tail is None and t._built_version == -1
    assert t.search(x[0], 3) == []


# ---------------------------------------------------------------------------
# the IVF cases of tests/test_cov_gaps.py: from_flat, the device path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wrapped():
    """``from_flat`` wrappers (n_probe 8, bf16 storage) of flat indexes of
    both packages over the same 6,000 x 16 corpus, built."""
    rng = np.random.default_rng(2)
    c = rng.normal(size=(40, 16)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    data = c[rng.integers(0, 40, 6000)] + 0.05 * rng.normal(size=(6000, 16)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    ids = ids_for(len(data))
    out = {"data": data, "ids": ids}
    for name, flat_cls, ivf_cls, kw in (("j", JFlat, JIvf, {}),
                                        ("t", TFlat, TIvf, {"device": "cpu"})):
        flat = flat_cls("cosine", **kw)
        flat.put_matrix(ids, data)
        out[name] = ivf_cls.from_flat(flat, {"n_probe": 8})
        out[name].rebuild()
    return out


def test_from_flat_shares_mirror(wrapped):
    t, data = wrapped["t"], wrapped["data"]
    assert len(t) == len(wrapped["ids"])
    assert t.dimension == data.shape[1]
    assert t.built and t._xb.dtype == torch.bfloat16
    assert t.device == t._mirror.device == torch.device("cpu")


def test_device_search_matches_host_path(wrapped):
    t, data = wrapped["t"], wrapped["data"]
    q = data[:4]
    host = t.search_batch(q.astype(np.float64), 5)
    slots, raws = t.search_batch_device(torch.from_numpy(q), 5)
    vocab = t.ids_by_slot()
    for b, row in enumerate(host):
        got = [(vocab[int(s)], float(r)) for s, r in zip(slots[b], raws[b]) if s >= 0]
        assert [g[0] for g in got[: len(row)]] == [h[0] for h in row]
    assert_same(host, wrapped["j"].search_batch(q.astype(np.float64), 5))


def test_device_search_merges_pending_tail(wrapped):
    t, j, data = wrapped["t"], wrapped["j"], wrapped["data"]
    probe = data[7] / np.linalg.norm(data[7])
    q = probe[None, :].astype(np.float32)
    for index in (j, t):
        index.put("zz-tail-hit", probe)  # tail row, not in the built block
    try:
        host = t.search_batch(q.astype(np.float64), 3)
        assert host[0][0][0] == "zz-tail-hit"
        slots, raws = t.search_batch_device(torch.from_numpy(q), 3)
        jslots, jraws = j.search_batch_device(jnp.asarray(q), 3)
        vocab = t.ids_by_slot()
        assert vocab[int(slots[0, 0])] == "zz-tail-hit"  # merge_with_tail surfaced it
        assert [vocab[int(s)] for s in slots[0]] == [
            j.ids_by_slot()[int(s)] for s in np.asarray(jslots)[0]]
        np.testing.assert_allclose(raws.numpy(), np.asarray(jraws), rtol=0, atol=TOL)
        cand, ok = t.candidate_slots_device(torch.from_numpy(q), 3)
        assert torch.equal(cand, slots) and bool(ok.all())
    finally:
        for index in (j, t):
            index.delete("zz-tail-hit")  # also walks the tail-delete path
    assert len(t) == len(wrapped["ids"])


def test_query_validation_raises(wrapped):
    t, j, d = wrapped["t"], wrapped["j"], wrapped["data"].shape[1]
    bad = np.ones((1, d))
    bad[0, 0] = np.inf
    for queries, err in ((np.ones((2, 2, 2)), InvalidVector),
                         (np.ones((1, d + 3)), DimensionMismatch), (bad, InvalidVector)):
        with pytest.raises(err) as got:
            t.search_batch(queries, 3)
        with pytest.raises(getattr(jvt.errors, err.__name__)) as want:
            j.search_batch(queries, 3)
        assert str(got.value) == str(want.value)


def test_from_flat_of_a_bf16_view_shares_the_lex_order():
    """``storage_view`` shares the host lex order, so an IVF index can wrap a
    view (the JAX view does not carry it)."""
    x = clustered(1024, 16, seed=13)
    ids = ids_for(1024)[::-1]
    flat = TFlat("cosine", device="cpu")
    flat.put_matrix(ids, x)
    view = flat.storage_view("bf16")
    assert view._lex_order_np is flat._lex_order_np
    assert [flat._ids[s] for s in flat._lex_order_np[:3]] == ["doc-00000", "doc-00001",
                                                              "doc-00002"]
    ivf = TIvf.from_flat(view, {"n_probe": 65_536, "min_rows": 64})
    ivf.rebuild()
    qs = near(x, 4, seed=14)
    assert [[i for i, _ in row] for row in ivf.search_batch(qs, 5)] == [
        [i for i, _ in row] for row in view.search_batch(qs, 5)]


# ---------------------------------------------------------------------------
# n_probe="auto" (build-time recall tuning)
# ---------------------------------------------------------------------------


def auto_pair(x, target=0.9):
    j, t = pair("cosine", {"min_rows": 256, "n_probe": "auto", "kmeans_iters": 3,
                           "storage": "f32", "target_recall": target})
    for index in (j, t):
        index.put_matrix(ids_for(x.shape[0]), x)
        index.search_batch(x[:1], 1)  # triggers build + tune
        assert index.built and index.tuned is not None
    assert t.tuned == j.tuned
    return j, t


def test_auto_n_probe_meets_target_and_escalates():
    """The auto tune meets its target on a clustered corpus, holds up on
    held-out queries, and picks more probes on the structureless sphere; the
    port tunes to JAX's probe count and recall on both."""
    n, d = 1536, 32
    x = clustered(n, d, centers=24, seed=5, major=True)
    j, t = auto_pair(x)
    p = t.effective_n_probe()
    assert isinstance(p, int) and 1 <= p <= n // 64
    assert t.tuned["n_probe"] == p and t.tuned["target"] == 0.9
    assert t.tuned["recall_at_10"] >= 0.9
    flat = TFlat("cosine", device="cpu")
    flat.put_matrix(ids_for(n), x)
    qs = near(x, 16, seed=9)
    got = t.search_batch(qs, 10)
    assert overlap(got, flat.search_batch(qs, 10)) >= 0.8
    assert_same(got, j.search_batch(qs, 10))
    _jh, hard = auto_pair(uniform(n, d, 5))
    assert hard.tuned["n_probe"] > t.tuned["n_probe"]
    assert hard.tuned["recall_at_10"] >= 0.9 or hard.tuned["n_probe"] == n // 64


def test_auto_n_probe_retunes_on_rebuild():
    n, d = 1024, 16
    t = TIvf("cosine", {"min_rows": 256, "n_probe": "auto", "kmeans_iters": 3,
                        "storage": "f32", "target_recall": 0.9}, device="cpu")
    t.put_matrix(ids_for(n), clustered(n, d, seed=13))
    t.search_batch(np.ones((1, d)), 1)
    first = dict(t.tuned)
    # heavy mutation forces a rebuild -> a fresh tune on the new geometry
    extra = uniform(512, d, 14)
    t.put_matrix([f"new-{i:04d}" for i in range(512)], extra)
    t.search_batch(extra[:1], 1)
    assert t.tuned is not None and t.tuned["target"] == first["target"]
    assert t._built_version == t._version


# ---------------------------------------------------------------------------
# collection integration
# ---------------------------------------------------------------------------


def col_pair(d, **kw):
    return (jvt.Collection(name="j", dimensions=d, metric="cosine", **kw),
            tvt.Collection(name="t", dimensions=d, metric="cosine", device="cpu", **kw))


def hits(results):
    return [(r.id, r.score) for r in results]


def test_collection_ivf_end_to_end(tmp_path):
    n, d = 1024, 24
    x = clustered(n, d, seed=15)
    ids = ids_for(n)
    jc, tc = col_pair(d, index="ivf", index_options={"min_rows": 128, "n_probe": 65_536})
    for col in (jc, tc):
        col.put_matrix(ids, x)
    assert isinstance(tc.index, TIvf) and tc.index_kind == "ivf"
    res = tc.search(x[11], limit=5)
    assert res[0].id == ids[11]
    # default ivf storage is bf16: raw values carry ~1e-2 storage noise
    assert res[0].score == pytest.approx(1.0, abs=2e-2)
    assert_same([hits(res)], [hits(jc.search(x[11], limit=5))])
    assert tc.index._xb.dtype == torch.bfloat16

    # snapshot round-trip rebuilds the index from canonical records
    snap = str(tmp_path / "ivf.snap")
    tc.snapshot(snap)
    loaded = tvt.load_snapshot(snap, device="cpu")
    assert loaded.index_kind == "ivf"
    assert [r.id for r in loaded.search(x[11], limit=5)] == [r.id for r in res]
    loaded.close()

    # hybrid default generators on an ivf collection: [search, quantized]
    assert tc._default_generators() == ["search", "quantized"]
    got = tc.hybrid_search(x[11], limit=5)
    assert got[0].id == ids[11]
    assert_same([hits(got)], [hits(jc.hybrid_search(x[11], limit=5))])
    jc.close()
    tc.close()


def test_collection_ivf_index_override_on_load(tmp_path):
    n, d = 300, 12
    x = clustered(n, d, seed=16)
    col = tvt.Collection(name="c", dimensions=d, metric="cosine", index="flat", device="cpu")
    col.put_many([{"id": f"r{i}", "vector": [float(v) for v in x[i]]} for i in range(n)])
    snap = str(tmp_path / "c.snap")
    col.snapshot(snap)
    opts = {"min_rows": 64, "n_probe": 65_536}
    loaded = tvt.load_snapshot(snap, index="ivf", index_options=opts, device="cpu")
    jloaded = jvt.load_snapshot(snap, index="ivf", index_options=opts)
    assert loaded.index_kind == "ivf" and isinstance(loaded.index, TIvf)
    res = loaded.search([float(v) for v in x[42]], limit=3)
    assert res[0].id == "r42"
    assert_same([hits(res)], [hits(jloaded.search([float(v) for v in x[42]], limit=3))])
    # the override persists through a later snapshot
    loaded.snapshot(snap)
    assert tvt.load_snapshot(snap, device="cpu").index_kind == "ivf"
    loaded.close()
    jloaded.close()
    col.close()


def test_auto_n_probe_snapshot_round_trip(tmp_path):
    n, d = 640, 16
    x = clustered(n, d, seed=17)
    col = tvt.Collection(name="auto", dimensions=d, metric="cosine", index="ivf",
                         index_options={"min_rows": 64, "n_probe": "auto", "storage": "f32",
                                        "target_recall": 0.9}, device="cpu")
    col.put_many([{"id": f"r{i:04d}", "vector": [float(v) for v in x[i]]} for i in range(n)])
    res = col.search([float(v) for v in x[7]], limit=5)
    assert len(res) == 5
    snap = str(tmp_path / "auto.snap")
    col.snapshot(snap)
    jloaded = jvt.load_snapshot(snap)  # the JAX package reads the port's file
    loaded = tvt.load_snapshot(snap, device="cpu")
    assert loaded.index_kind == "ivf"
    assert loaded.index.params["n_probe"] == "auto"
    # the rebuild re-runs k-means + the tune deterministically: the loaded
    # collection answers identically, including the re-tuned probe count
    res2 = loaded.search([float(v) for v in x[7]], limit=5)
    assert hits(res2) == hits(res)
    loaded.index._ensure_built()
    assert loaded.index.tuned == col.index.tuned
    assert_same([hits(res2)], [hits(jloaded.search([float(v) for v in x[7]], limit=5))])
    jloaded.index._ensure_built()
    assert jloaded.index.tuned == col.index.tuned
    loaded.close()
    jloaded.close()
    col.close()


def test_hybrid_slot_table_follows_rebuilds():
    """A rebuild renumbers the block slots: a hybrid call after writes past
    ``rebuild_fraction`` maps the new slots, not the old build's, and an
    explicit ``rebuild()`` between two calls is seen too."""
    n, d = 1024, 16
    x = clustered(n, d, seed=18)
    ids = ids_for(n)
    opts = {"min_rows": 128, "n_probe": 65_536, "rebuild_fraction": 0.1, "storage": "f32"}
    jc, tc = col_pair(d, index="ivf", index_options=opts)
    gens = ["search"]
    for col in (jc, tc):
        col.put_matrix(ids, x)
    first = tc.hybrid_search_batch(x[:4], limit=5, generators=gens)
    built_before = tc.index._built_version
    extra = clustered(256, d, seed=19)
    for col in (jc, tc):
        col.put_matrix([f"x-{i:03d}" for i in range(256)], extra)
    qs = np.concatenate([x[:4], extra[:4]])
    got = tc.hybrid_search_batch(qs, limit=5, generators=gens)
    assert tc.index._built_version > built_before and not tc.index._tail
    assert [r[0].id for r in got] == ids[:4] + [f"x-{i:03d}" for i in range(4)]
    assert [hits(r) for r in first] == [hits(r) for r in got[:4]]
    assert_same([hits(r) for r in got],
                [hits(r) for r in jc.hybrid_search_batch(qs, limit=5, generators=gens)],
                tol=1e-5)
    lex = tc.index._lex.clone()
    tc.index.params["kmeans_iters"] = 1  # another build: other block slots
    tc.index.rebuild()
    assert not torch.equal(tc.index._lex, lex)
    again = tc.hybrid_search_batch(qs, limit=5, generators=gens)
    assert [hits(r) for r in again] == [hits(r) for r in got]
    jc.close()
    tc.close()
