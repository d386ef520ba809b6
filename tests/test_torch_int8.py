"""The port's int8 storage path against the JAX package's, on the CPU.

The same numpy inputs go through ``vettore_tpu`` (the Pallas kernels K3 and
K4 in interpret mode, as the JAX package's own tests run them) and
``vettore_tpu_torch`` (CPU tensors, so the kernel wrappers run their plain
PyTorch versions). Tolerances:

* quantization (``x8``, ``scale``) and K3's group minima: bit-equal (the
  int8 dots are exact integers and both sides round the same f32
  operations in the same order);
* K4's rescored ranks: 1e-5 * max(1, |rank|) on unit-scale rows (f32
  sums over d in another order);
* search raws: 1e-5 * max(1, |raw|); slots and ids identical, in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.index.flat import FlatIndex as JFlat
from vettore_tpu.index.flat import _quantize_int8
from vettore_tpu.ops import flat_scan as jfs
from vettore_tpu_torch import convert
from vettore_tpu_torch.index.flat import FlatIndex as TFlat
from vettore_tpu_torch.ops import flat_scan as tfs

torch.set_num_threads(2)

N, D, B = 2048, 64, 5
F32_MAX = 3.4028234663852886e38
RAW_TOL = 1e-5
METRICS = ("cosine", "l2", "inner_product")


def _rows(seed, n=N, d=D, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if spread:  # row norms over four decades: scales differ row to row
        x *= rng.uniform(0.01, 100.0, size=(n, 1)).astype(np.float32)
    return x


def _operands(seed=0, dead=(3, 64, 2047), spread=True):
    """Numpy ``(x8, scale, xsq, bias, lex_rank, q)``: the JAX package's own
    quantization of a (spread-norm) corpus with dead rows zeroed."""
    x = _rows(seed, spread=spread)
    x[list(dead)] = 0.0
    x8, scale = (np.asarray(a) for a in _quantize_int8(jnp.asarray(x)))
    bias = np.zeros(N, np.float32)
    bias[list(dead)] = np.inf
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    rng = np.random.default_rng(seed + 1)
    lex_rank = rng.permutation(N).astype(np.int32)
    q = x[rng.integers(0, N, B)] / 50.0 + rng.normal(size=(B, D)).astype(np.float32)
    return x8, scale, xsq, bias, lex_rank, q.astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_is_bit_equal(seed):
    x = _rows(seed)
    x[5] = 0.0  # an all-zero row takes the 1e-30 floor
    x[6, :] = -3.5  # ties at the absmax
    want_x8, want_scale = (np.asarray(a) for a in _quantize_int8(jnp.asarray(x)))
    got_x8, got_scale = tfs.quantize_rows(torch.from_numpy(x))
    assert got_x8.dtype == torch.int8 and got_scale.dtype == torch.float32
    np.testing.assert_array_equal(got_x8.numpy(), want_x8)
    np.testing.assert_array_equal(got_scale.numpy().view(np.uint32), want_scale.view(np.uint32))


@pytest.mark.parametrize("metric", tfs.FUSED_METRICS)
def test_int8_gmin_scan_is_bit_equal(metric):
    x8, scale, xsq, bias, _lex, q = _operands()
    q8, qscale = (t.numpy() for t in tfs.quantize_rows(torch.from_numpy(q)))
    qsq = np.sum(q * q, axis=1, dtype=np.float32)
    want, want_bounded = jfs._int8_gmin_scan(
        *(jnp.asarray(a) for a in (x8, scale, xsq, bias)), jnp.asarray(q8.T),
        jnp.asarray(qscale), jnp.asarray(qsq), metric=metric,
        row_tile=jfs._pick_row_tile(N, D, B, 1))
    got, got_bounded = tfs.int8_gmin_scan(*_t(x8, scale, xsq, bias, q8, qscale, qsq),
                                          metric=metric)
    assert got.shape == (B, N // tfs.GROUP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got_bounded) == bool(want_bounded) is True


@pytest.mark.parametrize("metric", tfs.FUSED_METRICS)
def test_int8_rescore_matches_jax(metric):
    x8, scale, xsq, bias, _lex, q = _operands(seed=3, spread=False)
    rng = np.random.default_rng(4)
    gidx = np.stack([rng.choice(N // tfs.GROUP, 12, replace=False) for _ in range(B)])
    gidx = gidx.astype(np.int32)
    want = np.asarray(jfs._int8_rescore(*(jnp.asarray(a) for a in (x8, scale, xsq, bias, q)),
                                        jnp.asarray(gidx), metric=metric))
    got = tfs.int8_rescore(*_t(x8, scale, xsq, bias, q, gidx), metric=metric).numpy()
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all() and (got[~fin] == want[~fin]).all()
    assert (np.abs(got[fin] - want[fin]) <= 1e-5 * np.maximum(1.0, np.abs(want[fin]))).all()


def _assert_same_search(got, want):
    g_slots, g_raws, _g_ranks, g_ok = (a.numpy() for a in got)
    w_slots, w_raws, _w_ranks, w_ok = (np.asarray(a) for a in want)
    assert bool(g_ok) == bool(w_ok)
    np.testing.assert_array_equal(g_slots, w_slots)
    assert (np.abs(g_raws - w_raws) <= RAW_TOL * np.maximum(1.0, np.abs(w_raws))).all()


@pytest.mark.parametrize("metric", tfs.FUSED_METRICS)
@pytest.mark.parametrize("seed", [0, 5])
def test_fused_int8_search_matches_jax(metric, seed):
    x8, scale, xsq, bias, lex_rank, q = _operands(seed)
    want = jfs.fused_int8_search(*(jnp.asarray(a) for a in (x8, scale, xsq, bias, lex_rank, q)),
                                 metric=metric, k=16)
    got = tfs.fused_int8_search(*_t(x8, scale, xsq, bias, lex_rank, q), metric=metric, k=16)
    assert bool(want[3])
    _assert_same_search(got, want)


def test_int8_dots_are_exact_past_the_f32_chunk():
    # d = 2100 > 1040: the f32 GEMM runs per chunk and sums in int64
    rng = np.random.default_rng(9)
    x8 = rng.integers(-127, 128, (64, 2100)).astype(np.int8)
    q8 = rng.integers(-127, 128, (3, 2100)).astype(np.int8)
    want = q8.astype(np.int64) @ x8.astype(np.int64).T
    got = tfs.int8_dots(*_t(q8, x8))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ---------------------------------------------------------------------------
# FlatIndex int8 storage and views
# ---------------------------------------------------------------------------


def _pair(metric, storage="int8", n=3000, seed=10):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, D)).astype(np.float32)
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    queries = data[rng.integers(0, n, 6)] + 0.3 * rng.normal(size=(6, D)).astype(np.float32)
    pair = (JFlat(metric, storage=storage), TFlat(metric, storage=storage, device="cpu"))
    for index in pair:
        index.put_matrix(ids[: n // 2], data[: n // 2])
        index.put_many(zip(ids[n // 2:], data[n // 2:]))
        index.delete(ids[7])
    return pair, queries


def _assert_same_hits(got, want):
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    for grow, wrow in zip(got, want):
        for (_, g), (_, w) in zip(grow, wrow):
            assert abs(g - w) <= RAW_TOL * max(1.0, abs(w))


@pytest.mark.parametrize("metric", METRICS + ("negative_inner_product", "l2_squared"))
def test_int8_flat_index_matches_jax(metric):
    (jidx, tidx), queries = _pair(metric)
    assert tidx._fused_eligible(16) and jidx._fused_eligible(16)
    _assert_same_hits(tidx.search_batch(queries, 10), jidx.search_batch(queries, 10))
    _assert_same_hits([tidx.search(queries[0], 5)], [jidx.search(queries[0], 5)])
    assert tidx._device[0].dtype == torch.int8 and tidx.host_routes == 0
    np.testing.assert_array_equal(tidx._int8_scale.numpy(), np.asarray(jidx._int8_scale))
    t_slots, t_raws = tidx.search_batch_device(torch.from_numpy(queries), 10)
    j_slots, j_raws = jidx.search_batch_device(jnp.asarray(queries), 10)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))


@pytest.mark.parametrize("metric", METRICS)
def test_int8_storage_view_matches_jax(metric):
    (jidx, tidx), queries = _pair(metric, storage="f32", seed=11)
    jview, tview = jidx.storage_view("int8"), tidx.storage_view("int8")
    assert tview._device[0].dtype == torch.int8 and not tview._dirty
    np.testing.assert_array_equal(tview._device[0].numpy(), np.asarray(jview._device[0]))
    _assert_same_hits(tview.search_batch(queries, 10), jview.search_batch(queries, 10))
    # an int8 view of an int8 view keeps the block and its scales
    again = tview.storage_view("int8")
    assert again._device[0] is tview._device[0] and again._int8_scale is tview._int8_scale


@pytest.mark.parametrize("metric,n", [("manhattan", 3000), ("chebyshev", 3000),
                                      ("cosine", 50), ("l2", 50)])
def test_int8_dequant_fallback_matches_jax(metric, n):
    (jidx, tidx), queries = _pair(metric, n=n, seed=12)
    assert not tidx._fused_eligible(16) and not jidx._fused_eligible(16)
    _assert_same_hits(tidx.search_batch(queries, 10), jidx.search_batch(queries, 10))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_widening_view_of_int8_rebuilds(storage):
    (jidx, tidx), queries = _pair("cosine", storage="f32", seed=13)
    tview8 = tidx.storage_view("int8")
    wide = tview8.storage_view(storage)
    assert wide._dirty  # rebuilds from the f32 host mirror at its first search
    got = wide.search_batch(queries, 10)
    assert wide._device[0].dtype == (torch.bfloat16 if storage == "bf16" else torch.float32)
    want = jidx.storage_view("int8").storage_view(storage).search_batch(queries, 10)
    _assert_same_hits(got, want)
    if storage == "f32":
        _assert_same_hits(got, tidx.search_batch(queries, 10))


def test_huge_scales_take_the_host_route():
    # a row at f32 max makes the dequant scale product overflow the bound:
    # the batch goes to the f64 host oracle, whose answer both packages share
    results = []
    for index in (JFlat("inner_product", storage="int8"),
                  TFlat("inner_product", storage="int8", device="cpu")):
        index.put_many([(f"p{i:04d}", [1.0, 1.0]) for i in range(1100)])
        index.put("big", [F32_MAX, F32_MAX])
        assert index._fused_eligible(4)
        results.append(index.search_batch(np.array([[2.0, -2.0]]), 4))
    assert index.host_routes == 1
    assert dict(results[1][0]).get("big") == 0.0
    assert results[0] == results[1]


def test_int8_bound_flags_overflow():
    x8, scale, xsq, bias, _lex, q = (np.array(a) for a in _operands())
    scale[9] = 1e36
    q8, qscale = tfs.quantize_rows(torch.from_numpy(q))
    _gmin, bounded = tfs.int8_gmin_scan(*_t(x8, scale, xsq, bias), q8, qscale,
                                        torch.from_numpy((q * q).sum(axis=1)), metric="cosine")
    assert not bool(bounded)


def test_int8_device_state_parity():
    (jidx, _tidx), queries = _pair("l2", storage="int8", seed=14)
    jidx._sync_device()
    x8, scale = convert.int8_device_state(np.asarray(jidx._device[0]),
                                          np.asarray(jidx._int8_scale), device="cpu")
    xsq, bias, lex_rank = (np.asarray(a) for a in jidx._device_scan)
    q = queries.astype(np.float32)
    want = jfs.fused_int8_search(jidx._device[0], jidx._int8_scale, *jidx._device_scan,
                                 jnp.asarray(q), metric="l2", k=16)
    got = tfs.fused_int8_search(x8, scale, *_t(xsq.reshape(-1), bias.reshape(-1), lex_rank, q),
                                metric="l2", k=16)
    _assert_same_search(got, want)


@pytest.mark.parametrize("wrapper", ["int8_gmin_scan", "int8_rescore"])
def test_int8_wrappers_refuse_other_devices(wrapper):
    x8, scale, xsq, bias, _lex, q = (t.to("meta") for t in _t(*_operands()))
    before = dict(tfs.LAUNCHES)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if wrapper == "int8_gmin_scan":
            q8 = torch.zeros(q.shape, dtype=torch.int8, device="meta")
            qs = torch.ones(q.shape[0], device="meta")
            tfs.int8_gmin_scan(x8, scale, xsq, bias, q8, qs, qs, metric="cosine")
        else:
            gidx = torch.zeros((q.shape[0], 2), dtype=torch.int32, device="meta")
            tfs.int8_rescore(x8, scale, xsq, bias, q, gidx, metric="cosine")
    assert tfs.LAUNCHES == before


def test_int8_plain_versions_count_no_launches():
    before = dict(tfs.LAUNCHES)
    tfs.fused_int8_search(*_t(*_operands()), metric="l2", k=8)
    assert tfs.LAUNCHES == before
