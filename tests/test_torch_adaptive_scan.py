"""The port's adaptive stage-1 scans against the JAX package's, on the CPU.

The same numpy inputs go through ``vettore_tpu.ops.flat_scan`` (its Pallas
kernels K5 ``_stage_gmin_scan``, K6 ``fused_sign_scan`` and K7
``extract_group_rows`` in interpret mode, as the JAX package's own tests
run them) and ``vettore_tpu_torch.ops.flat_scan`` (CPU tensors, so each
kernel wrapper runs its plain PyTorch version). Tolerances:

* K5 group minima and ranks: f32 atol 1e-5 (summation order over the
  prefix), bf16 atol 1e-4 (exact bf16 products accumulated in f32 in
  another order); infinities in the same places;
* K6 and K7: bit-equal (integer arithmetic and pure data movement);
* ``fused_stage_candidates``: the same slots in the same order, same ``ok``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import flat_scan as jfs
from vettore_tpu_torch.ops import flat_scan as tfs

torch.set_num_threads(2)

METRICS = tfs.FUSED_METRICS
STORAGES = ("f32", "bf16")
ATOL = {"f32": 1e-5, "bf16": 1e-4}
N, D, DIMS, B = 2048, 256, 128, 3
DEAD = (0, 5, 64, 65, 1000, 2047)


def _stage_operands(storage, seed=0):
    """Numpy ``(x, xsq, bias, q)`` for a stage scan, the JAX arrays and the
    torch tensors: dead rows zeroed at +inf bias, ``xsq`` the prefix squared
    norms of the block as stored."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(N, np.float32)
    x[list(DEAD)] = 0.0
    bias[list(DEAD)] = np.inf
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if storage == "bf16":
        tx = tx.to(torch.bfloat16)
        jx = jx.astype(jnp.bfloat16)
    xsq = (tx[:, :DIMS].float() ** 2).sum(dim=1).numpy()
    jax_ops = (jx, jnp.asarray(xsq), jnp.asarray(bias), jnp.asarray(q))
    torch_ops = (tx, torch.from_numpy(xsq), torch.from_numpy(bias), torch.from_numpy(q))
    return jax_ops, torch_ops


def _assert_close_with_inf(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    assert (got[~fin] == want[~fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_stage_gmin_scan_matches_jax(metric, storage):
    (jx, jxsq, jbias, jq), tops = _stage_operands(storage)
    tile = jfs._pick_row_tile(N, DIMS, B, jx.dtype.itemsize, tb_factor=3.5)
    w_gmin, w_rank, w_bounded = jfs._stage_gmin_scan(jx, jxsq, jbias, jq, metric=metric,
                                                     dims=DIMS, row_tile=tile)
    gmin, rank, bounded = tfs.stage_gmin_scan(*tops, metric=metric, dims=DIMS)
    assert gmin.shape == (B, N // tfs.GROUP) and rank.shape == (B, N)
    _assert_close_with_inf(gmin.numpy(), w_gmin, ATOL[storage])
    _assert_close_with_inf(rank.numpy(), w_rank, ATOL[storage])
    assert bool(bounded) == bool(w_bounded) is True


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_stage_candidates_matches_jax(metric, storage):
    jops, tops = _stage_operands(storage, seed=1)
    w_slots, w_ranks, w_ok = (np.asarray(a) for a in jfs.fused_stage_candidates(
        *jops, metric=metric, count=24, dims=DIMS))
    slots, ranks, ok = tfs.fused_stage_candidates(*tops, metric=metric, count=24, dims=DIMS)
    np.testing.assert_array_equal(ok.numpy(), w_ok)
    assert ok.all()
    np.testing.assert_array_equal(slots.numpy(), w_slots)
    _assert_close_with_inf(ranks.numpy(), w_ranks, ATOL[storage])


def test_fused_stage_candidates_mass_tie_flags_not_ok():
    # every live row identical: more than GROUP_SLACK groups tie at the
    # count-th group minimum, so both packages refuse the batch
    jops, tops = _stage_operands("f32", seed=2)
    x = np.asarray(jops[0]).copy()
    x[:] = x[1]
    xsq = (x[:, :DIMS] ** 2).sum(axis=1).astype(np.float32)
    bias = np.array(jops[2])
    q = np.array(jops[3])
    *_, w_ok = jfs.fused_stage_candidates(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias),
                                          jnp.asarray(q), metric="cosine", count=24, dims=DIMS)
    *_, ok = tfs.fused_stage_candidates(*(torch.from_numpy(a) for a in (x, xsq, bias, q)),
                                        metric="cosine", count=24, dims=DIMS)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
    assert not ok.any()


@pytest.mark.parametrize("ties", [False, True])
def test_fused_sign_scan_matches_jax(ties):
    rng = np.random.default_rng(6)
    n, d, b = 1024, 128, 2
    if ties:
        base = rng.integers(0, 2, (9, d)) * 2 - 1  # nine sign patterns: mass ties
        signs = base[rng.integers(0, 9, n)].astype(np.int8)
    else:
        signs = (rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.int8)
    valid = np.ones(n, np.int8)
    valid[[0, 63, 64, 700, 1023]] = 0
    qsigns = (rng.integers(0, 2, (b, d)) * 2 - 1).astype(np.int8)
    w_gmin, w_ham = jfs.fused_sign_scan(jnp.asarray(signs), jnp.asarray(valid),
                                        jnp.asarray(qsigns), d=d, row_tile=512)
    gmin, ham16 = tfs.fused_sign_scan(*(torch.from_numpy(a) for a in (signs, valid, qsigns)),
                                      d=d)
    assert gmin.dtype == torch.int32 and ham16.dtype == torch.int16
    np.testing.assert_array_equal(ham16.numpy(), np.asarray(w_ham))
    np.testing.assert_array_equal(gmin.numpy(), np.asarray(w_gmin))


@pytest.mark.parametrize("half", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_extract_group_rows_matches_jax(dtype, half):
    rng = np.random.default_rng(7)
    b, rows128, c = 3, 32, 20
    mat = rng.integers(-30000, 30000, (b, rows128, 128)).astype(dtype)
    if half:
        # JAX addresses 64-wide half rows of the 128-lane view; the port
        # gathers the same rows of the [B, N/64, 64] view directly
        gidx = rng.integers(0, 2 * rows128, (b, c)).astype(np.int32)
        want = jfs.extract_group_rows(jnp.asarray(mat), jnp.asarray(gidx), half=True)
        view = mat.reshape(b, 2 * rows128, 64)
    else:
        gidx = rng.integers(0, rows128, (b, c)).astype(np.int32)
        want = jfs.extract_group_rows(jnp.asarray(mat), jnp.asarray(gidx))
        view = mat
    got = tfs.extract_group_rows(torch.from_numpy(view), torch.from_numpy(gidx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wrapper", ["stage_gmin_scan", "fused_sign_scan",
                                     "extract_group_rows"])
def test_adaptive_wrappers_refuse_other_devices(wrapper):
    # CUDA tensors launch the kernel, CPU tensors run the plain version, and
    # every other device raises; nothing counts as a launch
    before = dict(tfs.LAUNCHES)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if wrapper == "stage_gmin_scan":
            _jops, tops = _stage_operands("f32")
            tfs.stage_gmin_scan(*(t.to("meta") for t in tops), metric="cosine", dims=DIMS)
        elif wrapper == "fused_sign_scan":
            tfs.fused_sign_scan(torch.ones((128, 8), dtype=torch.int8, device="meta"),
                                torch.ones(128, dtype=torch.int8, device="meta"),
                                torch.ones((2, 8), dtype=torch.int8, device="meta"), d=8)
        else:
            tfs.extract_group_rows(torch.zeros((2, 4, 64), device="meta"),
                                   torch.zeros((2, 3), dtype=torch.int32, device="meta"))
    assert tfs.LAUNCHES == before


def test_supports_gates_are_the_kernel_limits():
    # K5 and K6 read any width: only the group size, the candidate count and
    # the int16 Hamming range limit them (no lane-tile gate)
    assert tfs.supports_candidates("cosine", 2048, 64, 24)
    assert tfs.supports_candidates("l2", 2048, 100, tfs.MAX_FUSED_C)
    assert not tfs.supports_candidates("manhattan", 2048, 128, 24)
    assert not tfs.supports_candidates("cosine", 2000, 128, 24)
    assert not tfs.supports_candidates("cosine", 2048, 128, tfs.MAX_FUSED_C + 1)
    assert tfs.supports_sign_scan(8192, 96) and tfs.supports_sign_scan(8192, 100)
    assert not tfs.supports_sign_scan(2000, 128)
    assert not tfs.supports_sign_scan(8192, 16384)


@pytest.mark.parametrize("dims", [64, 100])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_fused_stage_candidates_off_the_lane_tile_match_jax_plain_route(metric, dims):
    # the JAX package ranks a prefix that is not a multiple of 128 columns
    # with its plain route; the port's K5 route must give the same slots
    from vettore_tpu.ops import pipeline as jpipe
    from vettore_tpu.ops import select as jsel

    (jx, _jxsq, jbias, jq), (tx, _txsq, tbias, tq) = _stage_operands("f32", seed=3)
    rank, finite = jpipe._rank_full(jx, jnp.isfinite(jbias), jq, metric=metric, dims=dims)
    w_slots, _w_ranks, w_ok = jsel.exact_top_c(rank, None, c=24)
    xsq = (tx[:, :dims] ** 2).sum(dim=1)
    slots, _ranks, ok = tfs.fused_stage_candidates(tx, xsq, tbias, tq, metric=metric,
                                                   count=24, dims=dims)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok & finite))
    assert ok.all()
    np.testing.assert_array_equal(slots.numpy(), np.asarray(w_slots))
