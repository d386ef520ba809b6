"""The port's fused flat scan against the JAX package's, on the CPU.

The same numpy inputs go through ``vettore_tpu.ops.flat_scan`` (its Pallas
kernels in interpret mode, as the JAX package's own tests run them) and
``vettore_tpu_torch.ops.flat_scan`` (CPU tensors, so each kernel wrapper runs
its plain PyTorch version). Tolerances:

* group minima: f32 atol 1e-5 (summation order over d unit-scale products),
  bf16 atol 1e-4 (exact bf16 products accumulated in f32 in another order);
* rescored ranks: atol 1e-5;
* final raws: 1e-5 * max(1, |raw|); slots must be identical and in order.
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
GMIN_ATOL = {"f32": 1e-5, "bf16": 1e-4}


def _unit_rows(rng, n, d):
    a = rng.normal(size=(n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _operands(n=2048, d=32, b=6, seed=0, dead=()):
    """Numpy ``(x, xsq, bias, q)`` with dead rows zeroed at +inf bias."""
    rng = np.random.default_rng(seed)
    x = _unit_rows(rng, n, d) * rng.uniform(0.5, 2.0, size=(n, 1)).astype(np.float32)
    q = _unit_rows(rng, b, d)
    bias = np.zeros(n, np.float32)
    x[list(dead)] = 0.0
    bias[list(dead)] = np.inf
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    return x, xsq, bias, q


def _jax(x, xsq, bias, q, storage):
    jx = jnp.asarray(x)
    if storage == "bf16":
        jx = jx.astype(jnp.bfloat16)
    return jx, jnp.asarray(xsq), jnp.asarray(bias), jnp.asarray(q)


def _torch(x, xsq, bias, q, storage):
    tx = torch.from_numpy(x)
    if storage == "bf16":
        tx = tx.to(torch.bfloat16)
    return tx, torch.from_numpy(xsq), torch.from_numpy(bias), torch.from_numpy(q)


def _jax_gmin(jx, jxsq, jbias, jq, metric):
    n, d = jx.shape
    tile = jfs._pick_row_tile(n, d, jq.shape[0], jx.dtype.itemsize)
    gmin, bounded = jfs._gmin_scan(jx, jxsq, jbias, jq, metric=metric, row_tile=tile)
    return np.asarray(gmin), bool(bounded)


def _assert_close_with_inf(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    assert (got[~fin] == want[~fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_gmin_scan_matches_jax(metric, storage):
    ops = _operands(dead=(3, 64, 65, 2047))
    want, want_bounded = _jax_gmin(*_jax(*ops, storage), metric)
    got, got_bounded = tfs.gmin_scan(*_torch(*ops, storage), metric=metric)
    assert got.shape == (6, 2048 // tfs.GROUP)
    _assert_close_with_inf(got.numpy(), want, GMIN_ATOL[storage])
    assert bool(got_bounded) == want_bounded is True


@pytest.mark.parametrize("where", ["row", "query"])
def test_gmin_scan_huge_norm_is_unbounded(where):
    x, xsq, bias, q = _operands()
    if where == "row":
        x[17] = 1e19
        xsq = np.sum(x * x, axis=1, dtype=np.float32)
    else:
        q[2] *= 1e20
    for metric in ("cosine", "l2"):
        _, want_bounded = _jax_gmin(*_jax(x, xsq, bias, q, "f32"), metric)
        _, got_bounded = tfs.gmin_scan(*_torch(x, xsq, bias, q, "f32"), metric=metric)
        assert want_bounded is False
        assert bool(got_bounded) is False


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_rescore_matches_jax(metric, storage):
    ops = _operands(n=1024, b=4, seed=1, dead=(5, 700))
    rng = np.random.default_rng(2)
    ng = 1024 // tfs.GROUP
    gidx = np.stack([rng.choice(ng, 12, replace=False) for _ in range(4)]).astype(np.int32)
    jx, jxsq, jbias, jq = _jax(*ops, storage)
    want = np.asarray(jfs._rescore(jx, jxsq, jbias, jq, jnp.asarray(gidx), metric=metric))
    got = tfs.rescore(*_torch(*ops, storage), torch.from_numpy(gidx), metric=metric)
    assert got.shape == (4, 12, tfs.GROUP)
    _assert_close_with_inf(got.numpy(), want, 1e-5)


def _fused_case(case):
    """Operands of one fused-search scenario: ``(x, xsq, bias, lex_rank, q)``."""
    rng = np.random.default_rng(7)
    n, d, b = 2048, 24, 5
    lex_rank = rng.permutation(n).astype(np.int32)
    x, xsq, bias, q = _operands(n, d, b, seed=8)
    if case == "duplicates":
        # four identical rows, one of them an exact copy of query 0: an
        # exact rank tie inside the pad that only the lex rank orders
        x[[100, 700, 1500]] = x[1200]
        q[0] = x[1200]
        q[1] = x[1200] * 0.5
    elif case == "mass_tie":
        # more than GROUP_SLACK groups tie at the k-th boundary
        x[:] = x[0]
    elif case == "deleted":
        dead = rng.choice(n, 300, replace=False)
        x[dead] = 0.0
        bias[dead] = np.inf
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    return x, xsq, bias, lex_rank, q


def _compare_fused(case, metric, storage, k=16):
    x, xsq, bias, lex_rank, q = _fused_case(case)
    jx, jxsq, jbias, jq = _jax(x, xsq, bias, q, storage)
    want = jfs.fused_flat_search(jx, jxsq, jbias, jnp.asarray(lex_rank), jq,
                                 metric=metric, k=k)
    w_slots, w_raws, w_ranks, w_ok = (np.asarray(a) for a in want)
    tx, txsq, tbias, tq = _torch(x, xsq, bias, q, storage)
    got = tfs.fused_flat_search(tx, txsq, tbias, torch.from_numpy(lex_rank), tq,
                                metric=metric, k=k)
    g_slots, g_raws, g_ranks, g_ok = (a.numpy() for a in got)
    assert bool(g_ok) == bool(w_ok)
    if not bool(w_ok):
        return False
    np.testing.assert_array_equal(g_slots, w_slots)
    fin = np.isfinite(w_ranks)
    np.testing.assert_array_equal(np.isfinite(g_ranks), fin)
    tol = 1e-5 * np.maximum(1.0, np.abs(w_raws[fin]))
    assert (np.abs(g_raws[fin] - w_raws[fin]) <= tol).all()
    return True


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", METRICS)
def test_fused_flat_search_matches_jax(metric, storage):
    assert _compare_fused("random", metric, storage) is True


@pytest.mark.parametrize("metric", ["cosine", "l2"])
@pytest.mark.parametrize("case", ["duplicates", "deleted"])
def test_fused_flat_search_edge_cases_match_jax(case, metric):
    assert _compare_fused(case, metric, "f32") is True


@pytest.mark.parametrize("storage", STORAGES)
def test_fused_flat_search_mass_tie_flags_not_ok(storage):
    assert _compare_fused("mass_tie", "cosine", storage) is False


def test_duplicates_resolve_by_lex_rank():
    x, xsq, bias, lex_rank, q = _fused_case("duplicates")
    slots, _raws, _ranks, ok = tfs.fused_flat_search(
        *(torch.from_numpy(a) for a in (x, xsq, bias, lex_rank, q)), metric="l2", k=16)
    tied = sorted([100, 700, 1200, 1500], key=lambda s: lex_rank[s])
    assert bool(ok)
    assert slots[0, :4].tolist() == tied


@pytest.mark.parametrize("wrapper", ["gmin_scan", "rescore"])
def test_wrappers_refuse_other_devices(wrapper):
    # a wrapper runs its kernel on CUDA tensors and its plain version on CPU
    # tensors only; there is no silent route for any other device
    x, xsq, bias, q = (t.to("meta") for t in _torch(*_operands(n=128), "f32"))
    before = dict(tfs.LAUNCHES)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if wrapper == "gmin_scan":
            tfs.gmin_scan(x, xsq, bias, q, metric="cosine")
        else:
            gidx = torch.zeros((q.shape[0], 2), dtype=torch.int32, device="meta")
            tfs.rescore(x, xsq, bias, q, gidx, metric="cosine")
    assert tfs.LAUNCHES == before


def test_plain_versions_count_no_launches():
    before = dict(tfs.LAUNCHES)
    x, xsq, bias, lex_rank, q = _fused_case("random")
    tfs.fused_flat_search(*(torch.from_numpy(a) for a in (x, xsq, bias, lex_rank, q)),
                          metric="l2", k=8)
    assert tfs.LAUNCHES == before


@pytest.mark.parametrize("dtype,d,ld", [(torch.float32, 768, 768), (torch.float32, 127, 128),
                                        (torch.bfloat16, 100, 104), (torch.int8, 33, 48)])
def test_tma_rows_pads_rows_to_16_bytes(dtype, d, ld):
    # the tensor-core scans' operand route: rows of a multiple of 16 bytes
    # are read in place, any other row is copied to the next such stride,
    # zero-filled; a tensor whose rows are not d elements apart raises
    t = torch.from_numpy(np.random.default_rng(d).normal(size=(64, d)) * 50).to(dtype)
    out, ld_bytes, copied = tfs._tma_rows(t)
    assert ld_bytes == ld * t.element_size() and copied == (ld != d)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous()
    assert torch.equal(out[:, :d], t) and not out[:, d:].any()
    with pytest.raises(ValueError, match="contiguous"):
        tfs._tma_rows(t.t().contiguous().t())
