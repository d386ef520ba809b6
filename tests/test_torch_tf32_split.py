"""The 3xTF32 arithmetic of K1's f32 kernel, on the CPU.

On the card K1 multiplies f32 blocks on the TF32 tensor cores in three
products of split operands, ``x.q ~ x_lo.q_hi + x_hi.q_lo + x_hi.q_hi``
(``csrc/wgmma_scan.cuh``, policy ``Tf32x3``). The kernel itself runs only
on the card; here its arithmetic is modelled in plain torch and held
against float64 and against the JAX package:

* the wrapper's split (``flat_scan.tf32_split``): ``hi + lo == v`` exactly,
  ``hi`` on the TF32 grid and the nearest such value (ties away from zero);
* the model, which sums as the kernel does: products of TF32 values (each
  lo part cut to TF32 as the tensor cores read it), added k-step by k-step
  into a running sum that rounds toward zero, as the tensor cores' does,
  restarted every window of 4 stages (128 values of d), the windows' sums
  added in f32. It stays within ``K1_ATOL["f32"]`` = 1e-5 of the float64
  product up to d = 4096, and without the windows it does not;
* the model's group minima, fed through the port's group selection and
  rescore, give the same ``fused_flat_search`` ids and ``ok`` as the JAX
  package (its Pallas kernels in interpret mode), on the edge-case corpora
  of ``tests/test_torch_flat_scan.py`` and the near-tie corpus of the card
  tests, on which a single TF32 pass picks other ids.

The card tests (``tests/test_torch_kernels_gpu.py``) hold the kernel
itself to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import flat_scan as jfs
from vettore_tpu_torch.ops import flat_scan as tfs

from test_torch_kernels_gpu import _near_tie_corpus

torch.set_num_threads(2)

K1_ATOL = 1e-5

#: the f32 kernel's geometry: k-steps of 8 values, 32 to a 128-byte stage,
#: windows of 4 stages
K_STEP, WINDOW = 8, 4 * 32


def _tf32_cut(v):
    """``v`` read as TF32 by the tensor cores: its 13 low mantissa bits
    dropped (truncation, the coarser of the two roundings the hardware
    could apply)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _to_f32_toward_zero(v):
    """float64 ``v`` rounded to f32 toward zero."""
    r = v.float()
    over = r.double().abs() > v.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def _model_dots(x, q, *, window=WINDOW):
    """``[B, N]`` dots as K1's f32 kernel forms them: per k-step of 8
    values, the three products x_lo.q_hi, x_hi.q_lo and x_hi.q_hi of TF32
    values (exact, summed exactly), each added in turn to a running sum
    that is rounded to f32 toward zero; the running sum restarts every
    ``window`` values of d (None: never), and the windows' sums are added
    in f32."""
    xh, xl = tfs.tf32_split(x)
    qh, ql = tfs.tf32_split(q)
    terms = [(a.double(), b.double())
             for a, b in ((_tf32_cut(xl), qh), (xh, _tf32_cut(ql)), (xh, qh))]
    d = x.shape[1]
    window = window or d
    acc = None
    for w0 in range(0, d, window):
        part = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float64)
        for k0 in range(w0, min(w0 + window, d), K_STEP):
            for a, b in terms:
                step = b[:, k0:k0 + K_STEP] @ a[:, k0:k0 + K_STEP].T
                part = _to_f32_toward_zero(part + step).double()
        acc = part.float() if acc is None else acc + part.float()
    return acc


def _model_gmin_scan(x, xsq, bias, q, *, metric, dots=_model_dots):
    """K1 on the model's dots: ``([B, N/64], bounded)`` as ``gmin_scan``."""
    qsq = (q * q).sum(dim=1)
    rank = tfs._rank(dots(x, q), xsq[None, :], qsq[:, None], metric) + bias[None, :]
    b, n = rank.shape
    return rank.reshape(b, n // tfs.GROUP, tfs.GROUP).amin(dim=-1), tfs._bounded(xsq, qsq)


# ---------------------------------------------------------------------------
# the split
# ---------------------------------------------------------------------------


def _nearest_tf32(v):
    """The nearest TF32 value to each f32 in ``v`` (numpy, float64 math;
    ties away from zero)."""
    m, e = np.frexp(v.astype(np.float64))  # v = m * 2**e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2.0 ** 11  # 11 significant bits
    return np.sign(m) * np.floor(scaled + 0.5) * 2.0 ** (e - 11)


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 7.0, 1e4, 1e30])
def test_split_is_exact_and_on_the_tf32_grid(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    v = (rng.normal(size=(64, 257)) * scale).astype(np.float32)
    v[0, :4] = [0.0, -0.0, scale, -scale]
    # values halfway between two TF32 neighbours round away from zero
    v[1, :2] = np.float32([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)])
    t = torch.from_numpy(v)
    hi, lo = tfs.tf32_split(t)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi + lo, t)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _nearest_tf32(v))
    assert hi[1, 0].item() == 1.0 + 2.0 ** -10 and hi[1, 1].item() == -(1.0 + 2.0 ** -9)
    # the remainder is at most half a TF32 step: 12 significant bits
    bound = np.abs(v.astype(np.float64)) * 2.0 ** -11
    assert (np.abs(lo.numpy().astype(np.float64)) <= bound).all()


# ---------------------------------------------------------------------------
# the model against float64
# ---------------------------------------------------------------------------


def _unit_operands(d, spread):
    """256 rows and 24 queries of width d, unit norm (rows of norm 0.5..2
    with ``spread``); rows 0-7 point along queries 0-7, so their dots are
    near their largest."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(256, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(24, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if spread:  # row norms 0.5..2, as tests/test_torch_flat_scan.py draws them
        x *= rng.uniform(0.5, 2.0, (256, 1))
    x[:8] = q[:8] * rng.uniform(0.5, 2.0, (8, 1))
    return x.astype(np.float32), q.astype(np.float32)


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("d", [32, 100, 768, 4096])
def test_model_dots_within_k1_atol_of_float64(d, spread):
    x, q = _unit_operands(d, spread)
    got = _model_dots(torch.from_numpy(x), torch.from_numpy(q)).numpy()
    want = q.astype(np.float64) @ x.astype(np.float64).T
    assert np.abs(got - want).max() <= K1_ATOL
    # and much closer than one TF32 pass, which the kernel never takes
    one_pass = (_tf32_cut(torch.from_numpy(q)) @ _tf32_cut(torch.from_numpy(x)).T).numpy()
    assert np.abs(got - want).max() * 100 < np.abs(one_pass - want).max()


@pytest.mark.parametrize("d", [768, 4096])
def test_model_without_windows_misses_k1_atol(d):
    # one running sum over all of d, as the kernel's first version kept:
    # each add rounds toward zero, so the error grows with d and the dots
    # near 2 leave K1_ATOL
    x, q = _unit_operands(d, True)
    want = q.astype(np.float64) @ x.astype(np.float64).T
    got = _model_dots(torch.from_numpy(x), torch.from_numpy(q), window=None).numpy()
    assert np.abs(got - want).max() > K1_ATOL


# ---------------------------------------------------------------------------
# the model through fused_flat_search, against the JAX package
# ---------------------------------------------------------------------------


def _corpus(case):
    """``(x, xsq, bias, lex_rank, q)`` numpy operands of one scenario: the
    edge cases of tests/test_torch_flat_scan.py, and ``near_tie``: one row
    in each of 20 groups with a dot of 0.9 + i * 1e-6 to query 0 (more than
    GROUP_SLACK groups within 2e-5 of each other), as the card tests draw
    it."""
    if case == "near_tie":
        return _near_tie_corpus()
    rng = np.random.default_rng(7)
    n, d, b = 2048, 24, 5
    lex_rank = rng.permutation(n).astype(np.int32)
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x *= rng.uniform(0.5, 2.0, size=(n, 1))
    q = rng.normal(size=(b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    if case == "duplicates":
        x[[100, 700, 1500]] = x[1200]
        q[0] = x[1200]
        q[1] = x[1200] * 0.5
    elif case == "mass_tie":
        x[:] = x[0]
    elif case == "deleted":
        dead = rng.choice(n, 300, replace=False)
        x[dead] = 0.0
        bias[dead] = np.inf
    x, q = x.astype(np.float32), q.astype(np.float32)
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    return x, xsq, bias, lex_rank, q


def _jax_search(case, metric, k):
    x, xsq, bias, lex_rank, q = _corpus(case)
    out = jfs.fused_flat_search(jnp.asarray(x), jnp.asarray(xsq), jnp.asarray(bias),
                                jnp.asarray(lex_rank), jnp.asarray(q), metric=metric, k=k)
    return [np.asarray(a) for a in out]


def _model_search(monkeypatch, case, metric, k, dots=_model_dots):
    monkeypatch.setattr(tfs, "gmin_scan",
                        lambda *a, metric: _model_gmin_scan(*a, metric=metric, dots=dots))
    got = tfs.fused_flat_search(*(torch.from_numpy(a) for a in _corpus(case)), metric=metric,
                                k=k)
    return [a.numpy() for a in got]


@pytest.mark.parametrize("case,metric", [
    *(("random", m) for m in tfs.FUSED_METRICS),
    ("duplicates", "cosine"), ("duplicates", "l2"), ("deleted", "cosine"), ("deleted", "l2"),
    ("mass_tie", "cosine"), ("near_tie", "cosine"), ("near_tie", "l2")])
def test_model_search_matches_jax(monkeypatch, case, metric):
    k = 4 if case == "near_tie" else 16
    w_slots, w_raws, _w_ranks, w_ok = _jax_search(case, metric, k)
    g_slots, g_raws, _g_ranks, g_ok = _model_search(monkeypatch, case, metric, k)
    assert bool(g_ok) == bool(w_ok) == (case != "mass_tie")
    if bool(w_ok):
        np.testing.assert_array_equal(g_slots, w_slots)
        fin = np.isfinite(w_raws)
        tol = 1e-5 * np.maximum(1.0, np.abs(w_raws[fin]))
        assert (np.abs(g_raws[fin] - w_raws[fin]) <= tol).all()
    if case == "near_tie":
        assert w_slots[0].tolist() == [64 * (2 * i + 1) + i for i in (19, 18, 17, 16)]


def test_one_tf32_pass_misses_the_near_ties(monkeypatch):
    # the corpus tells the two apart: one TF32 product per element (errors
    # of order 1e-4) scrambles the 20 group minima 1e-6 apart, so the
    # search returns other ids than the JAX package without flagging it
    w_slots = _jax_search("near_tie", "cosine", 4)[0]
    g_slots, _raws, _ranks, g_ok = _model_search(
        monkeypatch, "near_tie", "cosine", 4,
        dots=lambda x, q: _tf32_cut(q) @ _tf32_cut(x).T)
    assert bool(g_ok)
    assert g_slots[0].tolist() != w_slots[0].tolist()
