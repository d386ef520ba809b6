"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the ``gpu``
marker). Run them on the card with::

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Shapes are small but ragged on purpose: a query count that is not a
multiple of the kernel's 128-query tile and a width that is not a multiple
of its 32-element d-chunk. Tolerances as in ``chip_smoke.py``: group minima
f32 atol 1e-5, bf16 atol 1e-4; rescored ranks atol 1e-5.
"""

import numpy as np
import pytest
import torch

from vettore_tpu_torch.ops import flat_scan as fs
from vettore_tpu_torch.ops import select

pytestmark = pytest.mark.gpu

STORAGES = ("f32", "bf16")
GMIN_ATOL = {"f32": 1e-5, "bf16": 1e-4}
SHAPES = ((4096, 96, 70), (2048, 33, 130))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(n, d, b, storage, device, seed=0, dead=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bias = np.zeros(n, np.float32)
    idx = rng.choice(n, dead, replace=False)
    x[idx] = 0.0
    bias[idx] = np.inf
    xt = torch.from_numpy(x).to(device)
    if storage == "bf16":
        xt = xt.to(torch.bfloat16)
    xsq = (xt.float() ** 2).sum(dim=1)
    return xt, xsq, torch.from_numpy(bias).to(device), torch.from_numpy(q).to(device)


def _assert_close_with_inf(got, want, atol):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.equal(got[~fin], want[~fin])
    assert (got[fin] - want[fin]).abs().max().item() <= atol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_gmin_scan_kernel_matches_plain(cuda, metric, storage, shape):
    x, xsq, bias, q = _operands(*shape, storage, cuda)
    before = fs.LAUNCHES["gmin_scan"]
    gmin, bounded = fs.gmin_scan(x, xsq, bias, q, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["gmin_scan"] == before + 1
    assert bool(bounded)
    _assert_close_with_inf(gmin, fs._gmin_scan_ref(x, xsq, bias, q, metric=metric),
                           GMIN_ATOL[storage])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_rescore_kernel_matches_plain(cuda, metric, storage, shape):
    x, xsq, bias, q = _operands(*shape, storage, cuda, seed=1)
    _v, gidx, _ok = select.group_topk(fs._gmin_scan_ref(x, xsq, bias, q, metric=metric),
                                      12, check_c=4)
    gidx = gidx.int()
    before = fs.LAUNCHES["rescore"]
    out = fs.rescore(x, xsq, bias, q, gidx, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["rescore"] == before + 1
    _assert_close_with_inf(out, fs._rescore_ref(x, xsq, bias, q, gidx, metric=metric), 1e-5)


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_fused_search_on_card_matches_cpu(cuda, metric, storage):
    x, xsq, bias, q = _operands(4096, 64, 40, storage, cuda, seed=2)
    lex_rank = torch.from_numpy(np.random.default_rng(3).permutation(4096).astype(np.int32))
    got = fs.fused_flat_search(x, xsq, bias, lex_rank.to(cuda), q, metric=metric, k=16)
    want = fs.fused_flat_search(x.cpu(), xsq.cpu(), bias.cpu(), lex_rank, q.cpu(),
                                metric=metric, k=16)
    assert bool(got[3]) and bool(want[3])
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1].cpu() - want[1]).abs().max().item() <= 1e-5


def test_kernels_refuse_wrong_operands(cuda):
    x, xsq, bias, q = _operands(1024, 32, 8, "f32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fs.gmin_scan(x.t().contiguous().t(), xsq, bias, q, metric="cosine")
    with pytest.raises(ValueError, match="multiple"):
        fs.gmin_scan(x[:1000], xsq[:1000], bias[:1000], q, metric="cosine")
    with pytest.raises(TypeError, match="int32"):
        fs.rescore(x, xsq, bias, q, torch.zeros((8, 2), dtype=torch.int64, device=cuda),
                   metric="cosine")
