"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one (the ``gpu``
marker). Run them on the card with::

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Shapes are small but ragged on purpose: query counts that are not
multiples of the kernels' query tiles and widths that are not multiples of
their d-chunks. Tolerances as in ``chip_smoke.py``: group minima f32 atol
1e-5, bf16 atol 1e-4; rescored ranks atol 1e-5 (K4: 1e-5 * max(1,
|rank|)).
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


#: the rescores' selections: a top-k of the group minima, heavy overlap
#: (each query's groups out of a pool twice gsel wide), and mass sharing
#: (every query the same, with the same groups); B = 1, 16, 70, 130 and 257,
#: rows of 96 (the direct route) and of 33 and 99 (narrow)
RESCORE_CASES = ("topk", "overlap", "identical")
RESCORE_SHAPES = SHAPES + ((4096, 96, 1), (2048, 33, 16), (2048, 99, 257), (4096, 96, 257))


def _rescore_selection(case, gmin, gsel, seed=0):
    """``gidx`` [B, gsel] int32 on gmin's device for one RESCORE_CASES case."""
    b, ng = gmin.shape
    if case == "topk":
        return select.group_topk(gmin, gsel, check_c=4)[1].int()
    rng = np.random.default_rng(seed)
    if case == "identical":
        gidx = np.tile(rng.choice(ng, gsel, replace=False), (b, 1))
    else:
        pool = rng.choice(ng, min(ng, 2 * gsel), replace=False)
        gidx = np.stack([rng.choice(pool, gsel, replace=False) for _ in range(b)])
    return torch.from_numpy(gidx.astype(np.int32)).to(gmin.device)


def _route_of(rows, q):
    aligned = rows.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    return "direct" if aligned and rows.shape[1] * rows.element_size() % 16 == 0 else "narrow"


@pytest.mark.parametrize("case", RESCORE_CASES)
@pytest.mark.parametrize("shape", RESCORE_SHAPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_rescore_kernel_matches_plain(cuda, metric, storage, shape, case):
    x, xsq, bias, q = _operands(*shape, storage, cuda, seed=1)
    if case == "identical":
        q = q[:1].expand_as(q).contiguous()
    gidx = _rescore_selection(case, fs._gmin_scan_ref(x, xsq, bias, q, metric=metric), 12)
    before = fs.LAUNCHES["rescore"]
    routes = dict(fs.ROUTES["rescore"])
    out = fs.rescore(x, xsq, bias, q, gidx, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["rescore"] == before + 1
    route = _route_of(x, q)
    assert fs.ROUTES["rescore"][route] == routes[route] + 1
    _assert_close_with_inf(out, fs._rescore_ref(x, xsq, bias, q, gidx, metric=metric), 1e-5)


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("extra", [0, 1])
def test_rescore_kernels_chunk_rows_wider_than_a_stage(cuda, storage, extra):
    # a row past the 32 KB ring stage is staged one row at a time in column
    # chunks, its partial sums carried over them; extra = 1 takes the
    # narrow route
    elt = {"f32": 4, "bf16": 2, "int8": 1}[storage]
    d = fs.RESCORE_STAGE_BYTES // elt + 16 + extra
    x, xsq, bias, q = _operands(256, d, 5, "f32", cuda, seed=4)
    gidx = _rescore_selection("overlap", torch.zeros((5, 4), device=cuda), 3)
    if storage == "int8":
        x8, scale = fs.quantize_rows(x)
        out = fs.int8_rescore(x8, scale, xsq, bias, q, gidx, metric="l2")
        _assert_rel_close(out, fs._int8_rescore_ref(x8, scale, xsq, bias, q, gidx, metric="l2"),
                          1e-5)
        return
    if storage == "bf16":
        x = x.to(torch.bfloat16)
        xsq = (x.float() ** 2).sum(dim=1)
    out = fs.rescore(x, xsq, bias, q, gidx, metric="l2")
    _assert_close_with_inf(out, fs._rescore_ref(x, xsq, bias, q, gidx, metric="l2"), 1e-5)


def test_rescores_do_not_synchronize(cuda):
    # the work list is built on the card: no count is read back to the host
    # (64 x 12 pairs: sorted for K2's f32 rows on an H100; K4's int8 rows
    # and one query: in their own order)
    x, xsq, bias, q = _operands(4096, 96, 64, "f32", cuda, seed=5)
    x8, scale = fs.quantize_rows(x)
    gidx = _rescore_selection("overlap", torch.zeros((64, 64), device=cuda), 12)
    calls = [lambda g: fs.rescore(x, xsq, bias, q[:g.shape[0]], g, metric="cosine"),
             lambda g: fs.int8_rescore(x8, scale, xsq, bias, q[:g.shape[0]], g, metric="l2")]
    for call in calls:  # builds the library
        call(gidx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call(gidx)
            call(gidx[:1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


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


# ---------------------------------------------------------------------------
# K5 stage_gmin_scan, K6 fused_sign_scan, K7 extract_group_rows and the
# adaptive pipelines. Ragged on purpose: query counts across the 64-, 128-
# and 256-query tiles, prefix widths off the 128-byte k-stage (33) and on
# it (128), rows whose f32 or bf16 stride TMA cannot address (d = 99: the
# padded route), 17 groups (the last 128-row tile half empty), and sign
# widths off 4 bytes. Tolerances: K5 group minima and ranks f32 atol 1e-5,
# bf16 atol 1e-4; K6 and K7 bit-equal; pipelines the same slots and raws
# within 1e-5.
# ---------------------------------------------------------------------------

STAGE_SHAPES = ((4096, 96, 70, 33), (2048, 160, 130, 128), (1088, 160, 1, 128),
                (1088, 96, 257, 33), (1088, 99, 70, 33), (1088, 128, 257, 128))  # (n, d, b, dims)
SIGN_SHAPES = ((4096, 128, 70), (2048, 77, 130), (1024, 6, 3))  # (n, d, b)


def _signs(n, d, b, device, seed=0):
    rng = np.random.default_rng(seed)
    signs = torch.from_numpy((rng.integers(0, 2, (n, d)) * 2 - 1).astype(np.int8))
    qsigns = torch.from_numpy((rng.integers(0, 2, (b, d)) * 2 - 1).astype(np.int8))
    valid8 = torch.ones(n, dtype=torch.int8)
    valid8[rng.choice(n, 7, replace=False)] = 0
    return signs.to(device), valid8.to(device), qsigns.to(device)


@pytest.mark.parametrize("shape", STAGE_SHAPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_stage_gmin_scan_kernel_matches_plain(cuda, metric, storage, shape):
    n, d, b, dims = shape
    x, _xsq, bias, q = _operands(n, d, b, storage, cuda, seed=4)
    xsq = (x[:, :dims].float() ** 2).sum(dim=1)
    before = fs.LAUNCHES["stage_gmin_scan"]
    gmin, rank, bounded = fs.stage_gmin_scan(x, xsq, bias, q, metric=metric, dims=dims)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["stage_gmin_scan"] == before + 1
    assert bool(bounded)
    want_gmin, want_rank = fs._stage_gmin_scan_ref(x, xsq, bias, q, metric=metric, dims=dims)
    _assert_close_with_inf(gmin, want_gmin, GMIN_ATOL[storage])
    _assert_close_with_inf(rank, want_rank, GMIN_ATOL[storage])


def test_stage_gmin_scan_counts_its_operand_route(cuda):
    # f32 rows of 160 values (640 bytes) and bf16 rows (320 bytes) are read
    # in place, their first 128 columns through TMA's box; rows of 99 values
    # (396 and 198 bytes) have their prefix copied to a 16-byte stride first
    before = dict(fs.ROUTES["stage_gmin_scan"])
    for d, direct in ((160, True), (99, False)):
        x, _xsq, bias, q = _operands(1088, d, 5, "f32", cuda, seed=d)
        for xs in (x, x.to(torch.bfloat16)):
            xsq = (xs[:, :64].float() ** 2).sum(dim=1)
            got = fs.stage_gmin_scan(xs, xsq, bias, q, metric="l2", dims=64)
            want = fs._stage_gmin_scan_ref(xs, xsq, bias, q, metric="l2", dims=64)
            atol = GMIN_ATOL["bf16" if xs.dtype == torch.bfloat16 else "f32"]
            for g, w in zip(got[:2], want):
                _assert_close_with_inf(g, w, atol)
    torch.cuda.synchronize()
    assert fs.ROUTES["stage_gmin_scan"] == {"direct": before["direct"] + 2,
                                            "padded": before["padded"] + 2}


@pytest.mark.parametrize("where", ["rows", "query"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["cosine", "l2_squared", "negative_inner_product"])
def test_stage_gmin_scan_huge_norms_and_dead_rows(cuda, metric, storage, where):
    # as K1's test: rows of +-1e19 entries (squared norms inf), scattered
    # rows of norm 1e16, or a query of norm 1e20, and a group of dead rows.
    # The batch fails the overflow bound; the kernel's non-finite ranks and
    # minima are the plain version's, and its finite ones lie within atol of
    # them in units of the terms each rank sums (1 for cosine over the whole
    # row, |x| |q| for the dot, (|x| + |q|)^2 for l2 squared)
    rng = np.random.default_rng(16)
    x, _xsq, bias, q = _operands(K1_ROWS, 256, 40, "f32", "cpu", seed=17)
    if where == "rows":
        x[128:192] = torch.from_numpy(rng.choice([-1e19, 1e19], (64, 256)).astype(np.float32))
        x[[7, 700, 1000]] *= 1e16
    else:
        q[3] *= 1e20
    x[320:384] = 0.0
    bias[320:384] = float("inf")
    if storage == "bf16":
        x = x.to(torch.bfloat16)
    xsq = (x.float() ** 2).sum(dim=1)
    x, xsq, bias, q = (t.to(cuda) for t in (x, xsq, bias, q))
    gmin, rank, bounded = fs.stage_gmin_scan(x, xsq, bias, q, metric=metric, dims=256)
    torch.cuda.synchronize()
    assert not bool(bounded)
    want_gmin, want_rank = fs._stage_gmin_scan_ref(x, xsq, bias, q, metric=metric, dims=256)
    xn, qn = x.double().norm(dim=1), q.double().norm(dim=1)
    if metric == "cosine":
        terms = torch.ones((q.shape[0], x.shape[0]), dtype=torch.float64, device=cuda)
    elif metric == "l2_squared":
        terms = (qn[:, None] + xn[None, :]) ** 2
    else:
        terms = qn[:, None] * xn[None, :]
    sizes = (terms.clamp_min(1.0), terms.view(q.shape[0], -1, fs.GROUP).amax(dim=-1).clamp_min(1.0))
    for got, want, size in zip((rank, gmin), (want_rank, want_gmin), sizes):
        fin = torch.isfinite(want)
        assert not bool(fin.all()) and bool(fin.any())
        assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
        err = (got.double() - want.double()).abs()
        assert bool((err[fin] <= GMIN_ATOL[storage] * size[fin]).all())


@pytest.mark.parametrize("shape", SIGN_SHAPES)
def test_sign_scan_kernel_matches_plain(cuda, shape):
    n, d, b = shape
    signs, valid8, qsigns = _signs(n, d, b, cuda)
    before = fs.LAUNCHES["sign_scan"]
    gmin, ham16 = fs.fused_sign_scan(signs, valid8, qsigns, d=d)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["sign_scan"] == before + 1
    want_gmin, want_ham = fs._fused_sign_scan_ref(signs, valid8, qsigns, d=d)
    assert gmin.dtype == torch.int32 and ham16.dtype == torch.int16
    assert torch.equal(gmin, want_gmin)
    assert torch.equal(ham16, want_ham)


def test_sign_scan_kernel_reads_unaligned_rows(cuda):
    # a block starting one byte into a larger one, 127 bytes a row: TMA
    # cannot address it, so the wrapper copies it to a 16-byte stride
    signs, valid8, qsigns = _signs(1088, 128, 5, cuda, seed=3)
    off = signs.flatten()[1:1 + 1024 * 127].view(1024, 127)
    assert off.data_ptr() % 4
    gmin, ham16 = fs.fused_sign_scan(off, valid8[:1024], qsigns[:, :127].contiguous(), d=127)
    want_gmin, want_ham = fs._fused_sign_scan_ref(off, valid8[:1024],
                                                  qsigns[:, :127].contiguous(), d=127)
    assert torch.equal(gmin, want_gmin) and torch.equal(ham16, want_ham)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16])
@pytest.mark.parametrize("c", [1, 65, 500])
def test_extract_group_rows_kernel_matches_plain(cuda, dtype, c):
    rng = np.random.default_rng(c)
    b, rows = 37, 300
    mat = torch.from_numpy(rng.integers(-30000, 30000, (b, rows, 64))).to(dtype).to(cuda)
    gidx = torch.from_numpy(rng.integers(0, rows, (b, c)).astype(np.int32)).to(cuda)
    gidx[0, 0] = rows + 5  # out of range: clamped by both versions
    gidx[-1, -1] = -3
    before = fs.LAUNCHES["extract_group_rows"]
    out = fs.extract_group_rows(mat, gidx)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["extract_group_rows"] == before + 1
    assert torch.equal(out, fs._extract_group_rows_ref(mat, gidx))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_fused_stage_candidates_on_card_matches_cpu(cuda, metric, storage):
    x, _xsq, bias, q = _operands(4096, 256, 40, storage, cuda, seed=5)
    xsq = (x[:, :128].float() ** 2).sum(dim=1)
    got = fs.fused_stage_candidates(x, xsq, bias, q, metric=metric, count=50, dims=128)
    want = fs.fused_stage_candidates(x.cpu(), xsq.cpu(), bias.cpu(), q.cpu(), metric=metric,
                                     count=50, dims=128)
    assert bool(got[2].all()) and bool(want[2].all())
    assert torch.equal(got[0].cpu(), want[0])


def _pipeline_state(device, n=8192, d=128, seed=6):
    from vettore_tpu_torch.ops import pipeline as pipe

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[-9:] = 0.0
    valid = torch.ones(n, dtype=torch.bool)
    valid[-9:] = False
    xt = torch.from_numpy(x)
    signs = torch.where(xt >= 0, 1, -1).to(torch.int8)
    q = torch.from_numpy(x[rng.integers(0, n - 9, 24)]
                         + 0.2 * rng.normal(size=(24, d)).astype(np.float32))
    return pipe, tuple(t.to(device) for t in (xt, valid, signs, q))


@pytest.mark.parametrize("d", [128, 100])
@pytest.mark.parametrize("mode", ["funnel", "quantized"])
def test_pipelines_on_card_match_cpu(cuda, monkeypatch, mode, d):
    # d = 100: a stage-1 prefix of 64 columns and a sign row of 100 bytes,
    # both off the TPU's 128-lane tile, still run K5 and K6
    pipe, state = _pipeline_state(cuda, d=d)
    monkeypatch.setattr(pipe, "_FUSED_STAGE_MIN", 2048)
    monkeypatch.setattr(pipe, "_GROUP_COVER_MIN", 2048)
    dims = 128 if d == 128 else 64

    def run(x, valid, signs, q):
        if mode == "funnel":
            xsq = (x[:, :dims].float() ** 2).sum(dim=1)
            return pipe.funnel_pipeline_batch(x, valid, q, xsq, metric="cosine",
                                              stages=(dims, d), count=60, limit=10)
        return pipe.quantized_pipeline_batch(x, signs, valid, q, metric="cosine", count=100,
                                             limit=10, d=d)

    before = dict(fs.LAUNCHES)
    got = run(*state)
    torch.cuda.synchronize()
    grew = [k for k in fs.LAUNCHES if fs.LAUNCHES[k] > before[k]]
    assert grew == (["stage_gmin_scan", "extract_group_rows"] if mode == "funnel"
                    else ["sign_scan", "extract_group_rows"])
    want = run(*(t.cpu() for t in state))
    assert bool(got[3].all()) and bool(want[3].all())
    assert torch.equal(got[0].cpu(), want[0])
    assert (got[1].cpu() - want[1]).abs().max().item() <= 1e-5


def test_hamming_slots_at_a_wide_d_need_no_global_composite(cuda, monkeypatch):
    """The group cover's position keys at d = 3072, where a million rows
    would need a 32-bit global (hamming, slot) key: with that key refused,
    K6 and K7's selection on the card equals the CPU's plain one and a
    brute (hamming, slot) sort, every query ``ok``, on heavy ties."""
    from vettore_tpu_torch.ops import pipeline as pipe

    monkeypatch.setattr(pipe, "_GROUP_COVER_MIN", 2048)
    monkeypatch.setattr(pipe, "_composite_bits", lambda n, d: None)
    rng = np.random.default_rng(7)
    n, d, b, count = 16384, 3072, 24, 200
    base = rng.integers(0, 2, (40, d)) * 2 - 1
    signs = torch.from_numpy(base[rng.integers(0, 40, n)].astype(np.int8))
    valid = torch.arange(n) < n - 11
    valid[[0, 64, 65, 999]] = False
    qs = torch.from_numpy(np.where(rng.normal(size=(b, d)) >= 0, 1, -1).astype(np.int8))
    before = dict(fs.LAUNCHES)
    got = pipe._hamming_slots(signs.to(cuda), valid.to(cuda), qs.to(cuda), count=count, d=d)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["sign_scan"] > before["sign_scan"]
    want = pipe._hamming_slots(signs, valid, qs, count=count, d=d)
    ham = (d - qs.long() @ signs.long().T) // 2
    key = torch.where(valid[None, :], ham * n + torch.arange(n)[None, :], 2**62)
    brute = key.topk(count, dim=1, largest=False).values
    assert bool(got[2].all()) and bool(want[2].all())
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0].cpu(), brute % n)
    assert torch.equal(got[1].cpu(), (brute // n).float())


def test_adaptive_kernels_refuse_wrong_operands(cuda):
    x, xsq, bias, q = _operands(1024, 256, 8, "f32", cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fs.stage_gmin_scan(x.t().contiguous().t(), xsq, bias, q, metric="cosine", dims=128)
    with pytest.raises(ValueError, match="dims"):
        fs.stage_gmin_scan(x, xsq, bias, q, metric="cosine", dims=300)
    with pytest.raises(ValueError, match="metric"):
        fs.stage_gmin_scan(x, xsq, bias, q, metric="manhattan", dims=128)
    signs, valid8, qsigns = _signs(1024, 128, 4, cuda)
    with pytest.raises(TypeError, match="int8"):
        fs.fused_sign_scan(signs.float(), valid8, qsigns, d=128)
    with pytest.raises(ValueError, match="columns"):
        fs.fused_sign_scan(signs, valid8, qsigns, d=64)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_sign_scan(signs.t().contiguous().t(), valid8, qsigns, d=128)
    mat = torch.zeros((4, 16, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        fs.extract_group_rows(mat, torch.zeros((4, 2), dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError, match="float32 or int16"):
        fs.extract_group_rows(mat.double(), torch.zeros((4, 2), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="16 bytes"):
        fs.extract_group_rows(mat[:, :, :3].contiguous(),
                              torch.zeros((4, 2), dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# K3 int8_gmin_scan, K4 int8_rescore and the MaxSim rank scan. Ragged on
# purpose: int8 widths off 4 bytes; MaxSim token counts T = 1, 3 (padded to
# 4), 16, 32, 128, 256 and 300 (padded to 384: three 128-row chunks per
# doc), query sets of 1, 3, 4, 32 and 300 tokens (the last wider than any
# query tile), 130 sets of one token (across query tiles), d = 77 (the
# padded route) and 128; caps off the TPU's 128-doc tile. Tolerances:
# K3 bit-equal; K4 1e-5 * max(1, |rank|); the MaxSim ranks 1e-5 * max(1,
# |rank|) for f32 blocks and 1e-4 * max(1, |rank|) for bf16 blocks;
# searches the same slots, and raws or scores within 1e-5 * max(1, |x|).
# ---------------------------------------------------------------------------

INT8_SHAPES = ((4096, 96, 70), (2048, 77, 130), (1024, 6, 3))  # (n, d, b)


def _int8_operands(n, d, b, device, seed=0):
    x, xsq, bias, q = _operands(n, d, b, "f32", device, seed=seed)
    x8, scale = fs.quantize_rows(x)
    q8, qscale = fs.quantize_rows(q)
    return x8, scale, xsq, bias, q, q8, qscale, (q * q).sum(dim=1)


def _assert_rel_close(got, want, tol):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
    err = (got[fin] - want[fin]).abs() / want[fin].abs().clamp_min(1.0)
    assert err.max().item() <= tol


@pytest.mark.parametrize("shape", INT8_SHAPES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_int8_gmin_scan_kernel_is_bit_equal(cuda, metric, shape):
    x8, scale, xsq, bias, _q, q8, qscale, qsq = _int8_operands(*shape, cuda)
    before = fs.LAUNCHES["int8_gmin_scan"]
    gmin, bounded = fs.int8_gmin_scan(x8, scale, xsq, bias, q8, qscale, qsq, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["int8_gmin_scan"] == before + 1 and bool(bounded)
    assert torch.equal(gmin, fs._int8_gmin_scan_ref(x8, scale, xsq, bias, q8, qscale, qsq,
                                                    metric=metric))


@pytest.mark.parametrize("case", ("random",) + RESCORE_CASES[1:])
@pytest.mark.parametrize("shape", INT8_SHAPES + RESCORE_SHAPES[2:])
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_int8_rescore_kernel_matches_plain(cuda, metric, shape, case):
    x8, scale, xsq, bias, q, *_ = _int8_operands(*shape, cuda, seed=1)
    ng = shape[0] // fs.GROUP
    if case == "random":
        gidx = torch.randint(0, ng, (shape[2], min(12, ng)), dtype=torch.int32, device=cuda)
    else:
        if case == "identical":
            q = q[:1].expand_as(q).contiguous()
        gidx = _rescore_selection(case, torch.zeros((shape[2], ng), device=cuda), min(12, ng))
    gidx[0, 0] = ng + 3  # out of range: clamped by both versions
    before = fs.LAUNCHES["int8_rescore"]
    routes = dict(fs.ROUTES["int8_rescore"])
    out = fs.int8_rescore(x8, scale, xsq, bias, q, gidx, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["int8_rescore"] == before + 1
    route = _route_of(x8, q)
    assert fs.ROUTES["int8_rescore"][route] == routes[route] + 1
    want = fs._int8_rescore_ref(x8, scale, xsq, bias, q, gidx.clamp(0, ng - 1), metric=metric)
    _assert_rel_close(out, want, 1e-5)


def test_int8_gmin_scan_kernel_reads_unaligned_rows(cuda):
    x8, scale, xsq, bias, _q, q8, qscale, qsq = _int8_operands(1088, 128, 5, cuda, seed=2)
    off = x8.flatten()[1:1 + 1024 * 127].view(1024, 127)
    assert off.data_ptr() % 4
    qo = q8[:, :127].contiguous()
    args = (off, scale[:1024].contiguous(), xsq[:1024].contiguous(),
            bias[:1024].contiguous(), qo, qscale, qsq)
    got, _ = fs.int8_gmin_scan(*args, metric="l2")
    assert torch.equal(got, fs._int8_gmin_scan_ref(*args, metric="l2"))


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_int8_index_on_card_matches_cpu(cuda, metric):
    from vettore_tpu_torch.index.flat import FlatIndex

    rng = np.random.default_rng(3)
    data = rng.normal(size=(5000, 100)).astype(np.float32)
    ids = [f"d{i:05d}" for i in rng.permutation(5000)]
    queries = data[:40] + 0.2 * rng.normal(size=(40, 100)).astype(np.float32)
    got, want = (FlatIndex(metric, storage="int8", device=dev) for dev in (cuda, "cpu"))
    for index in (got, want):
        index.put_matrix(ids, data)
    before = dict(fs.LAUNCHES)
    hits = got.search_batch(queries, 10)
    assert fs.LAUNCHES["int8_gmin_scan"] > before["int8_gmin_scan"]
    assert fs.LAUNCHES["int8_rescore"] > before["int8_rescore"]
    assert [[h[0] for h in row] for row in hits] == [
        [h[0] for h in row] for row in want.search_batch(queries, 10)]
    assert got.host_routes == 0


MV_SHAPES = ((192, 1, 96, 5, 4), (320, 3, 77, 7, 3), (640, 32, 128, 4, 4),
             (100, 32, 128, 130, 1), (200, 16, 128, 3, 32), (130, 128, 128, 6, 4),
             (70, 256, 77, 2, 3), (96, 3, 128, 1, 300), (40, 300, 128, 3, 4),
             (150, 1, 128, 130, 1))  # (docs, T, d, query sets, tokens per set)


def _mv_operands(n, t, d, b, nq, storage, device, seed=0, full=False):
    """Rank-scan operands; ``full`` gives every doc all ``t`` tokens, else
    random counts 0..t."""
    rng = np.random.default_rng(seed)
    # unit-scale rows (norms 0.5..2): inner products of order 1, so 1e-5
    # measures the kernel and not the cancellation of large random sums
    tokens = rng.standard_normal((n, t, d)).astype(np.float32)
    tokens /= np.linalg.norm(tokens, axis=2, keepdims=True)
    tokens *= rng.uniform(0.5, 2.0, (n, t, 1)).astype(np.float32)
    counts = np.full(n, t, np.int32) if full else rng.integers(0, t + 1, n).astype(np.int32)
    tokens[np.arange(t)[None, :] >= counts[:, None]] = 0.0
    dbias = np.where(rng.random(n) < 0.05, np.inf, 0.0).astype(np.float32)
    qt = rng.standard_normal((b * nq, d)).astype(np.float32)
    qt /= np.linalg.norm(qt, axis=1, keepdims=True)
    qt[-1] = 0.0  # a pad query token
    qn = np.linalg.norm(qt, axis=1)
    qinv = np.where(qn > 0, 1.0 / np.maximum(qn, 1e-38), 0.0).astype(np.float32)
    tt = torch.from_numpy(tokens).to(device)
    if storage == "bf16":
        tt = tt.to(torch.bfloat16)
    return (tt, torch.from_numpy(counts).to(device), torch.from_numpy(dbias).to(device),
            torch.from_numpy(qt).to(device), torch.from_numpy(qinv).to(device))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", MV_SHAPES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["cosine", "inner_product", "negative_inner_product"])
def test_maxsim_rank_scan_kernel_matches_plain(cuda, metric, storage, shape, masked):
    from vettore_tpu_torch.ops import maxsim as ms

    n, t, d, b, nq = shape
    tokens, counts, dbias, qt, qinv = _mv_operands(n, t, d, b, nq, storage, cuda,
                                                   full=not masked)
    before = ms.LAUNCHES["maxsim_rank_scan"]
    rank = ms.maxsim_rank_scan(tokens, counts, dbias, qt, qinv, b=b, metric=metric)
    torch.cuda.synchronize()
    assert ms.LAUNCHES["maxsim_rank_scan"] == before + 1
    qs = qt.to(torch.bfloat16).float() if storage == "bf16" else qt
    want = ms._maxsim_rank_scan_ref(tokens, counts, dbias, qs, qinv, b=b, metric=metric)
    _assert_rel_close(rank, want, 1e-5 if storage == "f32" else 1e-4)


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_fused_maxsim_on_card_matches_cpu(cuda, metric, storage, uniform):
    from vettore_tpu_torch.ops import maxsim as ms

    rng = np.random.default_rng(4)
    n, t, d = 960, 8, 64
    # config 5's geometry: unit doc centres plus token noise 0.3/sqrt(d)
    centres = rng.standard_normal((n, 1, d))
    centres /= np.linalg.norm(centres, axis=2, keepdims=True)
    tokens = (centres + 0.3 / np.sqrt(d) * rng.standard_normal((n, t, d))).astype(np.float32)
    counts = np.full(n, t, np.int32) if uniform else rng.integers(1, t + 1, n).astype(np.int32)
    counts[900:] = 0
    tokens[np.arange(t)[None, :] >= counts[:, None]] = 0.0
    valid = np.arange(n) < 900
    qtok = tokens[rng.integers(0, 900, 24), :4] + 0.1 / np.sqrt(d) * rng.standard_normal(
        (24, 4, d))
    qtok = qtok.astype(np.float32)
    qmask = np.ones((24, 4), bool)
    qmask[3, 2:] = False
    qtok[~qmask] = 0.0
    args = [torch.from_numpy(a) for a in (tokens, counts, valid, qtok, qmask)]
    if storage == "bf16":
        args[0] = args[0].to(torch.bfloat16)
    got = ms.fused_maxsim_topk_batch(*(a.to(cuda) for a in args), metric=metric, limit=10)
    want = ms.fused_maxsim_topk_batch(*args, metric=metric, limit=10)
    assert bool(got[2].all()) and bool(want[2].all())
    assert torch.equal(got[0].cpu(), want[0])
    _assert_rel_close(got[1].cpu(), want[1], 1e-5)


@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_single_set_search_on_card_launches_the_kernel(cuda, metric):
    import vettore_tpu_torch as vt
    from vettore_tpu_torch.ops import maxsim as ms

    rng = np.random.default_rng(5)
    records = [{"id": f"m{i:04d}", "vectors": rng.standard_normal((int(rng.integers(1, 6)), 48))
                .astype(np.float32).tolist()} for i in range(300)]
    query = rng.standard_normal((3, 48)).astype(np.float32).tolist()
    got, want = (vt.Collection(name="mv", dimensions=48, metric=metric, device=dev)
                 for dev in (cuda, "cpu"))
    for col in (got, want):
        col.put_many(records)
    before = ms.LAUNCHES["maxsim_rank_scan"]
    hits = got.multi_vector_search(query, limit=10)
    assert ms.LAUNCHES["maxsim_rank_scan"] == before + 1
    assert [r.id for r in hits] == [r.id for r in want.multi_vector_search(query, limit=10)]
    assert got.host_routes == 0


def test_maxsim_rank_scan_counts_its_operand_route(cuda):
    # blocks of T = 32 (a power of two) and d = 128 go to TMA in place, with
    # sets of 4 tokens or of 3 (the query padded to 4, not counted); T = 3
    # (the block grown to 4 tokens a doc) and d = 77 (a row stride off 16
    # bytes) are copied first
    from vettore_tpu_torch.ops import maxsim as ms

    before = dict(ms.ROUTES["maxsim_rank_scan"])
    cases = ((64, 32, 128, 3, 4, True), (64, 32, 128, 3, 3, True), (64, 3, 128, 3, 4, False),
             (64, 32, 77, 3, 4, False))
    for n, t, d, b, nq, direct in cases:
        for storage in STORAGES:
            args = _mv_operands(n, t, d, b, nq, storage, cuda, seed=t + d)
            rank = ms.maxsim_rank_scan(*args, b=b, metric="cosine")
            qs = args[3].to(torch.bfloat16).float() if storage == "bf16" else args[3]
            want = ms._maxsim_rank_scan_ref(*args[:3], qs, args[4], b=b, metric="cosine")
            _assert_rel_close(rank, want, 1e-5 if storage == "f32" else 1e-4)
    torch.cuda.synchronize()
    assert ms.ROUTES["maxsim_rank_scan"] == {"direct": before["direct"] + 4,
                                             "padded": before["padded"] + 4}


def test_cached_token_norms_equal_per_call_ones(cuda):
    # the scan cache's (tsq, tinv) are token_norms of its block, and the
    # rank scan gives the same ranks with them as with its own
    import vettore_tpu_torch as vt
    from vettore_tpu_torch.ops import maxsim as ms

    rng = np.random.default_rng(8)
    records = [{"id": f"m{i:04d}", "vectors": rng.standard_normal((int(rng.integers(1, 9)), 64))
                .astype(np.float32).tolist()} for i in range(200)]
    col = vt.Collection(name="mv", dimensions=64, metric="cosine", device=cuda)
    col.put_many(records)
    cache = col._scan_cache()
    tokens, counts = cache.multi_vectors()
    tsq, tinv = cache.token_norms()
    assert cache.token_norms()[1] is tinv
    want_tsq, want_tinv = ms.token_norms(tokens)
    assert torch.equal(tsq, want_tsq) and torch.equal(tinv, want_tinv)
    qt = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(cuda)
    qinv = 1.0 / qt.norm(dim=1)
    dbias = torch.zeros(tokens.shape[0], device=cuda)
    args = (tokens, counts, dbias, qt, qinv)
    assert torch.equal(ms.maxsim_rank_scan(*args, b=2, metric="cosine", tinv=tinv),
                       ms.maxsim_rank_scan(*args, b=2, metric="cosine"))
    col.close()


def test_new_kernels_refuse_wrong_operands(cuda):
    from vettore_tpu_torch.ops import maxsim as ms

    x8, scale, xsq, bias, q, q8, qscale, qsq = _int8_operands(1024, 32, 8, cuda)
    with pytest.raises(TypeError, match="int8"):
        fs.int8_gmin_scan(x8.float(), scale, xsq, bias, q8, qscale, qsq, metric="cosine")
    with pytest.raises(ValueError, match="contiguous"):
        fs.int8_gmin_scan(x8.t().contiguous().t(), scale, xsq, bias, q8, qscale, qsq,
                          metric="cosine")
    with pytest.raises(ValueError, match="multiple"):
        fs.int8_gmin_scan(x8[:1000], scale[:1000], xsq[:1000], bias[:1000], q8, qscale, qsq,
                          metric="cosine")
    with pytest.raises(TypeError, match="int32"):
        fs.int8_rescore(x8, scale, xsq, bias, q, torch.zeros((8, 2), dtype=torch.int64,
                                                             device=cuda), metric="cosine")
    tokens, counts, dbias, qt, qinv = _mv_operands(128, 4, 32, 2, 2, "f32", cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ms.maxsim_rank_scan(tokens.half(), counts, dbias, qt, qinv, b=2, metric="cosine")
    with pytest.raises(TypeError, match="int32"):
        ms.maxsim_rank_scan(tokens, counts.long(), dbias, qt, qinv, b=2, metric="cosine")
    with pytest.raises(ValueError, match="metric"):
        ms.maxsim_rank_scan(tokens, counts, dbias, qt, qinv, b=2, metric="l2")
    with pytest.raises(ValueError, match="contiguous"):
        ms.maxsim_rank_scan(tokens.transpose(0, 1).contiguous().transpose(0, 1), counts, dbias,
                            qt, qinv, b=2, metric="cosine")
    big = torch.zeros((ms.MAX_QUERY_TOKENS + 1, 32), device=cuda)
    with pytest.raises(ValueError, match="exceed"):
        ms.maxsim_rank_scan(tokens, counts, dbias, big, torch.zeros(big.shape[0], device=cuda),
                            b=1, metric="cosine")


# ---------------------------------------------------------------------------
# K3 and K6 on the int8 tensor cores: the edges of their shared s8 wgmma
# mainloop (csrc/wgmma_scan.cuh, policy S8). Query counts across its 64-, 128- and
# 256-query tiles, widths across its 128-byte k-stages and TMA's 16-byte
# stride rule (d = 100 takes the padded route), 17 groups (the last
# 128-row tile half empty), operands at +-127, and K6 at its widest d. All
# bit-equal to the plain versions.
# ---------------------------------------------------------------------------

S8_BATCHES = (1, 8, 129, 256, 257)
S8_WIDTHS = (32, 100, 768, 4096)
S8_ROWS = 17 * 64


@pytest.mark.parametrize("d", S8_WIDTHS)
@pytest.mark.parametrize("b", S8_BATCHES)
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_int8_gmin_scan_tensor_core_edges(cuda, metric, b, d):
    x8, scale, xsq, bias, _q, q8, qscale, qsq = _int8_operands(S8_ROWS, d, b, cuda, seed=b + d)
    args = (x8, scale, xsq, bias, q8, qscale, qsq)
    gmin, bounded = fs.int8_gmin_scan(*args, metric=metric)
    torch.cuda.synchronize()
    assert bool(bounded)
    assert torch.equal(gmin, fs._int8_gmin_scan_ref(*args, metric=metric))


@pytest.mark.parametrize("d", S8_WIDTHS)
@pytest.mark.parametrize("b", S8_BATCHES)
def test_sign_scan_tensor_core_edges(cuda, b, d):
    signs, valid8, qsigns = _signs(S8_ROWS, d, b, cuda, seed=b + d)
    gmin, ham16 = fs.fused_sign_scan(signs, valid8, qsigns, d=d)
    torch.cuda.synchronize()
    want_gmin, want_ham = fs._fused_sign_scan_ref(signs, valid8, qsigns, d=d)
    assert torch.equal(gmin, want_gmin) and torch.equal(ham16, want_ham)


@pytest.mark.parametrize("d", [768, 4096])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_int8_gmin_scan_saturated_operands(cuda, metric, d):
    # every product is +-127 * 127, and one group of all-127 rows meets an
    # all-127 and an all--127 query: dots of +-d * 127**2, the int32
    # accumulator's extreme at these widths
    rng = np.random.default_rng(d)
    n, b = S8_ROWS, 129
    x8 = torch.from_numpy((rng.integers(0, 2, (n, d)) * 254 - 127).astype(np.int8))
    q8 = torch.from_numpy((rng.integers(0, 2, (b, d)) * 254 - 127).astype(np.int8))
    x8[:64] = 127
    q8[0], q8[1] = 127, -127
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    qscale = torch.from_numpy(rng.uniform(1e-4, 1e-3, b).astype(np.float32))
    xsq = ((x8.float() * scale[:, None]) ** 2).sum(dim=1)
    qsq = ((q8.float() * qscale[:, None]) ** 2).sum(dim=1)
    bias = torch.zeros(n)
    bias[rng.choice(n, 5, replace=False)] = float("inf")
    args = tuple(t.to(cuda) for t in (x8, scale, xsq, bias, q8, qscale, qsq))
    gmin, bounded = fs.int8_gmin_scan(*args, metric=metric)
    torch.cuda.synchronize()
    assert bool(bounded)
    assert torch.equal(gmin, fs._int8_gmin_scan_ref(*args, metric=metric))


def test_sign_scan_at_the_widest_d(cuda):
    d = fs._BIG16 // 2 - 1  # 16,382: the widest d whose Hamming fits int16
    signs, valid8, qsigns = _signs(S8_ROWS, d, 5, cuda, seed=9)
    gmin, ham16 = fs.fused_sign_scan(signs, valid8, qsigns, d=d)
    torch.cuda.synchronize()
    want_gmin, want_ham = fs._fused_sign_scan_ref(signs, valid8, qsigns, d=d)
    assert torch.equal(gmin, want_gmin) and torch.equal(ham16, want_ham)


def test_tensor_core_scans_count_their_operand_route(cuda):
    # contiguous d = 768 blocks (the main path's) are read in place by TMA;
    # a block one byte into a larger one, or d = 127, is copied first
    x8, scale, xsq, bias, _q, q8, qscale, qsq = _int8_operands(1088, 768, 40, cuda)
    signs, valid8, qsigns = _signs(1088, 768, 40, cuda)
    before = {k: dict(v) for k, v in fs.ROUTES.items()}
    fs.int8_gmin_scan(x8, scale, xsq, bias, q8, qscale, qsq, metric="cosine")
    fs.fused_sign_scan(signs, valid8, qsigns, d=768)
    for name in ("int8_gmin_scan", "sign_scan"):
        assert fs.ROUTES[name] == {"direct": before[name]["direct"] + 1,
                                   "padded": before[name]["padded"]}
    off = signs.flatten()[1:1 + 1024 * 127].view(1024, 127)
    fs.fused_sign_scan(off, valid8[:1024], qsigns[:, :127].contiguous(), d=127)
    off8 = x8.flatten()[16:16 + 1024 * 768].view(1024, 768)  # aligned, in place
    fs.int8_gmin_scan(off8, scale[:1024].contiguous(), xsq[:1024].contiguous(),
                      bias[:1024].contiguous(), q8, qscale, qsq, metric="l2")
    torch.cuda.synchronize()
    assert fs.ROUTES["sign_scan"]["padded"] == before["sign_scan"]["padded"] + 1
    assert fs.ROUTES["int8_gmin_scan"]["direct"] == before["int8_gmin_scan"]["direct"] + 2


# ---------------------------------------------------------------------------
# K1 gmin_scan on the tensor cores: the bf16 and 3xTF32 policies of the
# shared scan skeleton (csrc/wgmma_scan.cuh). Query counts across the 64-,
# 128- and 256-query tiles, widths across the 128-byte k-stages and TMA's
# 16-byte stride rule (f32 d = 127 and bf16 d = 100 and 127 take the padded
# route), 17 groups (the last 128-row tile half empty), dead rows, rows and
# queries of huge norm, and a near-tie corpus that only an f32-accurate
# scan orders. Tolerances as above: f32 atol 1e-5, bf16 atol 1e-4 (relative
# to max(1, |rank|) where ranks are huge).
# ---------------------------------------------------------------------------

K1_BATCHES = (1, 8, 129, 256, 257)
K1_WIDTHS = (32, 100, 127, 768, 4096)
K1_ROWS = 17 * 64


@pytest.mark.parametrize("d", K1_WIDTHS)
@pytest.mark.parametrize("b", K1_BATCHES)
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", fs.FUSED_METRICS)
def test_gmin_scan_tensor_core_edges(cuda, metric, storage, b, d):
    x, xsq, bias, q = _operands(K1_ROWS, d, b, storage, cuda, seed=b + d)
    before = fs.LAUNCHES["gmin_scan"]
    gmin, bounded = fs.gmin_scan(x, xsq, bias, q, metric=metric)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["gmin_scan"] == before + 1 and bool(bounded)
    _assert_close_with_inf(gmin, fs._gmin_scan_ref(x, xsq, bias, q, metric=metric),
                           GMIN_ATOL[storage])


@pytest.mark.parametrize("where", ["rows", "query"])
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("metric", ["cosine", "l2", "negative_inner_product"])
def test_gmin_scan_huge_norms_and_dead_rows(cuda, metric, storage, where):
    # rows of +-1e19 entries (their squared norms overflow to inf: l2 ranks
    # +inf), scattered rows of norm 1e16, or a query of norm 1e20; a whole
    # group of dead rows (+inf). The batch fails the overflow bound, the
    # kernel's infinite minima are the plain version's, and its finite ones
    # lie within atol of them in units of the size of the terms each rank
    # sums (|x_r| |q_b| for the dot metrics, (|x_r| + |q_b|)^2 for l2): two
    # f32 sums of a dot with large cancellation agree to a fraction of
    # that, not of the dot
    rng = np.random.default_rng(13)
    x, _xsq, bias, q = _operands(K1_ROWS, 768, 40, "f32", "cpu", seed=14)
    if where == "rows":
        x[128:192] = torch.from_numpy(rng.choice([-1e19, 1e19], (64, 768)).astype(np.float32))
        x[[7, 700, 1000]] *= 1e16
    else:
        q[3] *= 1e20
    x[320:384] = 0.0
    bias[320:384] = float("inf")
    if storage == "bf16":
        x = x.to(torch.bfloat16)
    xsq = (x.float() ** 2).sum(dim=1)
    x, xsq, bias, q = (t.to(cuda) for t in (x, xsq, bias, q))
    gmin, bounded = fs.gmin_scan(x, xsq, bias, q, metric=metric)
    torch.cuda.synchronize()
    assert not bool(bounded)
    want = fs._gmin_scan_ref(x, xsq, bias, q, metric=metric)
    fin = torch.isfinite(want)
    assert not bool(fin.all()) and bool(fin.any())
    assert torch.equal(torch.isfinite(gmin), fin) and torch.equal(gmin[~fin], want[~fin])
    xn, qn = x.double().norm(dim=1), q.double().norm(dim=1)
    terms = (qn[:, None] + xn[None, :]) ** 2 if metric == "l2" else qn[:, None] * xn[None, :]
    size = terms.view(q.shape[0], -1, fs.GROUP).amax(dim=-1).clamp_min(1.0)
    err = (gmin.double() - want.double()).abs()
    assert bool((err[fin] <= GMIN_ATOL[storage] * size[fin]).all())


def test_gmin_scan_counts_its_operand_route(cuda):
    # f32 and bf16 blocks of d = 768 are read in place by TMA; f32 rows of
    # 127 values (508 bytes), bf16 rows of 100 (200 bytes) and an f32 view
    # 4 bytes off a 16-byte boundary are copied to a 16-byte stride first
    x, xsq, bias, q = _operands(1088, 768, 40, "f32", cuda)
    before = dict(fs.ROUTES["gmin_scan"])
    for xs in (x, x.to(torch.bfloat16)):
        fs.gmin_scan(xs, xsq, bias, q, metric="cosine")
    assert fs.ROUTES["gmin_scan"] == {"direct": before["direct"] + 2,
                                      "padded": before["padded"]}
    off = x.flatten()[1:1 + 1024 * 768].view(1024, 768)
    assert off.data_ptr() % 16
    cases = [(off, xsq[:1024].contiguous(), bias[:1024].contiguous(), q)]
    for d, storage in ((127, "f32"), (100, "bf16")):
        cases.append(_operands(1088, d, 5, storage, cuda, seed=d))
    for args in cases:
        gmin, _ = fs.gmin_scan(*args, metric="l2")
        _assert_close_with_inf(gmin, fs._gmin_scan_ref(*args, metric="l2"),
                               GMIN_ATOL["bf16" if args[0].dtype == torch.bfloat16 else "f32"])
    torch.cuda.synchronize()
    assert fs.ROUTES["gmin_scan"] == {"direct": before["direct"] + 2,
                                      "padded": before["padded"] + 3}


def test_gmin_scan_reads_a_transposed_query(cuda):
    # a query block that is the transpose of a [d, B] tensor: its rows are
    # not d elements apart, so the wrapper lays it out by rows before its
    # parts reach TMA, which then reads them in place
    x, xsq, bias, q = _operands(K1_ROWS, 768, 130, "f32", cuda, seed=21)
    qt = q.t().contiguous().t()
    assert not qt.is_contiguous() and torch.equal(qt, q)
    before = dict(fs.ROUTES["gmin_scan"])
    for xs in (x, x.to(torch.bfloat16)):
        xss = (xs.float() ** 2).sum(dim=1)
        storage = "bf16" if xs.dtype == torch.bfloat16 else "f32"
        for metric in ("cosine", "l2"):
            gmin, _ = fs.gmin_scan(xs, xss, bias, qt, metric=metric)
            _assert_close_with_inf(gmin, fs._gmin_scan_ref(xs, xss, bias, q, metric=metric),
                                   GMIN_ATOL[storage])
    assert fs.ROUTES["gmin_scan"] == {"direct": before["direct"] + 4,
                                      "padded": before["padded"]}


def _near_tie_corpus(n=64 * 48, d=768, b=4, ties=20, seed=15):
    """``(x, xsq, bias, lex_rank, q)`` numpy operands: unit rows and
    queries; one row in each of ``ties`` groups has a dot of 0.9 + i * 1e-6
    with query 0 (i = 0 .. ties - 1), every other row a dot of order 0.1:
    more than GROUP_SLACK groups whose minima differ by 1e-6, so only a
    scan as accurate as f32 selects the right ones. The CPU tests of K1's
    3xTF32 arithmetic (``tests/test_torch_tf32_split.py``) share it."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(b, d))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for i in range(ties):
        u = rng.normal(size=d)
        u -= (u @ q[0]) * q[0]
        u /= np.linalg.norm(u)
        a = 0.9 + i * 1e-6
        x[64 * (2 * i + 1) + i] = a * q[0] + np.sqrt(1.0 - a * a) * u
    x, q = x.astype(np.float32), q.astype(np.float32)
    xsq = np.sum(x * x, axis=1, dtype=np.float32)
    lex_rank = rng.permutation(n).astype(np.int32)
    return x, xsq, np.zeros(n, np.float32), lex_rank, q


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_fused_search_near_ties_on_card_match_cpu(cuda, metric):
    cpu = [torch.from_numpy(a) for a in _near_tie_corpus()]
    got = fs.fused_flat_search(*(t.to(cuda) for t in cpu), metric=metric, k=4)
    want = fs.fused_flat_search(*cpu, metric=metric, k=4)
    assert bool(got[3]) and bool(want[3])
    assert torch.equal(got[0].cpu(), want[0])
    assert want[0][0].tolist() == [64 * (2 * i + 1) + i for i in (19, 18, 17, 16)]


# ---------------------------------------------------------------------------
# HNSW (plain PyTorch on the card): the beam and the kNN build on cuda
# ---------------------------------------------------------------------------


def _hnsw_bulk(device, n=4096, d=64, metric="cosine", seed=0):
    """A kNN-built HNSW index over clustered unit rows (the build's
    buckets shrunk so a 4,096-row corpus runs k-means), and queries."""
    from vettore_tpu_torch.index import hnsw_knn_build as knn
    from vettore_tpu_torch.index.hnsw import HnswIndex

    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(64, d)).astype(np.float32)
    x = centres[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[rng.integers(0, n, 96)] + 0.1 * rng.normal(size=(96, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    saved = knn.MIN_NGB
    knn.MIN_NGB = 16
    try:
        index = HnswIndex(metric, {"m": 8, "m0": 16, "ef_construction": 64, "ef_search": 48,
                                   "build": "knn"}, device=device)
        index.BULK_THRESHOLD = 2
        index.put_many((f"g{i:05d}", v) for i, v in enumerate(x))
    finally:
        knn.MIN_NGB = saved
    return index, x, q


def _moved(graph, device):
    """The same bulk graph with its tensors on ``device``."""
    from vettore_tpu_torch.index.hnsw_build import BulkGraph

    return BulkGraph(ids=graph.ids, n=graph.n, m=graph.m, m0=graph.m0, lmax=graph.lmax,
                     metric=graph.metric, x=graph.x.to(device), a0=graph.a0.to(device),
                     up_index=graph.up_index.to(device), up_adj=graph.up_adj.to(device),
                     lex_rank=graph.lex_rank.to(device), entry_slot=graph.entry_slot,
                     entry_level=graph.entry_level, levels=graph.levels)


def _beam(graph, q, traversal, limit=10):
    from vettore_tpu_torch.index import hnsw_device as hd

    bf16 = traversal == "bf16"
    slots, block = graph.hubs(torch.bfloat16 if bf16 else torch.float32)
    return hd.search_impl(
        graph.x, graph.a0, graph.up_index, graph.up_adj, graph.lex_rank, graph.entry_slot,
        graph.entry_level, q.to(graph.x.device), metric=graph.metric, lmax=graph.lmax, ef=48,
        limit=limit, max_steps=hd.step_bound(48), xb=graph.xb if bf16 else None,
        hub_slots=slots, hub_x=block)


@pytest.mark.parametrize("traversal", ["bf16", "f32"])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_hnsw_beam_on_card_matches_cpu(cuda, metric, traversal):
    index, _x, q = _hnsw_bulk("cpu", metric=metric)
    cpu_graph = index._bulk
    q = torch.from_numpy(q)
    want, _wraw, _wrank = _beam(cpu_graph, q, traversal)
    got, raw, rank = _beam(_moved(cpu_graph, cuda), q, traversal)
    got, raw, rank = got.cpu(), raw.cpu(), rank.cpu()
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / 10 for a, b in zip(got, want)])
    assert overlap >= 0.99, overlap
    lex = cpu_graph.lex_rank.long()
    for row_ids, row_rank in zip(got.tolist(), rank.tolist()):
        keys = [(r, int(lex[s])) for s, r in zip(row_ids, row_rank) if s >= 0]
        assert keys == sorted(keys) and len(keys) == 10  # (rank, id) order
    assert torch.isfinite(raw).all()


def test_hnsw_knn_build_on_card(cuda):
    """The kNN build and the index's search on cuda: the graph's recall@10
    against exact, the same slots and levels as the CPU build, the results
    in (rank, id) order."""
    index, x, q = _hnsw_bulk(cuda)
    graph = index._bulk
    assert graph.x.is_cuda and graph.a0.is_cuda
    cpu_index, _x, _q = _hnsw_bulk("cpu")
    np.testing.assert_array_equal(graph.levels, cpu_index._bulk.levels)
    assert graph.ids == cpu_index._bulk.ids
    hits = index.search_batch(q.astype(np.float64), 10)
    exact = np.argsort(-(q.astype(np.float64) @ x.T.astype(np.float64)), axis=1)[:, :10]
    recall = np.mean([len({h[0] for h in row} & {f"g{j:05d}" for j in exact[i]}) / 10
                      for i, row in enumerate(hits)])
    assert recall >= 0.95, recall
    for row in hits:  # (rank, id) order; the raw scores are a second f32 sum
        assert all(ra >= rb - 1e-6 and (ra != rb or ia < ib)
                   for (ia, ra), (ib, rb) in zip(row, row[1:]))


def _fde_operands(n, b, device, width=2048, seed=21):
    """A bf16 FDE-like block (rows of unit scale over ``width`` columns, the
    last 37 rows dead) and f32 query FDEs."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, width)) / np.sqrt(width)).astype(np.float32)
    x[-37:] = 0.0
    bias = np.zeros(n, np.float32)
    bias[-37:] = np.inf
    q = rng.normal(size=(b, width)).astype(np.float32)
    xt = torch.from_numpy(x).to(device).to(torch.bfloat16)
    xsq = (xt.float() ** 2).sum(dim=1)
    return xt, xsq, torch.from_numpy(bias).to(device), torch.from_numpy(q).to(device)


@pytest.mark.parametrize("b", [64, 5])
def test_stage_gmin_scan_at_the_fde_shape(cuda, b):
    """K5 as MUVERA's candidate scan runs it: a bf16 block read over all of
    its 2,048 columns, inner product."""
    x, xsq, bias, q = _fde_operands(8192, b, cuda)
    before = fs.LAUNCHES["stage_gmin_scan"], dict(fs.ROUTES["stage_gmin_scan"])
    gmin, rank, bounded = fs.stage_gmin_scan(x, xsq, bias, q, metric="inner_product",
                                             dims=2048)
    torch.cuda.synchronize()
    assert fs.LAUNCHES["stage_gmin_scan"] == before[0] + 1
    assert fs.ROUTES["stage_gmin_scan"]["direct"] == before[1]["direct"] + 1
    assert bool(bounded)
    want_gmin, want_rank = fs._stage_gmin_scan_ref(x, xsq, bias, q, metric="inner_product",
                                                   dims=2048)
    _assert_close_with_inf(gmin, want_gmin, GMIN_ATOL["bf16"])
    _assert_close_with_inf(rank, want_rank, GMIN_ATOL["bf16"])


def test_fde_candidates_on_card_match_cpu(cuda):
    """``muvera_fde.fde_candidates`` at MUVERA's count of 512 takes K5 on the
    card and selects the CPU's slots (the plain versions' selection)."""
    from vettore_tpu_torch.ops import muvera_fde

    x, xsq, bias, q = _fde_operands(16384, 64, cuda)
    before = muvera_fde.ROUTES["fused"]
    got, ok = muvera_fde.fde_candidates(x, xsq, bias, q, count=512)
    want, want_ok = muvera_fde.fde_candidates(x.cpu(), xsq.cpu(), bias.cpu(), q.cpu(),
                                              count=512)
    assert muvera_fde.ROUTES["fused"] == before + 2
    assert bool(ok.all()) and bool(want_ok.all())
    # a candidate may trade places only with one whose FDE dot (float64)
    # lies within 1e-4 of the selection's boundary: K5 sums its bf16
    # products in another order than the plain version
    dots = q.double().cpu() @ x.double().cpu().T
    for row, g, w in zip(dots, got.cpu().tolist(), want.tolist()):
        edge = row[w[-1]].item()
        assert all(abs(row[s].item() - edge) < 1e-4 for s in set(g) ^ set(w))


def test_mmr_on_card_matches_the_host_loop(cuda):
    """The batched MMR on the card (pair similarities in full f32, the
    greedy loop on [B, k] tensors) against the float64 host loop, query
    scores spread wide enough that f32 pair noise cannot reorder them."""
    from vettore_tpu_torch.ops import mmr

    rng = np.random.default_rng(22)
    b, k, d = 16, 30, 128
    vecs = rng.normal(size=(b, k, d)).astype(np.float32)
    lists = [[(f"q{i}-{j}", float(10.0 * s)) for j, s in enumerate(rng.normal(size=k))]
             for i in range(b)]
    for metric in ("cosine", "l2", "inner_product"):
        got = mmr.mmr_rerank_batch(lists, torch.from_numpy(vecs).to(cuda), metric=metric,
                                   alpha=0.5, final_k=10, device=cuda)
        cpu = mmr.mmr_rerank_batch(lists, vecs, metric=metric, alpha=0.5, final_k=10,
                                   device="cpu")
        assert got == cpu
        for i in range(b):
            pool = [(lists[i][j][0], [float(v) for v in vecs[i, j]]) for j in range(k)]
            assert got[i] == mmr.mmr_rerank(lists[i], pool, metric, 0.5, 10)


# ---------------------------------------------------------------------------
# Several cards: every wrapper launches on its operands' card with that card
# made current (``_build.launch``), whatever card the caller has current,
# and leaves the caller's current; operands on two cards are refused; the
# mesh over every card returns one device's ids. Skipped with fewer than 2
# cards.
# ---------------------------------------------------------------------------

WRAPPERS = ("gmin_scan", "rescore", "int8_gmin_scan", "int8_rescore", "stage_gmin_scan",
            "fused_sign_scan", "extract_group_rows", "maxsim_rank_scan")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _wrapper_call(name, device):
    """``(fn, args, kwargs)`` of one call of wrapper ``name`` on operands
    made on ``device`` from a fixed seed."""
    from vettore_tpu_torch.ops import maxsim as ms

    n, d, b = 4096, 96, 70
    if name in ("gmin_scan", "rescore", "stage_gmin_scan"):
        x, xsq, bias, q = _operands(n, d, b, "f32", device)
        if name == "gmin_scan":
            return fs.gmin_scan, (x, xsq, bias, q), {"metric": "cosine"}
        if name == "stage_gmin_scan":
            return fs.stage_gmin_scan, (x, xsq, bias, q), {"metric": "cosine", "dims": 33}
        gidx = _rescore_selection("topk", fs._gmin_scan_ref(x, xsq, bias, q, metric="l2"), 12)
        return fs.rescore, (x, xsq, bias, q, gidx), {"metric": "l2"}
    if name in ("int8_gmin_scan", "int8_rescore"):
        x8, scale, xsq, bias, q, q8, qscale, qsq = _int8_operands(n, d, b, device)
        if name == "int8_gmin_scan":
            return fs.int8_gmin_scan, (x8, scale, xsq, bias, q8, qscale, qsq), {"metric": "l2"}
        gidx = _rescore_selection("overlap", torch.zeros((b, n // 64), device=device), 12)
        return fs.int8_rescore, (x8, scale, xsq, bias, q, gidx), {"metric": "cosine"}
    if name == "fused_sign_scan":
        return fs.fused_sign_scan, _signs(n, 128, b, device), {"d": 128}
    if name == "extract_group_rows":
        rng = np.random.default_rng(4)
        mat = torch.from_numpy(rng.standard_normal((b, 300, 64)).astype(np.float32)).to(device)
        gidx = torch.from_numpy(rng.integers(0, 300, (b, 65)).astype(np.int32)).to(device)
        return fs.extract_group_rows, (mat, gidx), {}
    tokens, counts, dbias, qt, qinv = _mv_operands(256, 32, 128, 8, 4, "bf16", device)
    return ms.maxsim_rank_scan, (tokens, counts, dbias, qt, qinv), {"b": 8, "metric": "cosine"}


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,)) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_launches_on_its_operands_card(two_cards, name):
    """Each wrapper on cuda:1 while cuda:0 is current gives what the same
    call gives on cuda:0, counts its launch on cuda:1, and leaves cuda:0
    current."""
    from vettore_tpu_torch import _build

    card0, card1 = two_cards
    torch.cuda.set_device(card0)
    fn, args0, kwargs = _wrapper_call(name, card0)
    want = [t.cpu() for t in _flat(fn(*args0, **kwargs))]
    _fn, args1, _kwargs = _wrapper_call(name, card1)
    before = sum(n for (_k, index), n in _build.CARD_LAUNCHES.items() if index == 1)
    got = _flat(fn(*args1, **kwargs))
    torch.cuda.synchronize(card1)
    assert torch.cuda.current_device() == 0
    assert all(t.device == card1 for t in got)
    assert sum(n for (_k, index), n in _build.CARD_LAUNCHES.items() if index == 1) > before
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_operands_on_two_cards(two_cards, name):
    """A block on one card with its query (or indices) on another raises
    ``ValueError``: no peer pointer reaches a kernel."""
    card0, card1 = two_cards
    fn, args, kwargs = _wrapper_call(name, card0)
    moved = list(args)
    moved[-1] = moved[-1].to(card1)  # the last operand: queries, indices or qinv
    with pytest.raises(ValueError, match="operands on"):
        fn(*moved, **kwargs)


@pytest.mark.parametrize("storage", STORAGES)
def test_sharded_flat_over_every_card_equals_one_device(two_cards, storage):
    """``ShardedFlat`` over every card (shards of 4,096 rows: the fused
    K1 + K2 search on each card) returns the one-device ``FlatIndex``'s
    ids, and ``sharded_search`` over its blocks the same hits."""
    from vettore_tpu_torch.index.flat import FlatIndex
    from vettore_tpu_torch.parallel import ShardedFlat, make_mesh, sharded_search

    cards = torch.cuda.device_count()
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "shard": cards}
    assert mesh.distinct() == [torch.device("cuda", i) for i in range(cards)]
    rng = np.random.default_rng(9)
    n, d = 4096 * cards, 64
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    ids = [f"doc-{i:06d}" for i in range(n)]
    queries = rng.normal(size=(33, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    sharded = ShardedFlat("cosine", mesh, ids, vectors, storage=storage)
    one = FlatIndex("cosine", storage=storage, device="cuda")
    one.put_many(zip(ids, vectors))
    got = sharded.search_batch(queries, 10)
    want = one.search_batch(queries, 10)
    assert sharded.reruns == 0
    assert [[h[0] for h in row] for row in got] == [[h[0] for h in row] for row in want]
    q = torch.from_numpy(queries).to(mesh.first)
    slots, _raws = sharded_search(mesh, sharded._x, sharded._valid, sharded._lex, q,
                                  metric="cosine", k=10)
    rows = sharded._x.rows
    assert torch.equal(slots // rows * sharded.per + slots % rows, sharded.search_device(q, 10)[0])
    assert torch.cuda.current_device() == 0
