"""The MaxSim scan's tiling on the CPU: what the card kernel is given and
how its epilogue reduces, held against the JAX package and the plain
version.

* The wrapper's operand padding (tokens per doc grown to
  ``kernel_tokens``, query sets to a power of two, rows to a stride TMA can
  address), run through the plain version, gives the ranks of the JAX
  package's Pallas kernels K8 and K9 (interpret mode, as
  ``tests/test_torch_maxsim.py`` runs them) on the unpadded operands:
  rtol = atol = 1e-5 for f32 blocks, 1e-4 for bf16 blocks.
* A numpy model of ``csrc/maxsim.cu``'s epilogue: the accumulator layout of
  the tensor-core skeleton (``csrc/wgmma_scan.cuh``: register ``4j + 2h +
  c`` of thread ``t`` holds row ``16w + l/4 + 8h`` and column ``8j + 2(l%4)
  + c``), its shuffles as exchanges between threads ``t`` and ``t ^ m``,
  its per-warp maxima, running maxima over the chunks of a doc, and the
  per-part totals of sets wider than a query tile, with the same index
  arithmetic. From the plain version's f32 dots it must give the plain
  version's ranks to rtol 1e-6 and atol 1e-6 * Q (the maxima are exact;
  only the order of the set sums of Q terms differs), over doc and set
  bounds for T = 1 .. 384 and Q = 1 .. 512.
* The scan cache's token norms and the K5 wrapper's query prefix split.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import maxsim as jms
from vettore_tpu_torch.ops import flat_scan as tfs
from vettore_tpu_torch.ops import maxsim as tms

torch.set_num_threads(2)

DOT_METRICS = ("cosine", "inner_product", "negative_inner_product")


def _operands(n, t, d, b, nq, seed=0, counts=None):
    """Numpy ``(tokens, counts, dbias, qt, qinv)``: unit-scale token rows,
    random counts 0..t with pad rows zero, dead docs, one zero query
    token."""
    rng = np.random.default_rng(seed)
    tokens = rng.standard_normal((n, t, d)).astype(np.float32)
    tokens /= np.linalg.norm(tokens, axis=2, keepdims=True)
    tokens *= rng.uniform(0.5, 2.0, (n, t, 1)).astype(np.float32)
    if counts is None:
        counts = rng.integers(0, t + 1, n).astype(np.int32)
    tokens[np.arange(t)[None, :] >= counts[:, None]] = 0.0
    dbias = np.where(rng.random(n) < 0.05, np.inf, 0.0).astype(np.float32)
    qt = rng.standard_normal((b * nq, d)).astype(np.float32)
    qt /= np.linalg.norm(qt, axis=1, keepdims=True)
    qt[-1] = 0.0
    qn = np.linalg.norm(qt, axis=1)
    qinv = np.where(qn > 0, 1.0 / np.maximum(qn, 1e-38), 0.0).astype(np.float32)
    return tokens, counts, dbias, qt, qinv


# ---------------------------------------------------------------------------
# the wrapper's padding against K8 / K9
# ---------------------------------------------------------------------------


def _jax_ranks(tokens, counts, dbias, qt, qinv, b, metric, storage):
    n, t, d = tokens.shape
    jt = jnp.asarray(tokens)
    if storage == "bf16":
        jt = jt.astype(jnp.bfloat16)
    x2 = jt.reshape(n * t, d)
    qi = qinv if metric == "cosine" else np.ones_like(qinv)
    dzero = (counts <= 0).astype(np.float32)
    q2 = jnp.asarray(qt).T.astype(x2.dtype)
    row_tile = jms._mv_row_tile(t, d, qt.shape[0], x2.dtype.itemsize, n * t)
    if (counts == t).all():
        return np.asarray(jms.fused_maxsim_rank_scan_uniform(
            x2, jnp.asarray(dzero), jnp.asarray(dbias), q2, jnp.asarray(qi)[None, :],
            t=t, b=b, metric=metric, row_tile=row_tile))
    tn = np.sqrt(np.asarray(jms._row_sq_sums(x2)))
    tinv = (np.where(tn > 0, 1.0 / np.maximum(tn, 1e-38), 0.0) if metric == "cosine"
            else np.ones_like(tn)).astype(np.float32)
    live = (np.arange(t)[None, :] < counts[:, None]).reshape(-1)
    tbias = np.where(live, 0.0, jms._PAD_SIM).astype(np.float32)
    return np.asarray(jms.fused_maxsim_rank_scan(
        x2, jnp.asarray(tinv)[:, None], jnp.asarray(tbias)[:, None],
        jnp.asarray(dzero)[:, None], jnp.asarray(dbias)[:, None], q2,
        jnp.asarray(qi)[None, :], t=t, b=b, metric=metric, row_tile=row_tile))


def _padded_ref(tokens, counts, dbias, qt, qinv, b, metric, storage):
    """The plain version on the operands as the card wrapper lays them out
    for its kernel: ``_kernel_operands`` and ``_tma_rows``."""
    tt = torch.from_numpy(tokens)
    if storage == "bf16":
        tt = tt.to(torch.bfloat16)
    tinv = tms.token_norms(tt)[1]
    tt, tinv, q, qi, copied = tms._kernel_operands(tt, tinv, torch.from_numpy(qt),
                                                  torch.from_numpy(qinv), b=b)
    n, tk, d = tt.shape
    xr, ldx, x_copied = tfs._tma_rows(tt.reshape(n * tk, d))
    qr, ldq, _ = tfs._tma_rows(q)
    ld = ldx // xr.element_size()
    assert qr.shape[1] == ld == xr.shape[1]
    assert copied == (tk != tokens.shape[1])
    assert x_copied == ((d * tt.element_size()) % 16 != 0)
    qs = qr.to(torch.bfloat16).float() if storage == "bf16" else qr
    return tms._maxsim_rank_scan_ref(xr.reshape(n, tk, ld), torch.from_numpy(counts),
                                     torch.from_numpy(dbias), qs, qi, b=b, metric=metric,
                                     tinv=tinv).numpy()


@pytest.mark.parametrize("storage", ("f32", "bf16"))
@pytest.mark.parametrize("metric", DOT_METRICS)
@pytest.mark.parametrize("shape", [(128, 3, 77, 3, 3), (128, 5, 128, 2, 5), (128, 4, 96, 3, 4)])
def test_padded_operands_give_the_jax_ranks(shape, metric, storage):
    n, t, d, b, nq = shape
    data = _operands(n, t, d, b, nq, seed=t * d)
    got = _padded_ref(*data, b, metric, storage)
    want = _jax_ranks(*data, b, metric, storage)
    fin = np.isfinite(want)
    assert got.shape == (b, n) and (np.isfinite(got) == fin).all()
    tol = 1e-5 if storage == "f32" else 1e-4
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


def test_uniform_padded_operands_give_the_k9_ranks():
    n, t, d, b, nq = 128, 3, 128, 2, 3
    data = _operands(n, t, d, b, nq, seed=5, counts=np.full(128, 3, np.int32))
    got = _padded_ref(*data, b, "cosine", "f32")
    want = _jax_ranks(*data, b, "cosine", "f32")
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_kernel_tokens_and_query_tile():
    assert [tms.kernel_tokens(t) for t in (1, 2, 3, 5, 16, 17, 100, 128, 129, 256, 300)] == [
        1, 2, 4, 8, 16, 32, 128, 128, 256, 256, 384]
    assert tms.query_tile(64, True) == 64 and tms.query_tile(65, True) == 128
    assert tms.query_tile(129, True) == 256 and tms.query_tile(129, False) == 128
    assert tms.query_tile(4096, False) == 128


# ---------------------------------------------------------------------------
# a numpy model of the kernel's epilogue
# ---------------------------------------------------------------------------

GROUP, ROWS = 64, 128
_T = np.arange(128)[:, None]  # thread of a consumer warpgroup


def _layout(qn):
    """Row and column of every accumulator register of every thread."""
    i = np.arange(qn // 2)[None, :]
    j, h, c = i // 4, (i // 2) % 2, i % 2
    return 16 * (_T // 32) + (_T % 32) // 4 + 8 * h, 8 * j + 2 * (_T % 4) + c


def _shfl(v, m):
    """__shfl_xor_sync(v, m) of every thread (the lanes of a warp)."""
    return v[np.arange(128) ^ m]


class _Kernel:
    """The epilogue of ``csrc/maxsim.cu`` over one launch, in numpy f32, on
    the dots of the tensor cores given as a matrix."""

    def __init__(self, dots, tinv, qinv, counts, dbias, *, n, tk, nq, b, cosine, qn):
        self.n, self.tk, self.nq, self.b, self.cosine, self.qn = n, tk, nq, b, cosine, qn
        self.rows, self.cols = n * tk, b * nq
        rows_p = -(-self.rows // ROWS) * ROWS
        cols_p = -(-self.cols // qn) * qn
        # TMA fills past the operands with zeros
        self.dots = np.zeros((rows_p, cols_p), np.float32)
        self.dots[:self.rows, :self.cols] = dots
        self.tinv, self.qinv, self.counts, self.dbias = tinv, qinv, counts, dbias
        self.out = np.full((max(1, nq // qn), b, n), np.nan, np.float32)
        self.row, self.col = _layout(qn)
        self.run, self.sides = {}, {}

    def launch(self):
        chunks = self.tk // ROWS if self.tk > ROWS else 1
        row_tiles = -(-self.rows // ROWS)
        nqt = -(-self.cols // self.qn)
        ng = -(-self.rows // GROUP)
        for item in range((row_tiles // chunks) * nqt):
            for c in range(chunks):
                for wgc in (0, 1):
                    g = ((item // nqt) * chunks + c) * 2 + wgc
                    if g < ng:
                        self.finish(g, (item % nqt) * self.qn, c, c + 1 == chunks)
        return self.out

    def prefetch(self, g):
        r = g * GROUP + self.row[:, 0:3:2]  # rows of h = 0, 1: [128, 2]
        doc = r // self.tk
        inside = r < self.rows
        cnt = np.where(inside, self.counts[np.minimum(doc, self.n - 1)], 0).clip(0, self.tk)
        ti = np.where(inside & self.cosine, self.tinv[np.minimum(r, self.rows - 1)], 1.0)
        db = np.where(inside, self.dbias[np.minimum(doc, self.n - 1)], 0.0)
        return ti.astype(np.float32), db.astype(np.float32), r - doc * self.tk < cnt, cnt == 0

    def scaled(self, m, side, col):
        if not self.cosine:
            return m
        with np.errstate(invalid="ignore"):  # -inf * 0 on a doc with no token, as on the card
            return np.fmin(np.fmax(np.float32(m) * side[col], np.float32(-1)), np.float32(1))

    def put(self, doc, s, part, total, zero, db):
        if doc < self.n and s < self.b:
            self.out[part, s, doc] = np.float32(0.0 if zero else -total) + np.float32(
                db if part == 0 else 0.0)

    def finish(self, g, q0, c, last):
        qn, tk = self.qn, self.tk
        qs = min(self.nq, qn)
        set0, part = q0 // self.nq, (q0 % self.nq) // qn
        tinv, dbias, live, zero = self.prefetch(g)
        h_of = (np.arange(qn // 2) // 2) % 2
        side = np.zeros(2 * qn, np.float32)
        cols = q0 + np.arange(qn)
        side[:qn] = np.where(self.cosine & (cols < self.cols),
                             self.qinv[np.minimum(cols, self.cols - 1)], 0.0)
        acc = self.dots[g * GROUP + self.row, q0 + self.col]  # [128, qn/2]
        if self.cosine:
            acc = acc * tinv[:, h_of]
        acc = np.where(live[:, h_of], acc, np.float32(-np.inf)).astype(np.float32)
        if tk <= 8:
            for e in range(3):
                if (4 << e) < 4 * tk:
                    acc = np.fmax(acc, _shfl(acc, 4 << e))
            v = self.scaled(acc, side, self.col).reshape(128, qn // 8, 2, 2)  # [t, j, h, c]
            lane = _T[:, 0] % 32
            row_writer = (lane // 4) % tk == 0
            doc = (g * GROUP + self.row[:, 0:3:2]) // tk  # [128, 2]
            col = self.col.reshape(128, qn // 8, 2, 2)
            per = qs // 8
            run = np.zeros((128, 2), np.float32)
            for j in range(qn // 8):
                for h in (0, 1):
                    if qs == 1:
                        for t in np.flatnonzero(row_writer):
                            for c in (0, 1):
                                self.put(doc[t, h], set0 + col[t, j, h, c], part, v[t, j, h, c],
                                         zero[t, h], dbias[t, h])
                        continue
                    total = v[:, j, h, 0] + v[:, j, h, 1]
                    if qs >= 4:
                        total = total + _shfl(total, 1)
                    if qs >= 8:
                        total = total + _shfl(total, 2)
                    if qs <= 8:
                        for t in np.flatnonzero(row_writer & ((lane % 4) % (qs // 2) == 0)):
                            self.put(doc[t, h], set0 + (8 * j + 2 * (lane[t] % 4)) // qs, part,
                                     total[t], zero[t, h], dbias[t, h])
                        continue
                    run[:, h] = total if j % per == 0 else run[:, h] + total
                    if j % per == per - 1:
                        for t in np.flatnonzero(row_writer & (lane % 4 == 0)):
                            self.put(doc[t, h], set0 + j // per, part, run[t, h], zero[t, h],
                                     dbias[t, h])
            return
        # T >= 16: the max over each warp's 16 rows (wg::warp_columns)
        red = np.full((4, qn), np.float32(-np.inf))
        for w in range(4):
            np.maximum.at(red[w], self.col[32 * w:32 * w + 32].ravel(),
                          acc[32 * w:32 * w + 32].ravel())
        span = min(tk, GROUP)
        for t in range(128):
            for h in (0, 1):
                r = self.row[t, 2 * h]
                if r % span == 0:
                    side[qn + 2 * (r // span)] = 1.0 if zero[t, h] else 0.0
                    side[qn + 2 * (r // span) + 1] = dbias[t, h]
        sets = qn // qs
        if tk < 2 * GROUP:
            docs, wpd = GROUP // span, span // 16
            for o in range(docs * sets):
                dl, s = o % docs, o // docs
                total = np.float32(0)
                for k in range(qs):
                    col = s * qs + k
                    m = red[dl * wpd:(dl + 1) * wpd, col].max()
                    total = np.float32(total + self.scaled(m, side, col))
                self.put((g * GROUP + dl * span) // tk, set0 + s, part, total,
                         side[qn + 2 * dl] != 0, side[qn + 2 * dl + 1])
            return
        # T >= 128: running maxima over the item's chunks; after the last,
        # the two warpgroups meet (the model runs the first, then the second,
        # so the second's turn stands for both) and split the sets
        wgc = g % 2
        m = red.max(axis=0)
        self.run[wgc] = m if c == 0 else np.fmax(self.run[wgc], m)
        self.sides[wgc] = side
        if not last or wgc == 0:
            return
        for s in range(sets):
            mine = self.sides[s // 128 % 2]
            total = np.float32(0)
            for k in range(qs):
                col = s * qs + k
                total = np.float32(total + self.scaled(
                    np.fmax(self.run[0][col], self.run[1][col]), mine, col))
            self.put(g * GROUP // tk, set0 + s, part, total, mine[qn] != 0, mine[qn + 1])


def _model_and_ref(n, t, d, b, nq, metric, bf16, seed, kernel_cls=_Kernel, counts=None):
    tokens, counts, dbias, qt, qinv = (torch.from_numpy(a) for a in _operands(
        n, t, d, b, nq, seed=seed, counts=counts))
    tinv = tms.token_norms(tokens)[1]
    tk_tokens, tinv_k, qt_k, qinv_k, _ = tms._kernel_operands(tokens, tinv, qt, qinv, b=b)
    tk, nq_k = tk_tokens.shape[1], qt_k.shape[0] // b
    dots = (tk_tokens.reshape(n * tk, d) @ qt_k.T).numpy()
    kernel = kernel_cls(dots, tinv_k.numpy(), qinv_k.numpy(), counts.numpy(), dbias.numpy(), n=n,
                     tk=tk, nq=nq_k, b=b, cosine=metric == "cosine",
                     qn=tms.query_tile(b * nq_k, bf16))
    parts = kernel.launch()
    assert not np.isnan(parts).any(), "an output the kernel never writes"
    got = parts[0] if parts.shape[0] == 1 else parts.sum(axis=0, dtype=np.float32)
    want = tms._maxsim_rank_scan_ref(tokens, counts, dbias, qt, qinv, b=b, metric=metric,
                                     tinv=tinv).numpy()
    return got, want, kernel


def _assert_model(got, want, kernel):
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all() and (got[~fin] == want[~fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6 * kernel.nq)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 300])
@pytest.mark.parametrize("metric", ["cosine", "inner_product"])
def test_epilogue_model_doc_bounds(t, metric):
    # docs of every kernel T (3 grows to 4, 300 to 384: three chunks), a
    # doc count that leaves the last tile part empty, sets of 3 tokens
    n = max(3, 520 // t) | 1
    got, want, kernel = _model_and_ref(n, t, 16, 5, 3, metric, True, seed=t)
    _assert_model(got, want, kernel)


@pytest.mark.parametrize("nq", [1, 2, 3, 4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("t", [2, 32])
def test_epilogue_model_set_bounds(nq, t):
    # sets of every width up to the widest tile, with the query tiles the
    # wrapper picks for bf16 and f32 blocks; b sets spill over a tile
    for bf16 in (True, False):
        b = max(2, 300 // nq)
        got, want, kernel = _model_and_ref(70, t, 8, b, nq, "cosine", bf16, seed=nq + t)
        assert kernel.qn >= min(kernel.nq, 128)
        _assert_model(got, want, kernel)


@pytest.mark.parametrize("nq,bf16", [(512, True), (256, False), (300, True), (130, False)])
@pytest.mark.parametrize("t", [4, 32, 256])
def test_epilogue_model_wide_sets_in_parts(nq, bf16, t):
    # a set wider than the query tile writes one part per tile, dbias in
    # part 0; the wrapper's sum of the parts is the set's rank
    got, want, kernel = _model_and_ref(max(3, 260 // t), t, 8, 2, nq, "inner_product", bf16,
                                       seed=nq + t)
    assert kernel.out.shape[0] == kernel.nq // kernel.qn > 1
    _assert_model(got, want, kernel)


class _OneRowTooMany(_Kernel):
    """The model with a fault: each doc's first pad token counted live."""

    def prefetch(self, g):
        tinv, dbias, live, zero = super().prefetch(g)
        r = g * GROUP + self.row[:, 0:3:2]
        doc = np.minimum(r // self.tk, self.n - 1)
        return tinv, dbias, live | (r - doc * self.tk == self.counts[doc]), zero


@pytest.mark.parametrize("t", [4, 32, 256])
def test_epilogue_model_catches_a_doc_bound_off_by_one(t):
    # the comparison is sharp: one row too many in a doc's span fails it
    # (docs of 1-3 live tokens, so that a zero pad row often beats them)
    n = max(9, 1056 // t) | 1
    counts = np.random.default_rng(t).integers(1, 4, n).astype(np.int32)
    args = (n, t, 8, 3, 4, "cosine", True, 1)
    _assert_model(*_model_and_ref(*args, counts=counts))
    with pytest.raises(AssertionError):
        _assert_model(*_model_and_ref(*args, kernel_cls=_OneRowTooMany, counts=counts))


# ---------------------------------------------------------------------------
# the scan cache's token norms, K5's query prefix
# ---------------------------------------------------------------------------


def test_cache_token_norms_equal_per_call_and_drop_on_mutation(monkeypatch):
    import vettore_tpu_torch as vt

    rng = np.random.default_rng(9)

    def records(lo, hi):
        return [{"id": f"m{i:04d}", "vectors": rng.standard_normal((int(rng.integers(1, 6)), 24))
                 .astype(np.float32).tolist()} for i in range(lo, hi)]

    col = vt.Collection(name="mv", dimensions=24, metric="cosine", device="cpu")
    col.put_many(records(0, 100))
    calls = []
    real = tms.token_norms
    monkeypatch.setattr(tms, "token_norms", lambda tokens: calls.append(1) or real(tokens))
    query = rng.standard_normal((3, 24)).astype(np.float32).tolist()
    col.multi_vector_search(query, limit=5)
    col.multi_vector_search_batch([query, query[:2]], limit=5)
    assert len(calls) == 1  # computed once for the block, then cached
    cache = col._scan_cache()
    tsq, tinv = cache.token_norms()
    want_tsq, want_tinv = real(cache.multi_vectors()[0])
    assert torch.equal(tsq, want_tsq) and torch.equal(tinv, want_tinv)
    col.put_many(records(100, 140))
    fresh = col._scan_cache()
    assert fresh is not cache and fresh._mv_norms is None  # dropped with the block
    col.multi_vector_search(query, limit=5)
    assert len(calls) == 2
    want_tsq, want_tinv = real(fresh.multi_vectors()[0])
    assert torch.equal(fresh.token_norms()[0], want_tsq)
    assert torch.equal(fresh.token_norms()[1], want_tinv)


@pytest.mark.parametrize("dims", [33, 64, 128])
def test_stage_query_prefix_split_is_exact(dims):
    rng = np.random.default_rng(dims)
    q = torch.from_numpy((rng.standard_normal((7, 160)) * 10.0 ** rng.integers(
        -20, 20, (7, 160))).astype(np.float32))
    hi, lo = tfs.tf32_split(q[:, :dims])
    assert hi.shape == lo.shape == (7, dims) and hi.is_contiguous()
    assert torch.equal(hi + lo, q[:, :dims])
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # TF32: 13 low mantissa bits zero


def test_stage_prefix_copy_keeps_only_the_prefix():
    x = torch.arange(64 * 99, dtype=torch.float32).reshape(64, 99)
    xt, ld, copied = tfs._tma_rows(x, 33)
    assert copied and ld == 36 * 4 and torch.equal(xt[:, :33], x[:, :33])
    assert not xt[:, 33:].any()
    xt, ld, copied = tfs._tma_rows(torch.zeros(64, 100), 33)
    assert not copied and ld == 400
