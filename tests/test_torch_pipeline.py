"""The port's funnel and quantized pipelines against the JAX package's, on
the CPU.

Both packages get the same scan cache: a JAX ``_VectorCache``'s device
arrays carried across by ``vettore_tpu_torch.convert.scan_cache_state``.
Each pipeline runs on its default route and on its kernel route (the
thresholds ``_FUSED_STAGE_MIN`` and ``_GROUP_COVER_MIN`` lowered to 2048 in
both packages, so the JAX package runs its Pallas kernels in interpret mode
and the port its kernels' plain versions). Tolerances: the same slots in the
same order, the same ``ok``, and raws within 1e-5 * max(1, |raw|)
(summation order of f32 dot products).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vettore_tpu as jvt
from vettore_tpu import collection as jcoll
from vettore_tpu.ops import pipeline as jpipe
from vettore_tpu_torch import collection as tcoll
from vettore_tpu_torch import convert
from vettore_tpu_torch import errors as terrors
from vettore_tpu_torch.embedding import Embedding as TEmbedding
from vettore_tpu_torch.ops import flat_scan as tfs
from vettore_tpu_torch.ops import pipeline as tpipe

torch.set_num_threads(2)

N, D, B = 8192, 256, 4
FUNNEL_COUNT, QUANT_COUNT, LIMIT = 60, 100, 10


@functools.lru_cache(maxsize=None)
def _state(metric):
    """``(jax operands, torch operands, queries, prefix norms)`` of one
    cache: a clustered corpus (heavy ties in the sign bits) with 7 ids
    deleted, so the block has dead slots inside it and pad slots at its end.
    The prefix norms map a stage width to its (JAX, port) pair."""
    rng = np.random.default_rng(3)
    centres = rng.normal(size=(12, D)).astype(np.float32)
    data = centres[rng.integers(0, 12, N)] + 0.3 * rng.normal(size=(N, D)).astype(np.float32)
    ids = [f"r-{i:05d}" for i in rng.permutation(N)]
    col = jvt.Collection(name="p", dimensions=D, metric=metric)
    col.put_matrix(ids, data)
    for i in ids[:7]:
        col.delete(i)
    cache = col._scan_cache()
    x, valid = cache.vectors()
    jax_ops = (x, valid, cache.bits(), cache.signs(), cache.stage_xsq(128))
    torch_ops = convert.scan_cache_state(*(np.asarray(a) for a in jax_ops), device="cpu")
    queries = np.stack([col.prepare_query(v) for v in
                        data[rng.integers(0, N, B)] + 0.2 * rng.normal(size=(B, D))])
    xsqs = {dims: (cache.stage_xsq(dims), torch.from_numpy(np.array(cache.stage_xsq(dims))))
            for dims in (64, 128)}
    return jax_ops, torch_ops, queries.astype(np.float32), xsqs


@pytest.fixture(params=["default", "kernel"])
def route(request, monkeypatch):
    if request.param == "kernel":
        for mod in (jpipe, tpipe):
            monkeypatch.setattr(mod, "_FUSED_STAGE_MIN", 2048)
            monkeypatch.setattr(mod, "_GROUP_COVER_MIN", 2048)
    return request.param


def _assert_same(got, want):
    g_slots, g_raws, g_ranks, g_ok = (t.numpy() for t in got)
    w_slots, w_raws, w_ranks, w_ok = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(g_ok, w_ok)
    assert g_ok.all()
    np.testing.assert_array_equal(g_slots, w_slots)
    np.testing.assert_array_equal(np.isfinite(g_ranks), np.isfinite(w_ranks))
    assert (np.abs(g_raws - w_raws) <= 1e-5 * np.maximum(1.0, np.abs(w_raws))).all()


def _launches_during(fn):
    before = dict(tfs.LAUNCHES)
    out = fn()
    assert tfs.LAUNCHES == before  # CPU tensors: plain versions, no launches
    return out


@pytest.mark.parametrize("stages", [(64, 128), (128, 256)])
@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_funnel_pipeline_matches_jax(route, metric, stages):
    # at 64 columns the JAX package keeps its plain route (its lane-tile
    # gate) while the port runs K5: the routes differ, the results may not
    (jx, jvalid, *_), (x, valid, *_), q, xsqs = _state(metric)
    jxsq, xsq = xsqs[stages[0]]
    fused = N >= tpipe._FUSED_STAGE_MIN
    want = jpipe.funnel_pipeline_batch(jx, jvalid, jnp.asarray(q), jxsq, metric=metric,
                                       stages=stages, count=FUNNEL_COUNT, limit=LIMIT)
    calls = []
    real = tfs.fused_stage_candidates
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfs, "fused_stage_candidates",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        got = _launches_during(lambda: tpipe.funnel_pipeline_batch(
            x, valid, torch.from_numpy(q), xsq, metric=metric, stages=stages,
            count=FUNNEL_COUNT, limit=LIMIT))
    assert bool(calls) == fused
    _assert_same(got, want)


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product"])
def test_quantized_pipeline_matches_jax(route, metric):
    (jx, jvalid, _jb, jsigns, _jxsq), (x, valid, _b, signs, _xsq), q, _xsqs = _state(metric)
    want = jpipe.quantized_pipeline_batch(jx, jsigns, jvalid, jnp.asarray(q), metric=metric,
                                          count=QUANT_COUNT, limit=LIMIT, d=D)
    calls = []
    real = tfs.fused_sign_scan
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfs, "fused_sign_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
        got = _launches_during(lambda: tpipe.quantized_pipeline_batch(
            x, signs, valid, torch.from_numpy(q), metric=metric, count=QUANT_COUNT,
            limit=LIMIT, d=D))
    assert bool(calls) == (N >= tpipe._GROUP_COVER_MIN)
    _assert_same(got, want)


def test_hamming_slots_without_the_kernel_gate_matches_jax(monkeypatch):
    # d % 128 != 0: the JAX package's group cover builds its int16 Hamming
    # matrix in XLA (its lane-tile gate), the port's runs K6; then K7
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "_GROUP_COVER_MIN", 2048)
    calls = []
    real = tfs.fused_sign_scan
    monkeypatch.setattr(tfs, "fused_sign_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    n, d, b = 8192, 96, 3
    base = rng.integers(0, 2, (9, d)) * 2 - 1
    signs = base[rng.integers(0, 9, n)].astype(np.int8)
    valid = np.arange(n) < n - 5
    qs = np.where(rng.normal(size=(b, d)) >= 0, 1, -1).astype(np.int8)
    want = [np.asarray(a) for a in jpipe._hamming_slots(
        jnp.asarray(signs), jnp.asarray(valid), jnp.asarray(qs), count=64, d=d)]
    got = [t.numpy() for t in tpipe._hamming_slots(
        torch.from_numpy(signs), torch.from_numpy(valid), torch.from_numpy(qs), count=64, d=d)]
    assert calls
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _tied_signs(n, d, b, seed, *, dead=()):
    """``(signs [n, d], valid [n], qsigns [b, d])``: rows drawn from 9 sign
    patterns (hundreds of rows tie at every Hamming value), the last 5 slots
    and the slots ``dead`` invalid."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, (9, d)) * 2 - 1
    signs = base[rng.integers(0, 9, n)].astype(np.int8)
    valid = np.arange(n) < n - 5
    valid[list(dead)] = False
    qs = np.where(rng.normal(size=(b, d)) >= 0, 1, -1).astype(np.int8)
    return signs, valid, qs


def _hamming_oracle(signs, valid, qs, count, d):
    """The first ``count`` valid rows of each query by (hamming, slot), by
    NumPy's lexsort: ``(slots [b, count] int64, hams [b, count])``."""
    ham = (d - qs.astype(np.int64) @ signs.astype(np.int64).T) // 2
    slots = np.arange(signs.shape[0])
    out_s, out_h = [], []
    for h in ham:
        order = np.lexsort((slots[valid], h[valid]))[:count]
        out_s.append(slots[valid][order])
        out_h.append(h[valid][order])
    return np.stack(out_s), np.stack(out_h)


@pytest.mark.parametrize("n,d,count", [(8192, 96, 64), (8192, 256, 100), (4096, 33, 7),
                                       (16384, 300, 200)])
def test_hamming_slots_need_no_global_composite(monkeypatch, n, d, count):
    """With the global (hamming, slot) composite unavailable (as at 1M rows
    and d >= 2048, where it needs 32 bits), the group cover still selects
    exactly: every query ``ok``, the slots and Hamming values those of a
    lexsort over every valid row, on heavy ties."""
    monkeypatch.setattr(tpipe, "_GROUP_COVER_MIN", 2048)
    monkeypatch.setattr(tpipe, "_composite_bits", lambda n, d: None)
    calls = []
    real = tfs.fused_sign_scan
    monkeypatch.setattr(tfs, "fused_sign_scan", lambda *a, **k: calls.append(1) or real(*a, **k))
    signs, valid, qs = _tied_signs(n, d, 3, seed=n + d, dead=(0, 64, 65, 700))
    slots, ranks, ok = tpipe._hamming_slots(
        torch.from_numpy(signs), torch.from_numpy(valid), torch.from_numpy(qs), count=count, d=d)
    want_s, want_h = _hamming_oracle(signs, valid, qs, count, d)
    assert calls and ok.all()
    assert slots.dtype == torch.int64
    np.testing.assert_array_equal(slots.numpy(), want_s)
    np.testing.assert_array_equal(ranks.numpy(), want_h.astype(np.float32))


@pytest.mark.parametrize("n,d,count", [(8192, 96, 100), (8192, 256, 7), (4096, 512, 60)])
def test_hamming_slots_where_the_composite_fits_match_jax(monkeypatch, n, d, count):
    """Where the JAX package's global composite fits, the cover's position
    keys give its output bit for bit."""
    for mod in (jpipe, tpipe):
        monkeypatch.setattr(mod, "_GROUP_COVER_MIN", 2048)
    signs, valid, qs = _tied_signs(n, d, 4, seed=d, dead=(3, 128, 129))
    want = [np.asarray(a) for a in jpipe._hamming_slots(
        jnp.asarray(signs), jnp.asarray(valid), jnp.asarray(qs), count=count, d=d)]
    got = [t.numpy() for t in tpipe._hamming_slots(
        torch.from_numpy(signs), torch.from_numpy(valid), torch.from_numpy(qs), count=count,
        d=d)]
    assert tpipe._composite_bits(n, d) is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_candidate_generators_union_and_rerank_match_jax():
    (jx, jvalid, _jb, jsigns, _jxsq), (x, valid, _b, signs, _xsq), q, xsqs = _state("cosine")
    jxsq, xsq = xsqs[64]
    tq = torch.from_numpy(q)
    jf = jpipe.funnel_candidates_batch(jx, jvalid, jnp.asarray(q), jxsq, metric="cosine",
                                       stages=(64, 128), count=FUNNEL_COUNT)
    tf = tpipe.funnel_candidates_batch(x, valid, tq, xsq, metric="cosine", stages=(64, 128),
                                       count=FUNNEL_COUNT)
    jq = jpipe.quantized_candidates_batch(jsigns, jvalid, jnp.asarray(q), count=QUANT_COUNT, d=D)
    tqc = tpipe.quantized_candidates_batch(signs, valid, tq, count=QUANT_COUNT, d=D)
    for g, w in ((tf, jf), (tqc, jq)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    big = 2**31 - 1
    blocks = np.concatenate([np.where(np.asarray(jf[1]), np.asarray(jf[0]), big),
                             np.where(np.asarray(jq[1]), np.asarray(jq[0]), big)],
                            axis=1).astype(np.int32)
    ju = jpipe.union_candidates(jnp.asarray(blocks))
    tu = tpipe.union_candidates(torch.from_numpy(blocks))
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jpipe.rerank_batch(jx, ju[0], ju[1], jnp.asarray(q), metric="cosine", limit=LIMIT)
    got = tpipe.rerank_batch(x, tu[0].long(), tu[1], tq, metric="cosine", limit=LIMIT)
    _assert_same(got, want)
    # the single-query wrapper is row 0 of the batch
    one = tpipe.rerank_pipeline(x, tu[0][0].long(), tu[1][0], tq[0], metric="cosine",
                                limit=LIMIT)
    np.testing.assert_array_equal(one[0].numpy(), got[0][0].numpy())
    np.testing.assert_allclose(one[1].numpy(), got[1][0].numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the cache's sign bits and sign block
# ---------------------------------------------------------------------------


def _records(kind, d=100, n=40):
    """Record pairs (JAX, port) with stored words, without, or mixed; the
    vectors are f32 for "without" (the port packs from the f32 block) and
    f64 for "mixed" (the reference's f64 path)."""
    rng = np.random.default_rng(len(kind))
    vecs = rng.normal(size=(n, d))
    vecs[:, :3] = 0.0  # sign of zero: bit set (>= 0.0)
    vecs[0, 3] = -0.0
    words = rng.integers(0, 2**63, (n, (d + 63) // 64), dtype=np.uint64) * 2 + 1
    out = []
    for i in range(n):
        with_bv = kind == "with" or (kind == "mixed" and i % 3 == 0)
        vec = vecs[i].astype(np.float32) if kind == "without" else vecs[i]
        bv = [int(w) for w in words[i]] if with_bv else None
        out.append(dict(id=f"k-{(i * 7) % n:03d}", value=None, vector=vec, vectors=None,
                        binary_vector=bv, metadata=None))
    return ([jvt.Embedding(**r) for r in out], [TEmbedding(**r) for r in out])


@pytest.mark.parametrize("kind", ["with", "without", "mixed"])
def test_cache_bits_and_signs_match_jax(kind):
    jrecs, trecs = _records(kind)
    jcache = jcoll._VectorCache(jrecs, 100)
    tcache = tcoll._VectorCache(trecs, 100, torch.device("cpu"))
    assert jcache.ids == tcache.ids and jcache.cap == tcache.cap
    jbits = np.asarray(jcache.bits())
    tbits = tcache.bits()
    assert tbits.dtype == torch.int64
    np.testing.assert_array_equal(tbits.numpy(), jbits.astype(np.int64))
    np.testing.assert_array_equal(tcache.signs().numpy(), np.asarray(jcache.signs()))
    # prefix squared norms: f32 sums, equal up to summation order
    np.testing.assert_allclose(tcache.stage_xsq(64).numpy(), np.asarray(jcache.stage_xsq(64)),
                               rtol=1e-6, atol=0)


def test_signs_from_bits_reads_every_bit():
    rng = np.random.default_rng(9)
    words = rng.integers(0, 2**32, (5, 4), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000001
    want = np.asarray(jpipe.signs_from_bits(jnp.asarray(words), d=100))
    got = tpipe.signs_from_bits(torch.from_numpy(words.astype(np.int64)), d=100)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="int64"):
        tpipe.signs_from_bits(torch.from_numpy(words.view(np.int32)), d=100)


def test_scan_cache_state_types():
    (jx, jvalid, jbits, jsigns, jxsq), (x, valid, bits, signs, xsq), *_ = _state("cosine")
    assert x.dtype == torch.float32 and valid.dtype == torch.bool
    assert bits.dtype == torch.int64 and signs.dtype == torch.int8 and xsq.dtype == torch.float32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits).astype(np.int64))
    bf = convert.scan_cache_state(np.asarray(jx.astype(jnp.bfloat16)), np.asarray(jvalid),
                                  None, None, None, device="cpu")
    assert bf[0].dtype == torch.bfloat16 and bf[2:] == (None, None, None)
    assert torch.equal(bf[0].float(), torch.from_numpy(
        np.asarray(jx.astype(jnp.bfloat16).astype(jnp.float32))))
    with pytest.raises(terrors.DimensionMismatch):
        convert.scan_cache_state(np.asarray(jx), np.asarray(jvalid)[:-1], None, None, None,
                                 device="cpu")
