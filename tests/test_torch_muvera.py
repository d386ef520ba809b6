"""The port's MUVERA (``vettore_tpu_torch/ops/muvera.py``,
``ops/muvera_fde.py`` and ``Collection.multi_vector_search(candidates=,
muvera=)``) against the JAX package's, on the CPU.

* the host encoders (copied) are byte-identical to the JAX package's over
  several configurations, and raise the same errors;
* the device document-FDE block is within one bf16 ulp of the JAX
  package's (both are f32 segment means rounded to bf16; the means may
  differ in their last f32 bits, summed in another order);
* ``fde_candidates`` on its K5 route and on its plain route, and the
  collection's MUVERA search, give the JAX ids (MaxSim scores within
  1e-5 * max(1, |score|));
* the port's documentation examples run.
"""

import doctest

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vettore_tpu as jvt
from vettore_tpu import errors as jerr
from vettore_tpu.ops import muvera as jmu
from vettore_tpu.ops import muvera_fde as jfde
import vettore_tpu_torch as tvt
from vettore_tpu_torch import collection as tcoll
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch import multi_vector as tmv
from vettore_tpu_torch.ops import mmr as tmmr
from vettore_tpu_torch.ops import muvera as tmu
from vettore_tpu_torch.ops import muvera_fde as tfde

torch.set_num_threads(2)

D = 16
TOL = 1e-5

CONFIGS = [
    {},
    {"num_repetitions": 3, "num_simhash_projections": 2, "seed": 7},
    {"num_repetitions": 2, "num_simhash_projections": 4, "projection_dimension": 8,
     "seed": 2**64 - 1},
    {"num_repetitions": 2, "num_simhash_projections": 3, "final_projection_dimension": 40},
]


def _sets(rng, count, t_max=5, d=D):
    return [rng.normal(size=(int(rng.integers(1, t_max + 1)), d)).astype(np.float32)
            for _ in range(count)]


def test_hash_mixer_and_weights_are_bit_identical():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.integers(0, 2**63, 5000, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
                  for _ in range(4))
    np.testing.assert_array_equal(tmu._hash4(a, b, c, d), jmu._hash4(a, b, c, d))
    for args in ((0, 0, 0, 384), (2**64 - 1, 7, 3, 128), (20_260_721, 5, 9, 16)):
        np.testing.assert_array_equal(tmu._random_weights(*args), jmu._random_weights(*args))
        np.testing.assert_array_equal(tmu._random_signs(*args), jmu._random_signs(*args))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_host_encoders_are_byte_identical(cfg):
    rng = np.random.default_rng(2)
    sets = _sets(rng, 12)
    for mode in ("queries", "documents"):
        got = getattr(tmu, f"encode_{mode}")(sets, cfg)
        want = getattr(jmu, f"encode_{mode}")(sets, cfg)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes()
    for one in ("query", "document"):
        rows = [list(map(float, r)) for r in sets[3]]
        assert getattr(tmu, f"encode_{one}")(rows, cfg) == getattr(jmu, f"encode_{one}")(rows,
                                                                                          cfg)


@pytest.mark.parametrize("vectors, cfg", [
    ([[1.0, 2.0]], {"bogus": 1}),
    ([[1.0, 2.0]], {"num_repetitions": 0}),
    ([[1.0, 2.0]], {"num_simhash_projections": 31}),
    ([[1.0, 2.0]], {"seed": -1}),
    ([[1.0, 2.0]], {"dimension": 3}),
    ([[1.0, 2.0]], {"final_projection_dimension": 0}),
    ([[1.0, 2.0]], {"num_repetitions": 2**20, "num_simhash_projections": 10}),
    ([], {}),
    ([[1.0, 2.0], [1.0]], {}),
    ([[float("nan"), 0.0]], {}),
    ([[3e38, 3e38], [3e38, 3e38]], {}),
    ("abc", {}),
])
def test_host_encoder_errors_match_jax(vectors, cfg):
    with pytest.raises(jerr.VettoreError) as j:
        jmu.encode_query(vectors, cfg)
    with pytest.raises(terr.VettoreError) as t:
        tmu.encode_query(vectors, cfg)
    assert type(t.value).__name__ == type(j.value).__name__
    assert getattr(t.value, "reason", None) == getattr(j.value, "reason", None)


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _token_block(rng, cap, t, n, d=D):
    tokens = np.zeros((cap, t, d), np.float32)
    counts = np.zeros(cap, np.int32)
    for i, s in enumerate(_sets(rng, n, t_max=t, d=d)):
        tokens[i, : len(s)] = s
        counts[i] = len(s)
    return tokens, counts


@pytest.mark.parametrize("cfg", [jfde.default_config(D)] + CONFIGS)
def test_device_fde_block_within_one_bf16_ulp_of_jax(cfg):
    rng = np.random.default_rng(3)
    tokens, counts = _token_block(rng, cap=48, t=6, n=40)
    cfg = tfde.normalize_config(cfg, D)
    assert tfde.padded_width(cfg) == jfde.padded_width(cfg)
    want = np.asarray(jfde.encode_documents_device(
        jnp.asarray(tokens), jnp.asarray(counts), cfg, out_dtype=jnp.bfloat16)).astype(np.float32)
    got = tfde.encode_documents_device(torch.from_numpy(tokens), torch.from_numpy(counts), cfg,
                                       out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert not got[40:].any()  # pad slots encode to zero rows
    # f32 blocks: the same means up to f32 summation order
    want32 = np.asarray(jfde.encode_documents_device(jnp.asarray(tokens), jnp.asarray(counts),
                                                     cfg))
    got32 = tfde.encode_documents_device(torch.from_numpy(tokens), torch.from_numpy(counts),
                                         cfg).numpy()
    np.testing.assert_allclose(got32, want32, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tfde.block_sq_norms(torch.from_numpy(got32)).numpy(),
                               np.asarray(jfde.block_sq_norms(jnp.asarray(want32))), rtol=1e-5)


def test_device_encoder_chunks_seamlessly(monkeypatch):
    rng = np.random.default_rng(4)
    tokens, counts = _token_block(rng, cap=40, t=4, n=37)
    cfg = tfde.normalize_config(tfde.default_config(D), D)
    args = (torch.from_numpy(tokens), torch.from_numpy(counts), cfg)
    whole = tfde.encode_documents_device(*args)
    monkeypatch.setattr(tfde, "_ENC_CHUNK", 16)  # three chunks, the last one short
    assert torch.equal(tfde.encode_documents_device(*args), whole)
    assert torch.equal(tfde.block_sq_norms(whole), (whole ** 2).sum(dim=1))


@pytest.mark.parametrize("cap, route", [(256, "plain"), (1024, "fused")])
def test_fde_candidates_match_jax(cap, route):
    """The K5 route (a block of a whole number of 1,024-row tiles) and the
    plain route select the same slots as the JAX package's routes."""
    rng = np.random.default_rng(5)
    n = cap - 37
    tokens, counts = _token_block(rng, cap=cap, t=4, n=n)
    cfg = tfde.normalize_config(tfde.default_config(D), D)
    fde = np.asarray(jfde.encode_documents_device(jnp.asarray(tokens), jnp.asarray(counts), cfg,
                                                  out_dtype=jnp.bfloat16))
    xsq = np.array(jfde.block_sq_norms(jnp.asarray(fde)))
    bias = np.where(np.arange(cap) < n, 0.0, np.inf).astype(np.float32)
    qfde = tfde.encode_query_sets_host(_sets(rng, 5), cfg)
    j_slots, j_ok = jfde.fde_candidates(jnp.asarray(fde), jnp.asarray(xsq), jnp.asarray(bias),
                                        jnp.asarray(qfde), count=64)
    fde_t = torch.from_numpy(fde.astype(np.float32)).to(torch.bfloat16)
    before = dict(tfde.ROUTES)
    t_slots, t_ok = tfde.fde_candidates(fde_t, torch.from_numpy(xsq), torch.from_numpy(bias),
                                        torch.from_numpy(qfde), count=64)
    assert tfde.ROUTES[route] == before[route] + 1
    assert bool(t_ok.all()) and bool(np.asarray(j_ok).all())
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))


def test_query_fdes_are_the_public_encoder_bit_for_bit():
    rng = np.random.default_rng(6)
    cfg = tfde.normalize_config(tfde.default_config(D), D)
    sets = _sets(rng, 4)
    got = tfde.encode_query_sets_host(sets, cfg)
    np.testing.assert_array_equal(got, jfde.encode_query_sets_host(sets, cfg))
    w = tfde.fde_width(cfg)
    np.testing.assert_array_equal(got[0, :w], np.asarray(tmu.encode_query(
        sets[0].astype(np.float64), cfg), np.float32))


def _mv_pair(n, seed, d=D):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n, 1, d)).astype(np.float32)
    toks = centres + 0.3 * rng.normal(size=(n, 4, d)).astype(np.float32)
    toks = torch.from_numpy(toks).to(torch.bfloat16).float().numpy()
    ids = [f"doc-{i:05d}" for i in rng.permutation(n)]
    cols = (jvt.Collection(name="mu", dimensions=d, metric="cosine"),
            tvt.Collection(name="mu", dimensions=d, metric="cosine", device="cpu"))
    for col in cols:
        col.put_tokens(ids, toks)
    sets = [(toks[i][: 1 + i % 4] + 0.05 * rng.normal(size=(1 + i % 4, d))).tolist()
            for i in rng.integers(0, n, 6)]
    return cols, sets


def _assert_same(got, want):
    assert [[r.id for r in row] for row in got] == [[r.id for r in row] for row in want]
    for grow, wrow in zip(got, want):
        for g, w in zip(grow, wrow):
            assert abs(g.score - w.score) <= TOL * max(1.0, abs(w.score)), (g, w)


@pytest.mark.parametrize("n, route", [(150, "plain"), (700, "fused")])
@pytest.mark.parametrize("muvera", [None, "default"])
def test_collection_muvera_search_matches_jax(n, route, muvera):
    (jcol, tcol), sets = _mv_pair(n, seed=7)
    mu = jfde.default_config(D) if muvera == "default" else None
    before = dict(tfde.ROUTES)
    for metric, cands in (("cosine", 64), ("inner_product", 100)):
        kw = dict(limit=7, metric=metric, candidates=cands, muvera=mu)
        _assert_same(tcol.multi_vector_search_batch(sets, **kw),
                     jcol.multi_vector_search_batch(sets, **kw))
        _assert_same([tcol.multi_vector_search(sets[1], **kw)],
                     [jcol.multi_vector_search(sets[1], **kw)])
    assert tfde.ROUTES[route] > before[route]
    assert tcol.host_routes == 0
    # candidates >= the record count is the exact scan
    kw = dict(limit=5, candidates=n)
    _assert_same(tcol.multi_vector_search_batch(sets, **kw),
                 tcol.multi_vector_search_batch(sets, limit=5))
    assert tfde.ROUTES == {**before, route: tfde.ROUTES[route]}


def test_fde_block_is_cached_and_rebuilt_after_a_mutation():
    (jcol, tcol), sets = _mv_pair(120, seed=8)
    kw = dict(limit=5, candidates=32)
    tcol.multi_vector_search_batch(sets, **kw)
    cache = tcol._scan_cache()
    block = cache.fde(tfde.normalize_config(None, D))[0]
    tcol.multi_vector_search_batch(sets, **kw)
    assert tcol._scan_cache() is cache and cache.fde(tfde.normalize_config(None, D))[0] is block
    for col in (jcol, tcol):
        col.put({"id": "aaa-new", "vectors": (np.asarray(sets[0]) * 2.0).tolist()})
    _assert_same(tcol.multi_vector_search_batch(sets, **kw),
                 jcol.multi_vector_search_batch(sets, **kw))


@pytest.mark.parametrize("kw", [dict(candidates=0), dict(candidates=True),
                                dict(candidates="8"), dict(muvera={"num_repetitions": 2}),
                                dict(candidates=16, metric="l2"),
                                dict(candidates=16, muvera={"bogus": 1}),
                                dict(candidates=16, muvera={"num_simhash_projections": 40})])
def test_muvera_option_errors_match_jax(kw):
    (jcol, tcol), sets = _mv_pair(40, seed=9)
    for call in ("multi_vector_search", "multi_vector_search_batch"):
        arg = sets[0] if call == "multi_vector_search" else sets[:2]
        with pytest.raises(jerr.VettoreError) as j:
            getattr(jcol, call)(arg, limit=5, **kw)
        with pytest.raises(terr.VettoreError) as t:
            getattr(tcol, call)(arg, limit=5, **kw)
        assert type(t.value).__name__ == type(j.value).__name__


@pytest.mark.parametrize("module", [tmu, tmmr, tmv, tcoll])
def test_documentation_examples_run(module):
    result = doctest.testmod(module, optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS)
    assert result.failed == 0 and result.attempted > 0
