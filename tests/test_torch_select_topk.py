"""The port's group selection and tie-ordered top-k against the JAX package's.

``group_topk`` may order tied values differently (only the selected SET and
the ``ok`` flag carry meaning), so indices compare as sets; values compare
exactly, since selection moves them without arithmetic. ``topk_slots`` must
give ties to the lexicographically smallest id, exactly as XLA's ``top_k``
does in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu.ops import select as jselect
from vettore_tpu.ops import topk as jtopk
from vettore_tpu_torch.ops import select as tselect
from vettore_tpu_torch.ops import topk as ttopk

torch.set_num_threads(2)


def _gmin(b, ng, seed, levels=None, inf_cols=0):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, ng)).astype(np.float32)
    if levels:
        # few distinct values: dense ties at every boundary
        g = np.round(g * levels) / levels
    if inf_cols:
        g[:, rng.choice(ng, inf_cols, replace=False)] = np.inf
    return g


@pytest.mark.parametrize(
    "ng,levels,inf_cols",
    [
        (512, None, 0),  # direct path
        (512, 1, 0),  # direct path, ties deeper than the slack
        (2304, None, 0),  # ng > 2048, ng % 8 == 0: 8-wide super-group descent
        (2304, 3, 40),  # descent with dense ties and +inf groups
        (2053, None, 0),  # ng > 2048, ng % 8 != 0: +inf pad, then descent
    ],
)
def test_group_topk_matches_jax(ng, levels, inf_cols):
    g = _gmin(4, ng, seed=ng, levels=levels, inf_cols=inf_cols)
    want_v, want_i, want_ok = (np.asarray(a) for a in
                               jselect.group_topk(jnp.asarray(g), 24, check_c=16))
    got_v, got_i, got_ok = (a.numpy() for a in
                            tselect.group_topk(torch.from_numpy(g), 24, check_c=16))
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_ok, want_ok)
    for row in range(4):
        assert set(got_i[row].tolist()) == set(want_i[row].tolist())
    if levels == 1:
        assert not want_ok.all()


def test_group_topk_without_check_is_ok():
    g = _gmin(3, 700, seed=1, levels=1)
    _v, idx, ok = tselect.group_topk(torch.from_numpy(g), 10)
    assert ok.all() and idx.shape == (3, 10)


@pytest.mark.parametrize("limit", [1, 8, 16, 64])
def test_topk_slots_mass_ties_pick_lowest_lex(limit):
    rng = np.random.default_rng(limit)
    n = 300
    rank = np.where(rng.random(n) < 0.8, np.float32(0.25), np.float32(1.0)).astype(np.float32)
    rank[rng.choice(n, 20, replace=False)] = np.inf
    lex_order = rng.permutation(n).astype(np.int32)
    want_s, want_r = (np.asarray(a) for a in
                      jtopk.topk_slots(jnp.asarray(rank), jnp.asarray(lex_order), limit=limit))
    got_s, got_r = ttopk.topk_slots(torch.from_numpy(rank), torch.from_numpy(lex_order),
                                    limit=limit)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    # the winners are the tied slots that come first in lex order
    tied = [s for s in lex_order if rank[s] == 0.25]
    assert got_s.numpy().tolist() == tied[:limit]


def test_topk_slots_batched_rows_match_single_rows():
    rng = np.random.default_rng(3)
    rank = np.round(rng.normal(size=(4, 200)), 1).astype(np.float32)
    lex_order = rng.permutation(200).astype(np.int32)
    slots, ranks = ttopk.topk_slots(torch.from_numpy(rank), torch.from_numpy(lex_order), limit=12)
    for b in range(4):
        ws, wr = jtopk.topk_slots(jnp.asarray(rank[b]), jnp.asarray(lex_order), limit=12)
        np.testing.assert_array_equal(slots[b].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(ranks[b].numpy(), np.asarray(wr))


def test_topk_exact_matches_jax():
    rng = np.random.default_rng(4)
    rank = np.round(rng.normal(size=150), 1).astype(np.float32)
    lex_rank = rng.permutation(150).astype(np.int32)
    want_s, want_r = jtopk.topk_exact(jnp.asarray(rank), jnp.asarray(lex_rank), limit=30)
    got_s, got_r = ttopk.topk_exact(torch.from_numpy(rank), torch.from_numpy(lex_rank), limit=30)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("limit,n", [(10, 1000), (10, 12), (16, 16), (17, 1 << 20), (1, 5), (0, 3)])
def test_bucket_limit_matches_jax(limit, n):
    assert ttopk.bucket_limit(limit, n) == jtopk.bucket_limit(limit, n)


# ---------------------------------------------------------------------------
# integer keys and the exact top-C selections of the adaptive pipelines
# ---------------------------------------------------------------------------


def test_group_topk_int32_pad_matches_jax():
    # [3, 2052] int32 keys: 2052 % 8 = 4 and 2052 > 2048, so the +inf pad
    # runs. JAX pads int32 with 2**31 - 1; torch cannot pad an int tensor
    # with float("inf"), so the port pads with the dtype's maximum.
    rng = np.random.default_rng(11)
    g = rng.permutation(3 * 2052 * 4)[: 3 * 2052].reshape(3, 2052).astype(np.int32)
    g[:, -40:] = 2**31 - 1  # invalid composite keys at the tail
    want_v, want_i, want_ok = (np.asarray(a) for a in
                               jselect.group_topk(jnp.asarray(g), 24, check_c=16))
    got_v, got_i, got_ok = (a.numpy() for a in
                            tselect.group_topk(torch.from_numpy(g), 24, check_c=16))
    assert got_v.dtype == np.int32
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_ok, want_ok)


def _nine_pattern_keys(b, n, seed, d=32):
    """Hamming-like keys with mass ties: every row is one of nine sign
    patterns (as tests/test_fallback_paths.py builds them)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2, (9, d)) * 2 - 1
    signs = base[rng.integers(0, 9, n)]
    q = rng.integers(0, 2, (b, d)) * 2 - 1
    return ((d - q @ signs.T) // 2).astype(np.float32), rng


@pytest.mark.parametrize("n,c", [(8192, 100), (8192, 600), (300, 24), (50, 80)])
def test_exact_top_c_mass_ties_match_jax(n, c):
    key, rng = _nine_pattern_keys(3, n, seed=n + c)
    key[:, rng.choice(n, n // 10, replace=False)] = np.inf  # invalid rows
    lex_rank = rng.permutation(n).astype(np.int32)
    for lex in (None, lex_rank):
        want = [np.asarray(a) for a in jselect.exact_top_c(
            jnp.asarray(key), None if lex is None else jnp.asarray(lex), c=c)]
        got = [a.numpy() for a in tselect.exact_top_c(
            torch.from_numpy(key), None if lex is None else torch.from_numpy(lex), c=c)]
        np.testing.assert_array_equal(got[2], want[2])
        ok = want[2]
        np.testing.assert_array_equal(got[0][ok], want[0][ok])
        np.testing.assert_array_equal(got[1][ok], want[1][ok])


@pytest.mark.parametrize("c", [24, 200])
def test_exact_top_c_slots_mass_ties_match_jax(c):
    key, rng = _nine_pattern_keys(3, 4096, seed=c)
    # a gathered sub-block: positions are not slots, slots ascend with lex
    slots = np.sort(rng.choice(1 << 20, 4096, replace=False)).astype(np.int32)
    slots = np.broadcast_to(slots, key.shape).copy()
    key[:, -64:] = np.inf
    slots[:, -64:] = -1
    want = [np.asarray(a) for a in jselect.exact_top_c_slots(jnp.asarray(key),
                                                             jnp.asarray(slots), c=c)]
    got = [a.numpy() for a in tselect.exact_top_c_slots(torch.from_numpy(key),
                                                        torch.from_numpy(slots), c=c)]
    np.testing.assert_array_equal(got[2], want[2])
    ok = want[2]
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    np.testing.assert_array_equal(got[1][ok], want[1][ok])


@pytest.mark.parametrize("n,c", [(8192, 100), (65536, 500), (300, 24), (50, 80)])
def test_exact_top_c_unique_int_mass_ties_match_jax(n, c):
    ham, rng = _nine_pattern_keys(3, n, seed=n)
    slot_bits = max(1, (n - 1).bit_length())
    comp = (ham.astype(np.int32) << slot_bits) | np.arange(n, dtype=np.int32)[None, :]
    comp[:, rng.choice(n, n // 10, replace=False)] = 2**31 - 1
    want_s, want_k = (np.asarray(a) for a in
                      jselect.exact_top_c_unique_int(jnp.asarray(comp), c=c))
    got_s, got_k = (a.numpy() for a in
                    tselect.exact_top_c_unique_int(torch.from_numpy(comp), c=c))
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_k, want_k)
    # ascending (hamming, slot): the composite order itself
    live = got_k < 2**31 - 1
    assert (np.diff(got_k.astype(np.int64), axis=1)[live[:, 1:]] > 0).all()
