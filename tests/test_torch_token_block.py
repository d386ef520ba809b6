"""A call's query token sets, checked and normalised as one block
(``Collection._pad_query_sets`` / ``_prepare_query_vectors``), against the
JAX package's, on the CPU: its per-token loop (each token's
``_validate_dims`` and a one-row ``normalize_rows``, then one ``np.stack``
a set) is the reference.

Sets of ``(d,)`` integer or float ndarrays take the port's block path and
give bit-identical ``qtok`` / ``qmask`` for every normalisation, every
token dtype and ragged sets; lists of floats, tuples, mixed sets and bad
tokens take the port's own loop, and a bad token raises the same first
error, of the same class name and message, with the same warnings, as the
JAX package.
"""

import warnings

import numpy as np
import pytest
import torch

import vettore_tpu as jvt
import vettore_tpu_torch as vt
from vettore_tpu_torch.collection import Collection
from vettore_tpu_torch.metrics import F32_MAX
from vettore_tpu_torch.ops.distance import NORMALIZATIONS

torch.set_num_threads(2)

D = 128

#: ragged sets: one token, a few, ColBERT's 32, one past a power of two
LENGTHS = (1, 3, 32, 33)


def _reference(normalize, query_sets):
    """The JAX package's ``(qtok [B, Qmax, d] f32, qmask [B, Qmax])``."""
    return _jax_collection(normalize)._pad_query_sets(query_sets)


def _jax_collection(normalize):
    return jvt.Collection(name="tok", dimensions=D, metric="inner_product",
                          normalize=normalize)


def _collection(normalize):
    return vt.Collection(name="tok", dimensions=D, metric="inner_product",
                         normalize=normalize, device="cpu")


def _sets(dtype, seed=0, lengths=LENGTHS):
    """Ragged sets of ``dtype`` rows: values over many magnitudes, and a
    zero and a constant row (the normalisations' zero-key branch)."""
    rng = np.random.default_rng(seed)
    sets = []
    for n in lengths:
        if np.dtype(dtype).kind == "f":
            x = rng.normal(size=(n, D)) * 10.0 ** rng.integers(-3, 4, size=(n, 1))
        else:
            x = rng.integers(-1000, 1000, size=(n, D))
        x = x.astype(dtype)
        if n >= 3:
            x[1] = 0
            x[2] = 7
        sets.append(list(x))
    return sets


def _no_loop(monkeypatch):
    def refused(self, query_vectors):
        raise AssertionError("the per-token loop ran")
    monkeypatch.setattr(Collection, "_token_rows", refused)


def _assert_same(got, want):
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    np.testing.assert_array_equal(got[1], want[1])


def _outcome(fn, *args):
    """``fn``'s result, or its exception's class and message, with the
    warnings it gave."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            out = ("ok", fn(*args))
        except Exception as exc:  # noqa: BLE001 - compared, not handled
            out = ("raised", type(exc).__name__, str(exc))
    return out, sorted({(w.category.__name__, str(w.message)) for w in seen})


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("normalize", NORMALIZATIONS)
def test_block_path_is_bit_identical(normalize, dtype, monkeypatch):
    col, jcol = _collection(normalize), _jax_collection(normalize)
    sets = _sets(dtype, seed=NORMALIZATIONS.index(normalize) + 10 * np.dtype(dtype).itemsize)
    want = jcol._pad_query_sets(sets)
    singles = [jcol._prepare_query_vectors(qs) for qs in sets]
    _no_loop(monkeypatch)
    got = col._pad_query_sets(sets)
    _assert_same(got, want)
    assert got[0].shape == (len(LENGTHS), 64, D)
    # one set: the single-query searches' check
    for qs, one in zip(sets, singles):
        mine = col._prepare_query_vectors(qs)
        assert mine.dtype == one.dtype and mine.shape == one.shape
        np.testing.assert_array_equal(mine.view(np.uint32), one.view(np.uint32))


@pytest.mark.parametrize("form", ["tuples", "float_lists", "mixed"])
@pytest.mark.parametrize("normalize", NORMALIZATIONS)
def test_other_forms_give_the_same_bits(normalize, form, monkeypatch):
    """Tuples of ndarrays take the block path; lists of floats and sets that
    mix ndarray and list tokens take the loop, with the same bits."""
    col = _collection(normalize)
    sets = _sets(np.float32, seed=5)
    if form == "tuples":
        sets = [tuple(s) for s in sets]
        _no_loop(monkeypatch)
    elif form == "float_lists":
        sets = [[v.tolist() for v in s] for s in sets]
    else:
        sets = [[v.tolist() if j % 2 else v for j, v in enumerate(s)] for s in sets]
    _assert_same(col._pad_query_sets(sets), _reference(normalize, sets))


def _faulty(fault):
    """Six sets of eight f32 tokens with ``fault`` in set 3, token 5."""
    sets = [list(s) for s in np.random.default_rng(9).normal(size=(6, 8, D)).astype(np.float32)]
    tok = sets[3][5]
    if fault == "nan":
        tok[7] = np.nan
    elif fault == "inf":
        tok[0] = np.inf
    elif fault == "neg_inf":
        tok[-1] = -np.inf
    elif fault == "above_f32_max":
        sets[3][5] = tok.astype(np.float64)
        sets[3][5][3] = 3.5e38
    elif fault == "below_f32_min":
        sets[3][5] = tok.astype(np.float64)
        sets[3][5][0] = -3.5e38
    elif fault == "at_f32_max":  # in range: both pass
        sets[3][5] = tok.astype(np.float64)
        sets[3][5][[0, -1]] = [-F32_MAX, F32_MAX]
    elif fault == "f16_inf":
        sets[3][5] = tok.astype(np.float16)
        sets[3][5][1] = np.inf
    elif fault == "short":
        sets[3][5] = tok[:-1]
    elif fault == "long":
        sets[3][5] = np.append(tok, 1.0)
    elif fault == "two_d":
        sets[3][5] = tok[:, None]
    elif fault == "row_matrix":
        sets[3][5] = tok[None, :]
    elif fault == "scalar":
        sets[3][5] = np.float32(1.0)
    elif fault == "zero_d":
        sets[3][5] = np.array(1.0)
    elif fault == "bool_dtype":
        sets[3][5] = tok > 0
    elif fault == "complex_dtype":
        sets[3][5] = tok.astype(np.complex64)
    elif fault == "object_dtype":
        sets[3][5] = tok.astype(object)
    elif fault == "string":
        sets[3][5] = "token"
    elif fault == "bool_in_list":
        sets[3][5] = [True] + tok[1:].tolist()
    elif fault == "nan_in_list":
        sets[3][5] = tok.tolist()[:-1] + [float("nan")]
    elif fault == "empty_set":
        sets[3] = []
    elif fault == "set_not_a_list":
        sets[3] = np.stack(sets[3])
    elif fault == "set_is_none":
        sets[3] = None
    elif fault == "two_faults":
        # the loop's order: set 3's NaN before set 4's short token
        tok[2] = np.nan
        sets[4][0] = sets[4][0][:5]
    else:
        raise ValueError(fault)
    return sets


FAULTS = ("nan", "inf", "neg_inf", "above_f32_max", "below_f32_min", "at_f32_max", "f16_inf",
          "short", "long", "two_d", "row_matrix", "scalar", "zero_d", "bool_dtype",
          "complex_dtype", "object_dtype", "string", "bool_in_list", "nan_in_list",
          "empty_set", "set_not_a_list", "set_is_none", "two_faults")


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_raise_as_the_loop_does(fault):
    col = _collection("l2")
    sets = _faulty(fault)
    got, got_warn = _outcome(col._pad_query_sets, sets)
    want, want_warn = _outcome(_reference, "l2", sets)
    assert got[:1] == want[:1] and got_warn == want_warn
    if want[0] == "raised":
        assert got == want
    else:  # complex tokens pass the checks and lose their imaginary part, as before
        assert fault in ("at_f32_max", "complex_dtype"), fault
        _assert_same(got[1], want[1])
    if fault in ("nan", "inf", "above_f32_max", "below_f32_min", "short", "bool_dtype",
                 "empty_set", "set_not_a_list", "bool_in_list"):
        assert want[0] == "raised", fault


def test_public_batch_raises_the_first_bad_token():
    """Through ``multi_vector_search_batch``: the same answers from ndarray
    and list tokens, and the error of the first bad token in the loop's
    order, as the JAX package raises it."""
    col, jcol = _collection("none"), _jax_collection("none")
    rng = np.random.default_rng(2)
    ids, toks = [f"d{i:02d}" for i in range(40)], rng.normal(size=(40, 4, D)).astype(np.float32)
    col.put_tokens(ids, toks)
    jcol.put_tokens(ids, toks)
    sets = [list(s) for s in rng.normal(size=(3, 4, D)).astype(np.float32)]
    as_lists = [[v.tolist() for v in s] for s in sets]
    hits = [[(r.id, r.score) for r in row] for row in col.multi_vector_search_batch(sets)]
    assert hits == [[(r.id, r.score) for r in row]
                    for row in col.multi_vector_search_batch(as_lists)]
    sets[1][2] = sets[1][2].copy()
    sets[1][2][0] = np.nan
    sets[2][0] = sets[2][0][:3]
    got = _outcome(col.multi_vector_search_batch, sets)
    assert got == _outcome(jcol.multi_vector_search_batch, sets)
    assert got[0] == ("raised", "InvalidVector", "vector contains a non-finite value")
