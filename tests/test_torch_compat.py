"""The port's compat ``DB`` (``vettore_tpu_torch/compat.py``) against the JAX
package's, on the CPU: the cases of ``tests/test_compat.py`` run on a
``DB`` of each package with the same calls, and their results, scores
(within 1e-6) and errors (type, reason and message) must agree."""

import numpy as np
import pytest

import vettore_tpu as jvt
import vettore_tpu_torch as tvt
from vettore_tpu_torch import errors

SCORE_TOL = 1e-6


@pytest.fixture
def dbs():
    handles = (jvt.DB(), tvt.DB(device="cpu"))
    yield handles
    for handle in handles:
        handle.close()


def call(dbs, method, *args, **kwargs):
    """The same call on both ``DB``s; returns the port's result after
    checking that the JAX package's equals it (scores within SCORE_TOL)."""
    want = getattr(dbs[0], method)(*args, **kwargs)
    got = getattr(dbs[1], method)(*args, **kwargs)
    if method in ("similarity_search", "rerank"):
        assert [h[0] for h in got] == [h[0] for h in want]
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], rtol=0,
                                   atol=SCORE_TOL)
    elif method == "get_all":
        assert sorted(got, key=str) == sorted(want, key=str)
    elif method in ("get_by_value", "get_by_vector"):
        assert (got.id, got.metadata) == (want.id, want.metadata)
    else:
        assert got == want
    return got


def raises(dbs, err, method, *args, **kwargs):
    """Both packages raise ``err`` (by name) with the same reason and
    message; returns the port's exception."""
    with pytest.raises(getattr(jvt.errors, err.__name__)) as want:
        getattr(dbs[0], method)(*args, **kwargs)
    with pytest.raises(err) as got:
        getattr(dbs[1], method)(*args, **kwargs)
    assert got.value.reason == want.value.reason and str(got.value) == str(want.value)
    return got.value


def test_create_insert_search(dbs):
    assert call(dbs, "create_collection", "legacy", 2, "cosine") == "legacy"
    assert call(dbs, "insert", "legacy", {"value": "a", "vector": [1.0, 0.0]}) == "a"
    results = call(dbs, "similarity_search", "legacy", [1.0, 0.0], limit=1)
    assert results[0][0] == "a"
    assert results[0][1] == 1.0  # compat score defaults to similarity mode
    assert dbs[1].collection("legacy").device.type == "cpu"


def test_duplicate_collection(dbs):
    call(dbs, "create_collection", "docs", 2)
    err = raises(dbs, errors.VettoreError, "create_collection", "docs", 2)
    assert err.reason == "collection_already_exists"
    raises(dbs, errors.VettoreError, "create_collection", 7, 2)  # a name must be a string


def test_delete_collection(dbs):
    call(dbs, "create_collection", "docs", 2)
    assert call(dbs, "delete_collection", "docs") == "docs"
    err = raises(dbs, errors.VettoreError, "similarity_search", "docs", [1.0, 0.0])
    assert err.reason == "collection_not_found"
    raises(dbs, errors.VettoreError, "delete_collection", "docs")


def test_metric_aliases(dbs):
    call(dbs, "create_collection", "ham", 2, "binary")
    assert dbs[1].collection("ham").metric == "hamming"
    call(dbs, "create_collection", "ann", 2, "hnsw")
    col = dbs[1].collection("ann")
    assert col.metric == "l2"
    assert col.index_kind == "hnsw"
    call(dbs, "create_collection", "euc", 2, "euclidean")
    assert dbs[1].collection("euc").metric == "l2"
    call(dbs, "create_collection", "ivf", 2, index="ivf", compressed=True)
    assert dbs[1].collection("ivf").index_kind == "ivf"


def test_batch_get_all_delete(dbs):
    call(dbs, "create_collection", "docs", 2, "l2")
    ids = call(dbs, "batch", "docs", [
        {"id": "a", "vector": [0.0, 0.0], "metadata": {"kind": "origin"}},
        {"id": "b", "vector": [1.0, 1.0]},
    ])
    assert ids == ["a", "b"]
    records = call(dbs, "get_all", "docs")
    assert ("a", [0.0, 0.0], {"kind": "origin"}) in records
    assert call(dbs, "delete", "docs", "a") == "a"
    assert len(call(dbs, "get_all", "docs")) == 1


def test_get_by_value_and_vector(dbs):
    call(dbs, "create_collection", "docs", 2, "cosine")
    call(dbs, "insert", "docs", {"id": "a", "vector": [1.0, 0.0]})
    assert call(dbs, "get_by_value", "docs", "a").id == "a"
    raises(dbs, errors.NotFound, "get_by_value", "docs", "missing")
    assert call(dbs, "get_by_vector", "docs", [1.0, 0.0]).id == "a"
    raises(dbs, errors.NotFound, "get_by_vector", "docs", [0.0, 1.0])


def test_rerank(dbs):
    call(dbs, "create_collection", "docs", 2, "cosine")
    call(dbs, "insert", "docs", {"id": "a", "vector": [1.0, 0.0]})
    call(dbs, "insert", "docs", {"id": "b", "vector": [0.0, 1.0]})
    assert call(dbs, "rerank", "docs", [("a", 0.9), ("b", 0.8)], limit=1) == [("a", 0.9)]
    assert call(dbs, "rerank", "docs", [("a", 0.9), ("b", 0.8)], limit=2, alpha=0.2) == [
        ("a", 0.9), ("b", 0.8)]


def test_closed_db(dbs):
    call(dbs, "create_collection", "docs", 2)
    for db in dbs:
        db.close()
        db.close()  # idempotent
    raises(dbs, errors.Closed, "create_collection", "other", 2)
    raises(dbs, errors.Closed, "similarity_search", "docs", [1.0, 0.0])


def test_db_device_is_explicit(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        tvt.DB()
