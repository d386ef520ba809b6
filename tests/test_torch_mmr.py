"""The port's MMR (``vettore_tpu_torch/ops/mmr.py``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both packages: the float64 host
loop ``mmr_rerank`` must return the same list for every metric; the batched
path (``pairwise_similarity_batch`` then ``mmr_select_batch``) the same order
on ragged lists, under mass ties (the earliest remaining candidate wins) and
with negative redundancy (the running maximum starts at -inf, not 0). Pair
similarities agree within 1e-6 * max(1, |sim|) (f32 products summed in
another order); the selection on one similarity matrix is exact. Errors are
the same exception types.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vettore_tpu import errors as jerr
from vettore_tpu.ops import mmr as jmmr
from vettore_tpu_torch import errors as terr
from vettore_tpu_torch.metrics import METRICS
from vettore_tpu_torch.ops import mmr as tmmr

torch.set_num_threads(2)

D = 8
SIM_TOL = 1e-6


def _pool(rng, k, d=D, sparse=False):
    vecs = rng.normal(size=(k, d)).astype(np.float32)
    if sparse:  # zeros make hamming / jaccard distances differ between rows
        vecs[rng.random(vecs.shape) < 0.4] = 0.0
    return vecs


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("metric", METRICS)
def test_host_mmr_rerank_matches_jax(metric, alpha):
    rng = np.random.default_rng(11)
    vecs = _pool(rng, 12, sparse=metric in ("hamming", "jaccard"))
    initial = [(f"c{i:02d}", float(s)) for i, s in enumerate(rng.normal(size=12))]
    pool = [(f"c{i:02d}", [float(v) for v in row]) for i, row in enumerate(vecs)]
    got = tmmr.mmr_rerank(initial, pool, metric, alpha, 6)
    assert got == jmmr.mmr_rerank(initial, pool, metric, alpha, 6)
    assert len(got) == 6


def _batch_inputs(rng, b, k, d=D, sparse=False):
    vecs = np.stack([_pool(rng, k, d, sparse) for _ in range(b)])
    scores = rng.normal(size=(b, k)).astype(np.float32)
    valid = np.ones((b, k), bool)
    valid[0, -3:] = False
    return vecs, scores, valid


@pytest.mark.parametrize("metric", METRICS)
def test_pair_similarities_and_selection_match_jax(metric):
    rng = np.random.default_rng(13)
    vecs, scores, valid = _batch_inputs(rng, 3, 10, sparse=metric in ("hamming", "jaccard"))
    want = np.asarray(jmmr.pairwise_similarity_batch(jnp.asarray(vecs), metric=metric))
    got = tmmr.pairwise_similarity_batch(torch.from_numpy(vecs), metric=metric).numpy()
    assert got.dtype == np.float32
    # off the diagonal: a row against itself is never read by the selection
    # (a picked candidate is masked), and for l2 the JAX package's diagonal
    # is the square root of a rounding residual (the port's is exactly 0)
    off = ~np.eye(vecs.shape[1], dtype=bool)[None]
    assert (np.abs(got - want) <= SIM_TOL * np.maximum(1.0, np.abs(want)))[off.repeat(3, 0)].all()
    if metric in ("l2", "l2_squared"):
        assert (np.diagonal(got, axis1=1, axis2=2) == 1.0).all()
    # the selection on ONE similarity matrix: the same order, exactly
    for alpha in (0.0, 0.5, 1.0):
        j_order = np.asarray(jmmr.mmr_select_batch(
            jnp.asarray(scores), jnp.asarray(want), jnp.asarray(valid), alpha, final_k=12))
        t_order = tmmr.mmr_select_batch(torch.from_numpy(scores), torch.from_numpy(want),
                                        torch.from_numpy(valid), alpha, final_k=12).numpy()
        np.testing.assert_array_equal(t_order, j_order)
        assert (t_order[0, -3:] == -1).all()  # query 0 runs out of candidates


def _both_batches(lists, vecs, **kw):
    want = jmmr.mmr_rerank_batch(lists, vecs, **kw)
    got = tmmr.mmr_rerank_batch(lists, vecs, device="cpu", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("metric", ["cosine", "l2", "inner_product", "manhattan"])
def test_batch_matches_jax_on_ragged_lists(metric):
    rng = np.random.default_rng(17)
    k = 9
    lens = (9, 4, 1, 6)
    vecs = np.zeros((len(lens), k, D), np.float32)
    lists = []
    for b, n in enumerate(lens):
        vecs[b, :n] = _pool(rng, n)
        lists.append([(f"q{b}-{i}", float(10.0 * s)) for i, s in enumerate(rng.normal(size=n))])
    for alpha, final_k in ((0.5, 5), (0.2, 12), (1.0, 3)):
        got = _both_batches(lists, vecs, metric=metric, alpha=alpha, final_k=final_k)
        assert [len(row) for row in got] == [min(n, final_k) for n in lens]
        # the host loop agrees too where the scores dominate f32 noise
        for b, n in enumerate(lens):
            pool = [(lists[b][i][0], [float(v) for v in vecs[b, i]]) for i in range(n)]
            want = tmmr.mmr_rerank(lists[b], pool, metric, alpha, final_k)
            assert [i for i, _ in got[b]] == [i for i, _ in want]


def test_batch_mass_ties_pick_the_earliest_candidate():
    """Identical vectors and identical scores: every step is a k-way tie, so
    the order is the input order in both packages and in the host loop."""
    k = 7
    vecs = np.ones((2, k, D), np.float32)
    lists = [[(f"t{b}-{i}", 0.5) for i in range(k)] for b in range(2)]
    got = _both_batches(lists, vecs, metric="cosine", alpha=0.5, final_k=5)
    assert [[i for i, _ in row] for row in got] == [[f"t{b}-{i}" for i in range(5)]
                                                    for b in range(2)]
    pool = [(f"t0-{i}", [1.0] * D) for i in range(k)]
    assert [i for i, _ in tmmr.mmr_rerank(lists[0], pool, "cosine", 0.5, 5)] == \
        [i for i, _ in got[0]]


def test_batch_negative_redundancy_is_not_floored_at_zero():
    """After ``a`` is picked, ``b`` (score 0.5, cosine -0.9 to ``a``) scores
    0.25 + 0.45 = 0.70 and beats ``c`` (score 0.8, cosine 0 to ``a``: 0.40).
    A running maximum that started at 0 would floor b's redundancy at 0
    (0.25) and pick ``c``."""
    a = np.zeros(D, np.float32)
    a[0] = 1.0
    b = np.zeros(D, np.float32)
    b[0], b[1] = -0.9, np.sqrt(1 - 0.81)
    c = np.zeros(D, np.float32)
    c[2] = 1.0
    vecs = np.stack([a, b, c])[None]
    lists = [[("a", 1.0), ("b", 0.5), ("c", 0.8)]]
    got = _both_batches(lists, vecs, metric="cosine", alpha=0.5, final_k=2)
    assert [i for i, _ in got[0]] == ["a", "b"]
    pool = [(i, [float(x) for x in v]) for i, v in zip("abc", vecs[0])]
    assert tmmr.mmr_rerank(lists[0], pool, "cosine", 0.5, 2) == got[0]


def _raises_like_jax(call_j, call_t):
    with pytest.raises(jerr.VettoreError) as j:
        call_j()
    with pytest.raises(terr.VettoreError) as t:
        call_t()
    assert type(t.value).__name__ == type(j.value).__name__
    assert getattr(t.value, "reason", None) == getattr(j.value, "reason", None)


@pytest.mark.parametrize("case", [
    (([("a", 1.0)], [("a", [1.0, 0.0])], "cosine", 1.5, 1)),
    (([("a", 1.0)], [("a", [1.0, 0.0])], "cosine", 0.5, 0)),
    (([("a", 1.0)], [("a", [1.0, 0.0])], "cosine", True, 1)),
    (([("a", 1.0)], [("a", [1.0, 0.0])], "nope", 0.5, 1)),
    (([("a", 1.0)], [("a", [1.0, 0.0]), ("a", [0.0, 1.0])], "cosine", 0.5, 1)),
    (([("a", 1.0)], [("a", [1.0, 0.0]), ("b", [0.0])], "cosine", 0.5, 1)),
    (([("a", 1.0)], [("a", [float("nan"), 0.0])], "cosine", 0.5, 1)),
    (([("z", 1.0)], [("a", [1.0, 0.0])], "cosine", 0.5, 1)),
    (([("a", 1.0), ("a", 2.0)], [("a", [1.0, 0.0])], "cosine", 0.5, 1)),
    (([("a", float("inf"))], [("a", [1.0, 0.0])], "cosine", 0.5, 1)),
    ((("a", 1.0), [("a", [1.0, 0.0])], "cosine", 0.5, 1)),
])
def test_host_errors_match_jax(case):
    _raises_like_jax(lambda: jmmr.mmr_rerank(*case), lambda: tmmr.mmr_rerank(*case))


@pytest.mark.parametrize("kw", [dict(metric="nope", alpha=0.5, final_k=2),
                                dict(metric="cosine", alpha=1.5, final_k=2),
                                dict(metric="cosine", alpha=False, final_k=2),
                                dict(metric="cosine", alpha=0.5, final_k=0)])
def test_batch_errors_match_jax(kw):
    vecs = np.zeros((1, 1, 4), np.float32)
    _raises_like_jax(lambda: jmmr.mmr_rerank_batch([[("a", 1.0)]], vecs, **kw),
                     lambda: tmmr.mmr_rerank_batch([[("a", 1.0)]], vecs, device="cpu", **kw))


def test_empty_batch_and_default_device():
    assert tmmr.mmr_rerank_batch([], np.zeros((0, 1, 4), np.float32), metric="cosine",
                                 alpha=0.5, final_k=2, device="cpu") == []
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="needs CUDA"):
            tmmr.mmr_rerank_batch([[("a", 1.0)]], np.ones((1, 1, 4), np.float32),
                                  metric="cosine", alpha=0.5, final_k=1)
