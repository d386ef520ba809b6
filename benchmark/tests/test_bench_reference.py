"""The plain reference against a brute NumPy float64 top-k."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import exact_cosine as ref


def brute(x, q, k):
    x64 = x.astype(np.float64)
    x64 /= np.linalg.norm(x64, axis=1, keepdims=True)
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    s = q64 @ x64.T
    rows = np.array([sorted(range(x.shape[0]), key=lambda i: (-s[b, i], i))[:k]
                     for b in range(q.shape[0])])
    return rows, np.take_along_axis(s, rows, 1)


@pytest.mark.parametrize("chunk", [7, 64, 1 << 17])
def test_top_k_equals_brute(chunk):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    x[17] = x[3]  # an exact tie: the lower row first
    q = rng.standard_normal((9, 24)).astype(np.float32)
    q[0] = x[3]
    blocks = [(0, torch.from_numpy(x[:120])), (120, torch.from_numpy(x[120:]))]
    rows, scores = ref.top_k(blocks, q, 10, chunk=chunk)
    want_rows, want_scores = brute(x, q, 10)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-12)
    assert rows[0, 0] == 3 and rows[0, 1] == 17
    np.testing.assert_allclose(ref.scores_of(blocks, q, rows), want_scores, rtol=0, atol=1e-12)


def test_numbers():
    truth_rows = np.array([[1, 2, 3]])
    truth = np.array([[0.9, 0.8, 0.7]])
    exact = np.array([[0.9, 0.7, 0.8]])  # rows 1, 3, 2: the last two swapped
    got = ref.numbers(np.array([[1, 3, 2]]), exact + 1e-3, truth_rows, truth, exact)
    assert got["rank_gap"] == pytest.approx(0.1)
    assert got["score_err"] == pytest.approx(1e-3)
    assert got["recall"] == 1.0
    assert got["order_gap"] == pytest.approx(0.1)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 2**-11, 3.0e-3])
    got = ref.tf32(x)
    assert got[:5].tolist() == [1.0, 1 + 2**-10, 1.0, 1 + 2**-10, -1.0]
    bits = got.view(torch.int32)
    assert ((bits & 0x1FFF) == 0).all()


def test_tf32_products_lose_digits():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 768)).astype(np.float32))
    err = (ref.products(x, q, "tf32").double() - ref.products(x, q, "f64")).abs().max()
    assert 1e-6 < err < 1e-3
