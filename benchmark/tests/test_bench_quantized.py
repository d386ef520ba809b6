"""The binary-quantized cell (``quantized3072.batch512``): its reference
against a brute NumPy oracle, its control failing more than one check, its
own faults, and the least times at the cell's own shape."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import binary_rerank as ref
from benchmark.roofline_quantized import hamming, least_call
from conftest import cell_of, faults_of, run_tiny

CELL = "quantized3072.batch512"


def brute(x, q, k, candidates):
    """Sign bits compared bit by bit, the ``candidates`` least Hamming
    distances by (distance, row), rescored by float64 cosine, the ``k``
    best by (score desc, row asc)."""
    ham = ((x[None, :, :] >= 0) != (q[:, None, :] >= 0)).sum(axis=2)
    x64 = x.astype(np.float64) / np.linalg.norm(x.astype(np.float64), axis=1, keepdims=True)
    q64 = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64), axis=1, keepdims=True)
    rows, scores, hams = [], [], []
    for b in range(q.shape[0]):
        cand = sorted(range(x.shape[0]), key=lambda i: (ham[b, i], i))[:candidates]
        s = {i: float(x64[i] @ q64[b]) for i in cand}
        top = sorted(cand, key=lambda i: (-s[i], i))[:k]
        rows.append(top)
        scores.append([s[i] for i in top])
        hams.append(cand)
    return np.array(rows), np.array(scores), np.array(hams)


@pytest.mark.parametrize("chunk", [7, 64, 1 << 17])
def test_reference_equals_brute(chunk, monkeypatch):
    monkeypatch.setattr(ref, "_ROWS", chunk)
    monkeypatch.setattr(ref, "_QUERIES", 3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 40)).astype(np.float32)
    x[17] = x[3]  # an exact tie at every stage: the lower row first
    x[5, :7] = 0.0  # sign of zero: set (>= 0)
    q = rng.standard_normal((7, 40)).astype(np.float32)
    q[0] = x[3]
    blocks = [(0, torch.from_numpy(x[:120])), (120, torch.from_numpy(x[120:]))]
    cand, hams = ref.hamming_candidates(blocks, q, 50)
    rows, scores = ref.top_k(blocks, q, 10, candidates=50)
    want_rows, want_scores, want_cand = brute(x, q, 10, 50)
    np.testing.assert_array_equal(cand, want_cand)
    assert (np.diff(hams, axis=1) >= 0).all() and hams[0, 0] == 0
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-12)
    assert rows[0, 0] == 3 and rows[0, 1] == 17
    np.testing.assert_allclose(ref.scores_of(blocks, q, rows), want_scores, rtol=0, atol=1e-12)


def test_tf32_rescore_keeps_the_candidates_and_loses_digits():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 768)).astype(np.float32)
    q = rng.standard_normal((4, 768)).astype(np.float32)
    blocks = [(0, torch.from_numpy(x))]
    rows, scores = ref.top_k(blocks, q, 10, candidates=40)
    t_rows, t_scores = ref.top_k(blocks, q, 10, precision="tf32", candidates=40)
    cand, _h = ref.hamming_candidates(blocks, q, 40)
    assert all(set(r) <= set(c) for r, c in zip(t_rows, cand))
    err = np.abs(t_scores - ref.scores_of(blocks, q, t_rows)).max()
    assert 1e-6 < err < 1e-3


def test_numbers():
    truth_rows = np.array([[1, 2, 3]])
    exact = np.array([[0.9, 0.7, 0.8]])  # rows 1, 3, 2: the last two swapped
    got = ref.numbers(np.array([[1, 3, 4]]), exact + 1e-3, truth_rows, None, exact)
    assert got["match"] == pytest.approx(2 / 3)
    assert got["score_err"] == pytest.approx(1e-3)
    assert got["order_gap"] == pytest.approx(0.1)


def test_the_configuration_states_the_references_candidates():
    assert int(cell_of(CELL).config["candidates"]) == ref.CANDIDATES


def _failing(res) -> set:
    got = res["info"]["readings"]
    return {name for name, lim in cell_of(CELL).config["checks"].items()
            if got[name] > lim.get("max", float("inf")) or got[name] < lim.get("min", 0.0)}


def test_control_fails_score_err_and_another_check():
    res = run_tiny(CELL, control=True)
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert not res["correct"]
    failing = _failing(res)
    assert "score_err" in failing and len(failing) >= 2, res["info"]["readings"]


@pytest.mark.parametrize("fault", ["exact", "no_rerank"])
def test_the_stage_faults_fail_match(fault):
    """The exact top 10 and the Hamming top 10 alone are both answers of
    the right form, sound scores and order: only ``match`` tells them from
    the rescore of the Hamming candidates."""
    fn, _least = faults_of("quantized")[fault]
    res = run_tiny(CELL, fault=fn)
    assert res["failed"] == 0 and not res["correct"]
    assert _failing(res) == {"match"}, res["info"]["readings"]


def test_least_times_at_the_cells_shape():
    cell = harness.load_cell(CELL)
    c, tr = cell.config, cell.traffic
    b, n, d, k = tr["batch"], c["rows"], c["dims"], c["candidates"]
    t, by = hamming(b, n, d)
    # 3.15 TOP at the int8 peak against 384 MB of packed bits
    assert by == "operations" and t * 1e3 == pytest.approx(1.5896, abs=5e-5)
    assert n * d / 8 / 3.35e12 * 1e3 == pytest.approx(0.1146, abs=5e-5)
    t_call, by_call = least_call(b, n, d, k)
    # the rescore reads 3.15 GB of candidate rows (0.939 ms): still below
    # the operations, which its 1.6 GFLOP at TF32 raise by 0.003 ms
    assert by_call == "operations" and t_call * 1e3 == pytest.approx(1.5927, abs=5e-5)
    assert (n * d / 8 + b * k * d * 4) / 3.35e12 * 1e3 == pytest.approx(1.0537, abs=5e-5)
