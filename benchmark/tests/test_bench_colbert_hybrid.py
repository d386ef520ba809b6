"""The ColBERT hybrid cell (``config5-colbert100k.hybrid64``): its control
fails more than one check at the tiny size, and its least time per call at
the cell's own shape."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.roofline_hybrid import least_call
from conftest import cell_of, run_tiny, tiny

CELL = "config5-colbert100k.hybrid64"


def test_control_fails_score_err_and_another_check():
    res = run_tiny(CELL, control=True)
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert not res["correct"]
    got = res["info"]["readings"]
    failing = {name for name, lim in tiny(cell_of(CELL))["config"]["checks"].items()
               if got[name] > lim.get("max", float("inf")) or got[name] < lim.get("min", 0.0)}
    assert "score_err" in failing and len(failing) >= 2, got


def test_least_call_at_the_cells_shape():
    cell = harness.load_cell(CELL)
    c, tr = cell.config, cell.traffic
    t, by = least_call(tr["batch"], min(tr["hnsw_candidates"], tr["quantized_candidates"]),
                       c["query_tokens"], c["tokens"], c["dims"], c["rows"])
    # the candidates' bf16 tokens (524 MB a call) outweigh 16.8 GFLOP at TF32
    assert by == "bytes" and t * 1e3 == pytest.approx(0.1573, abs=5e-5)
    t_ops = 2.0 * 64 * 1000 * 32 * 32 * 128 / 495e12
    assert t_ops * 1e3 == pytest.approx(0.0339, abs=5e-5) and t_ops < t
