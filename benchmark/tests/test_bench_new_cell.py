"""A cell added as new files only: a configuration with its own tiny size,
a system, its faults, a plain reference and a per-layer reader (the files
of ``new_cell/``), and entries in a copy of ``BENCHMARK.json``, with the
cell's name on the ``workloads`` of ``qps``. Its queries are ``[1 + Q, d]``
arrays and each answer 30 hits whose first 10 are reordered, as a hybrid
search with a MaxSim rerank and MMR gives them."""

from __future__ import annotations

import pytest

from conftest import assert_has_its_metrics, faults_of, run_tiny, tiny


def test_its_entries_and_metrics(new_cell):
    cell, _bench = new_cell
    assert cell.config["system"] == "toy_hybrid" and cell.traffic["limit"] == 10
    assert {m["name"] for m in cell.end_to_end} == {"qps", "setup_s"}
    assert [m["name"] for m in cell.per_layer] == ["toy_rerank_ms.batch"]
    assert_has_its_metrics(cell)


def test_its_own_tiny_size(new_cell):
    """The configuration's ``tiny`` key over the general rules: 1,024
    documents of 8 tokens and 30 hits a query, the rest as every cell's."""
    cell, _bench = new_cell
    over = tiny(cell)
    assert over["config"]["rows"] == 1024 and over["config"]["tokens"] == 8
    assert over["config"]["dims"] == 32
    assert over["traffic"]["limit"] == 30 and over["traffic"]["batch"] == 16


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_it_runs_correct(new_cell, trace):
    cell, _bench = new_cell
    res = run_tiny(cell.name, cell=cell, trace=trace, seconds=0.2 if trace else 0.3)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert res["info"]["readings"].keys() == {"rank_gap", "score_err", "mmr_gap"}
    assert set(res["checks"]) == {"rank_gap", "score_err", "mmr_gap", "failed", "judged"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_its_control_fails(new_cell):
    cell, _bench = new_cell
    res = run_tiny(cell.name, cell=cell, control=True)
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["score_err"]["value"] > 1e-6


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_its_faults_fail(new_cell, fault):
    cell, _bench = new_cell
    fn, _least = faults_of(cell.config["system"])[fault]
    res = run_tiny(cell.name, cell=cell, fault=fn)
    assert not res["correct"], (fault, res["checks"])
