"""Each cell's loop end to end on the CPU at a tiny size: a well-formed
result line with the cell's metrics, and the comparison passing."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from conftest import CELLS, assert_has_its_metrics, cell_of, run_tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("name", CELLS)
def test_cell_untraced(name):
    res = run_tiny(name)
    json.dumps(res)
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    cell = cell_of(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["info"]["judged"] == 48
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced(name):
    res = run_tiny(name, trace=True, seconds=0.2)
    cell = cell_of(name)
    # the CPU has no device trace: only the host spans' metrics are read
    host = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    assert set(res["metrics"]) == host
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["correct"], res["checks"]


def test_every_cell_has_its_metrics():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, each with a reader."""
    for name in CELLS:
        assert_has_its_metrics(cell_of(name))


def test_every_traffic_names_a_loop():
    """Each traffic file names its load loop, a module of ``loops/`` found
    by that name."""
    for path in sorted((harness.HERE / "traffic").glob("*.json")):
        loop = json.loads(path.read_text())["loop"]
        assert callable(harness.load_loop(loop).Loop), path.name


def test_a_loop_of_its_own(monkeypatch):
    """A traffic mix runs under the loop its file names: here a loop that
    wraps the closed loop and counts its windows."""
    import types

    from benchmark.loops import closed

    runs = []

    class Counted(closed.Loop):
        def run(self, *args, **kwargs):
            runs.append(args[0])
            return super().run(*args, **kwargs)

    mod = types.ModuleType("benchmark.loops.counted")
    mod.Loop = Counted
    monkeypatch.setitem(__import__("sys").modules, "benchmark.loops.counted", mod)
    res = run_tiny(CELLS[0], traffic={"loop": "counted"})
    assert res["correct"] and len(runs) == 2
