"""Runs of the benchmark's cells at a tiny size on the CPU."""

from __future__ import annotations

import importlib.util
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

#: the runs here are tiny, and their windows 0.3 s: with a thread a core, a
#: host busy with other work stalled a window to one or two calls, short of
#: the answers a test judges
torch.set_num_threads(1)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def cell_of(name: str) -> harness.Cell:
    return harness.load_cell(name)


#: a few thousand rows of width 32 on the CPU, batches of 16
TINY = {"config": {"rows": 4096, "dims": 32, "chunk_rows": 1500},
        "traffic": {"pool": 256, "sample": 48, "warm_seconds": 0.1}}


def tiny(cell) -> dict:
    over = json.loads(json.dumps(TINY))
    if cell.chips > 1:
        over["config"]["rows"] = cell.chips * 2048
    if cell.config.get("index") == "hnsw":
        # below the bulk build's threshold: host inserts, served by the beam
        over["config"].update(rows=2100, dims=64)
        over["config"]["index_options"] = dict(cell.config["index_options"], ef_search=128)
        # a host-inserted graph of 2,100 rows, not the configuration's bulk
        # build: its recall here reads 0.91-0.98, so this size holds it to 0.85
        over["config"]["checks"] = dict(cell.config["checks"], recall={"min": 0.85})
    over["traffic"]["batch"] = min(16, cell.traffic["batch"])
    # the configuration's own tiny size, where it states one, over the rules above
    own = cell.config.get("tiny", {})
    for part in ("config", "traffic"):
        over[part].update(own.get(part, {}))
    return over


def run_tiny(name: str, *, seconds: float = 0.3, trace: bool = False, seed: int = 2**31 + 7,
             traffic: dict | None = None, cell: harness.Cell | None = None, **kwargs) -> dict:
    """One run of cell ``name`` (or of ``cell``, where given) at the tiny
    size on CPU devices, with the traffic's keys in ``traffic`` replaced."""
    cell = cell or cell_of(name)
    over = tiny(cell)
    over["traffic"].update(traffic or {})
    return harness.run_cell(cell, seed, seconds, trace, devices=[torch.device("cpu")] * cell.chips,
                            t_start=time.perf_counter(), log=lambda _m: None,
                            overrides=over, **kwargs)


def assert_has_its_metrics(cell: harness.Cell) -> None:
    """``cell`` reports setup_s, another end-to-end metric and a per-layer
    metric, each with a reader."""
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer, cell.name
    for m in cell.end_to_end:
        assert callable(harness.reader("end_to_end", m["name"]))
    for m in cell.per_layer:
        assert callable(harness.reader("layer_metrics", m["name"]))


#: the faults every system gives
REQUIRED_FAULTS = ("stale", "half", "altered")


def faults_of(system: str) -> dict:
    """``{fault: (fn, {check: least})}`` of ``benchmark/faults/<system>.py``."""
    mod = importlib.import_module(f"benchmark.faults.{system}")
    return {name: f if isinstance(f, tuple) else (f, {}) for name, f in mod.FAULTS.items()}


def systems_of(bench_path: Path) -> set:
    """The ``system`` of every configuration of the ``BENCHMARK.json`` at
    ``bench_path``."""
    bench = json.loads(bench_path.read_text())
    return {json.loads((harness.ROOT / c["file"]).read_text())["system"]
            for c in bench["configs"]}


# ---------------------------------------------------------------------------
# a new cell, made of new files only
# ---------------------------------------------------------------------------

#: the files of a new cell, laid out as in ``benchmark/``
NEW_CELL = Path(__file__).resolve().parent / "new_cell"

#: the directories of ``new_cell/`` whose modules are imported by name (the
#: harness loads the readers from their files)
MODULE_DIRS = ("systems", "faults", "reference")

#: what the new cell adds to ``BENCHMARK.json``: entries, and its name on
#: the ``workloads`` list of each end-to-end metric it reports
NEW_ENTRIES = {
    "configs": [{"name": "toy-hybrid", "source": "BASELINE.json config 5 in miniature",
                 "file": "benchmark/configs/toy-hybrid.json", "reduced": [],
                 "why": "a primary row and a token set a query, MaxSim, an MMR reorder"}],
    "workloads": [{"name": "toy.batch512", "config": "toy-hybrid", "traffic": "batch512",
                   "chips": 1, "why": "query sets of 1 + 4 rows, 30 hits, the first 10 by MMR"}],
    "per_layer": [{"name": "toy_rerank_ms.batch", "unit": "ms", "better": "lower",
                   "source": "program_span", "layer": "toy rerank", "moves": "qps",
                   "workloads": ["toy.batch512"]}],
    "append": {"qps": ["toy.batch512"]},
}


@pytest.fixture
def new_cell(tmp_path, monkeypatch):
    """A checkout in ``tmp_path`` that holds the repository's benchmark and
    ``BENCHMARK.json`` with the files of ``new_cell/`` added and the
    entries of ``NEW_ENTRIES``; the harness reads from it, and each module
    of ``new_cell/`` is importable under its ``benchmark.<dir>.<name>``.
    Returns ``(cell, bench_path)``."""
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(NEW_CELL, here, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        bench[key] += NEW_ENTRIES[key]
    for m in bench["end_to_end"]:
        if m["name"] in NEW_ENTRIES["append"]:
            m["workloads"] = m["workloads"] + NEW_ENTRIES["append"][m["name"]]
    bench_path = tmp_path / "BENCHMARK.json"
    bench_path.write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", here)
    for path in sorted(p for d in MODULE_DIRS for p in (NEW_CELL / d).glob("*.py")):
        name = f"benchmark.{path.parent.name}.{path.stem}"
        spec = importlib.util.spec_from_file_location(name, here / path.relative_to(NEW_CELL))
        mod = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, name, mod)
        spec.loader.exec_module(mod)
    name = NEW_ENTRIES["workloads"][0]["name"]
    return harness.load_cell(name, bench_path=bench_path), bench_path


@pytest.fixture
def gpu():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
