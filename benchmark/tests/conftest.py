"""Runs of the benchmark's cells at a tiny size on the CPU."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

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
    return over


def run_tiny(name: str, *, seconds: float = 0.3, trace: bool = False, seed: int = 2**31 + 7,
             traffic: dict | None = None, **kwargs) -> dict:
    """One run of cell ``name`` at the tiny size on CPU devices, with the
    traffic's keys in ``traffic`` replaced."""
    cell = cell_of(name)
    over = tiny(cell)
    over["traffic"].update(traffic or {})
    return harness.run_cell(cell, seed, seconds, trace, devices=[torch.device("cpu")] * cell.chips,
                            t_start=time.perf_counter(), log=lambda _m: None,
                            overrides=over, **kwargs)


@pytest.fixture
def gpu():
    """Skips a test that needs a CUDA card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
