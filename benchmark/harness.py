"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, and the result line.

Nothing here knows a cell, a configuration, a traffic mix or a metric by
name: each is found by the names in ``BENCHMARK.json``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark.data.synth import subseed

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vettore_tpu")

#: the traced window's own label (``torch.profiler.record_function``)
WINDOW_LABEL = "bench.window"


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration and
    traffic read from their files, and the metrics it reports."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {bench_path.name}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}

    def layer_here(m):
        return name in m["workloads"] if "workloads" in m else m["moves"] in reported

    layer = [m for m in bench["per_layer"] if layer_here(m)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(kind: str, name: str):
    """The ``read(run)`` function of metric ``name`` (``kind`` is
    ``end_to_end`` or ``layer_metrics``)."""
    return _module(HERE / kind / f"{name}.py").read


# ---------------------------------------------------------------------------
# host spans
# ---------------------------------------------------------------------------

class Spans:
    """Host-clock time and calls per span name, around the calls into each
    layer; with ``labels`` on, each span is also a ``record_function``
    label of the profiler's trace."""

    def __init__(self):
        self.total: dict = {}
        self.count: dict = {}
        self.labels = False

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                if self.labels:
                    with torch.profiler.record_function(name):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
                self.count[name] = self.count.get(name, 0) + 1
        return timed

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()

    def snapshot(self) -> dict:
        """``{name: (seconds, calls)}``."""
        return {n: (self.total[n], self.count[n]) for n in self.total}


# ---------------------------------------------------------------------------
# the sample of answers
# ---------------------------------------------------------------------------

class Reservoir:
    """A uniform sample of ``size`` of the answers a window finished, drawn
    from the seed (reservoir sampling), each kept with its query's index in
    the pool."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, first: int, answers) -> None:
        m = len(answers)
        idx = np.arange(self.seen + 1, self.seen + m + 1)
        self.seen += m
        take = np.flatnonzero(idx <= self.size)
        for j in take:
            self.items.append((first + j, answers[j]))
        rest = idx > self.size
        if rest.any():
            r = self.rng.random(m)
            slot = self.rng.integers(0, self.size, m)
            for j in np.flatnonzero(rest & (r * idx < self.size)):
                self.items[slot[j]] = (first + j, answers[j])


# ---------------------------------------------------------------------------
# the record a metric reads
# ---------------------------------------------------------------------------

@dataclass
class Run:
    """What one run measured, as the metric readers see it."""
    shape: dict
    setup_s: float
    ingest_s: float | None
    window_s: float
    answered: int
    latencies_s: np.ndarray
    spans: dict
    trace: dict | None = None
    counters: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# devices
# ---------------------------------------------------------------------------

def sync(devices) -> None:
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def cards_line(count: int) -> list:
    """Each used card's ``nvidia-smi`` name and power limit."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ["nvidia-smi: not available"] * count
    return out[:count]


def device_record(devices, peak: int) -> dict:
    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": len(set(devices)),
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cuda[0]), "count": len(cuda),
            "memory_peak_bytes": peak, "cards": cards_line(len(cuda))}


def forbidden_modules() -> list:
    """The loaded top-level modules named in ``FORBIDDEN``, by whole name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# the window's pauses
# ---------------------------------------------------------------------------

class GcClock:
    """Counts the interpreter's full (generation 2) collections and their
    seconds while it is on: a pause of the whole process that the host
    clock's metrics include."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.count += 1
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def load_system(name: str):
    return importlib.import_module(f"benchmark.systems.{name}")


def load_loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")


def load_reference(name: str):
    return importlib.import_module(f"benchmark.reference.{name}")


def judge(config, traffic, answer_rows, system, reservoir: Reservoir, pool: np.ndarray, log):
    """The readings of the sampled answers against the plain reference, and
    each check's ``(value, limit, passed)``."""
    ref = load_reference(config["reference"])
    k = int(traffic["limit"])
    items = sorted(reservoir.items, key=lambda it: it[0])
    rows, scores, qidx = [], [], []
    for i, ans in items:
        r, s = answer_rows(ans)
        if len(r) == k:
            rows.append(r)
            scores.append(s)
            qidx.append(i)
    if not rows:
        return {}, {}, 0
    rows, scores = np.stack(rows).astype(np.int64), np.stack(scores).astype(np.float64)
    queries = pool[np.array(qidx)]
    blocks, device = system.reference_blocks()
    t0 = time.perf_counter()
    truth_rows, truth_scores = ref.top_k(blocks, queries, k, device=device)
    exact = ref.scores_of(blocks, queries, rows)
    readings = ref.numbers(rows, scores, truth_rows, truth_scores, exact)
    log(f"reference over {len(qidx)} sampled answers: {time.perf_counter() - t0:.1f}s")
    checks = {}
    for name, lim in config["checks"].items():
        v = readings[name]
        if "max" in lim:
            checks[name] = (v, f"<= {lim['max']}", v <= lim["max"])
        else:
            checks[name] = (v, f">= {lim['min']}", v >= lim["min"])
    return readings, checks, len(qidx)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, devices, t_start: float,
             log, overrides: dict | None = None, control: bool = False, fault=None) -> dict:
    """One run of ``cell``; returns the result line as a dict.

    ``devices`` are the torch devices the cell may use (``chips`` of them).
    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces keys of
    the configuration and traffic, for runs at a small size. ``control``
    puts the reference, in the precision below the configuration's, in the
    program's place. ``fault`` is called with the system after set-up and
    may break its timed path."""
    overrides = overrides or {}
    config = {**cell.config, **overrides.get("config", {})}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    spans = Spans()
    mod = load_system(config["system"])
    system = mod.System(config, traffic, devices, spans, log)
    system.prepare(seed)
    ingest_s = None
    if control:
        from benchmark.control import Control

        sut = Control(system, config, traffic)
    else:
        ingest_s = system.ingest()
        sut = system
    if fault is not None:
        fault(system)
    pool = system.queries
    loop = load_loop(traffic["loop"]).Loop(sut, pool, traffic, log)
    loop.run(float(traffic["warm_seconds"]), min_calls=2)
    sync(devices)
    gc.collect()
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    reservoir = Reservoir(int(traffic["sample"]), subseed(seed, 7))
    spans.reset()
    with GcClock() as gc_clock:
        window_s, calls, answered, failed, lat = loop.run(seconds, reservoir)
    span_totals = spans.snapshot()
    log(f"window {window_s:.3f}s: {calls} calls, {answered} queries answered, {failed} failed")

    trace_record = None
    if trace:
        from benchmark import tracing

        trace_record = tracing.traced_window(loop, spans, devices,
                                             min(seconds, float(traffic["trace_seconds"])), log)
    peak = max((torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)
                if d.type == "cuda"), default=0)
    counters = {**system.counters(), "gc_full": gc_clock.count, "gc_full_s": gc_clock.seconds}
    answer_rows = sut.answer_rows
    system.close()
    del sut
    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()

    readings, checks, judged = judge(config, traffic, answer_rows, system, reservoir, pool,
                                       log)
    run = Run(shape=system.shape(), setup_s=setup_s, ingest_s=ingest_s, window_s=window_s,
              answered=answered, latencies_s=lat, spans=span_totals,
              trace=trace_record, counters=counters)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader("layer_metrics" if trace else "end_to_end", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = device_record(devices, int(peak))
    result = {
        "correct": bool(judged and failed == 0 and all(c[2] for c in checks.values())),
        "attempted": answered + failed,
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if trace_record is not None:
        device["busy_s"] = trace_record["busy_s"]
        device["window_s"] = trace_record["window_s"]
        result["breakdown"] = trace_record["breakdown"]
    ends = np.cumsum(lat)
    result["info"] = {"seed": seed, "judged": judged, "readings": readings,
                      "counters": counters, "control": control,
                      "calls_per_second": np.bincount(ends.astype(int)).tolist(),
                      "latency_ms_quartiles": (1e3 * np.percentile(lat, [25, 50, 75, 99])).tolist()}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim, _ok) in
                        checks.items()}
    result["checks"]["failed"] = {"value": failed, "limit": "== 0"}
    result["checks"]["judged"] = {"value": judged, "limit": ">= 1"}
    return result
