"""Traces one cell of ``BENCHMARK.json`` with the program's own tracer and
puts the card's idle time down to the innermost program span.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s> --out <dir>

Sets the cell up as ``benchmark/run.py`` does (inputs from the seed, ingest,
warm-up), then runs its loop for ``--seconds`` under
``vettore_tpu_torch.observability.trace(out)``, which writes a Chrome trace
into ``out``. From that trace: the union of device 0's kernels and copies,
its idle gaps between the first and the last call, and each gap's seconds
split by the innermost program span (``observability.SPANS``) open on the
host at each instant, "no span" where none is; and a call's launches: the
host's CUDA calls that enqueue work, by name, and the kernels the cards
ran. Prints one JSON line (also
written to ``out/idle_by_span.json``) with those seconds, the window, the
calls, and ``observability.snapshot()``'s sums of the session. Needs the
cell's number of CUDA cards.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: Chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: Chrome-trace categories of the host's CUDA API calls
API_CATS = ("cuda_runtime", "cuda_driver")


def innermost(spans) -> list:
    """``(start, end, name)`` pieces of time, each under one innermost span,
    from the (properly nested, one thread's) ``spans`` ``(start, end,
    name)``."""
    edges = sorted([(s, 1, -(e - s), name) for s, e, name in spans]
                   + [(e, 0, 0.0, name) for s, e, name in spans])
    out, stack, at = [], [], None
    for t, opening, _neg_len, name in edges:
        if stack and at is not None and t > at:
            out.append((at, t, stack[-1]))
        if opening:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
        at = t
    return out


def idle_by_span(events, card: int = 0) -> dict:
    """Device ``card``'s idle seconds between the first and the last root
    span, by the innermost program span open on the host."""
    from benchmark.tracing import gaps, union
    from vettore_tpu_torch.observability import SPANS

    names = set(SPANS)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e.get("name") in names]
    tids = {e["tid"] for e in events if e.get("ph") == "X" and e.get("name") in names}
    roots = [(s, e) for s, e, n in spans
             if n.startswith(("collection.search", "collection.hybrid_search",
                              "collection.quantized_search", "collection.funnel_search",
                              "mesh.search"))]
    if not roots:
        return {}
    lo, hi = min(s for s, _ in roots), max(e for _, e in roots)
    busy = union([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and e.get("args", {}).get("device", card) == card
                  and e["ts"] < hi and e["ts"] + e["dur"] > lo])
    pieces = innermost(spans)
    idle: dict = {}
    j = 0
    for g0, g1 in gaps(busy, lo, hi):
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            s, e, name = pieces[k]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part / 1e6
                covered += part
            k += 1
        rest = (g1 - g0) - covered
        if rest > 0:
            idle["no span"] = idle.get("no span", 0.0) + rest / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "host_threads": len(tids)}


def launches(events, calls: int) -> dict:
    """A call's means over the window: the host's CUDA calls that put work
    on a card (kernel and graph launches, copies, memsets; by API name) and
    the kernels the cards ran, graph replays' kernels included."""
    host: dict = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") in API_CATS
                and any(w in e["name"] for w in ("Launch", "Memcpy", "Memset"))):
            host[e["name"]] = host.get(e["name"], 0) + 1
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    per = max(calls, 1)
    return {"host_calls": {k: v / per for k, v in sorted(host.items())},
            "device_kernels": kernels / per}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    from benchmark.run import devices_for, log, set_environment

    set_environment()
    import torch

    from benchmark import harness
    from vettore_tpu_torch import observability

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s)")
        return 2
    devices = devices_for(cell)
    system = harness.load_system(cell.config["system"]).System(
        cell.config, cell.traffic, devices, harness.Spans(), log)
    system.prepare(args.seed)
    system.ingest()
    loop = harness.load_loop(cell.traffic["loop"]).Loop(system, system.queries, cell.traffic, log)
    loop.run(float(cell.traffic["warm_seconds"]), min_calls=2)
    harness.sync(devices)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out / "*.pt.trace.json")):
        Path(old).unlink()
    log(f"set up in {time.perf_counter() - t_start:.1f}s; tracing {args.seconds}s")
    with observability.trace(str(out)):
        _s, calls, _a, failed, _lat = loop.run(args.seconds)
        harness.sync(devices)
    snap = observability.snapshot()
    system.close()
    (path,) = glob.glob(str(out / "*.pt.trace.json"))
    events = json.loads(Path(path).read_text())["traceEvents"]
    record = {"workload": cell.name, "seed": args.seed, "calls": calls, "failed": failed,
              "cards": harness.cards_line(cell.chips), **idle_by_span(events),
              "launches": launches(events, calls), "snapshot": snap}
    line = json.dumps(record)
    (out / "idle_by_span.json").write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
