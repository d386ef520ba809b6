"""Measures what the program's span and counter sites
(``vettore_tpu_torch/observability.py``) cost on this machine, and checks
that the profiler keeps them off the device timeline.

    python3 tools/span_cost.py [--json PATH]

Prints, as one JSON line: the torch version and the card's name and power
limit; the ns a span site (``with span(...)``) and a counter site cost with
no profiler recording; the µs a span costs while one records (CPU and CUDA
activities); and, from a CUDA workload inside a program span and inside a
``record_function`` range, the names of the events the profiler put on the
CUDA timeline: a program span must not be among them (a user annotation
is mirrored there). Without a CUDA card the last check is skipped.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from vettore_tpu_torch import observability as obs  # noqa: E402


def _per_op(fn, n: int) -> float:
    fn(n // 10)
    t0 = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t0) / n


def _spans(n):
    for _ in range(n):
        with obs.span("index.wait"):
            pass


def _counts(n):
    for _ in range(n):
        obs.count("hnsw.steps")


def _empty(n):
    for _ in range(n):
        pass


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", help="also write the result to this file")
    args = p.parse_args(argv)
    cuda = torch.cuda.is_available()
    loop = _per_op(_empty, 1_000_000)
    out = {"torch": torch.__version__, "cuda": torch.version.cuda, "card": card(),
           "off_span_ns": 1e9 * (_per_op(_spans, 1_000_000) - loop),
           "off_count_ns": 1e9 * (_per_op(_counts, 1_000_000) - loop)}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities):
        out["on_span_us"] = 1e6 * (_per_op(_spans, 100_000) - loop)
        out["on_count_us"] = 1e6 * (_per_op(_counts, 100_000) - loop)
    if cuda:
        x = torch.ones(1 << 22, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with obs.span("index.wait"):
                (x * 2).sum().item()
            with record_function("user.range"):
                (x * 3).sum().item()
            torch.cuda.synchronize()
        timeline = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
        out["cuda_timeline"] = timeline
        out["span_on_cuda_timeline"] = any(name in obs.SPANS for name in timeline)
        out["user_range_on_cuda_timeline"] = "user.range" in timeline
    line = json.dumps(out)
    print(line)
    if args.json:
        Path(args.json).write_text(line + "\n")
    return 1 if out.get("span_on_cuda_timeline") else 0


if __name__ == "__main__":
    sys.exit(main())
