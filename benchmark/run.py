"""Runs one cell of ``BENCHMARK.json`` and prints its result as the last
line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the cell's number of
CUDA devices; exits non-zero, printing no result, without them, without
the program beside the benchmark, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: kernel and compile caches, at fixed paths inside the checkout
CACHE = ROOT / ".bench_cache"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def set_environment() -> None:
    """Caches inside the checkout; the repository root importable, and this
    directory not (its modules would shadow others of the same name)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    sys.path.insert(0, str(ROOT))


def devices_for(cell) -> list:
    import torch

    return [torch.device("cuda", i) for i in range(cell.chips)]


def free(devices) -> None:
    import torch

    gc.collect()
    if any(d.type == "cuda" for d in devices):
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Runs one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    if importlib.util.find_spec("vettore_tpu_torch") is None:
        log("the program (vettore_tpu_torch) is not beside the benchmark: nothing to run")
        return 2
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              devices=devices_for(cell), t_start=T_START, log=log)
    loaded = harness.forbidden_modules()
    if loaded:
        log(f"forbidden modules loaded in this process: {loaded}")
        return 3
    log(f"correct {result['correct']}; metrics {json.dumps(result['metrics'])}")
    for name, check in result["checks"].items():
        log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
