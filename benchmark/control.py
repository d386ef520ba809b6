"""The control: the plain reference put in the program's place, computed in
the precision below the one the configuration states, so that the checks
can be shown to fail it.

The configurations state float32 with TF32 off (exact products), so the
control scores in single-pass TF32. ``python3 benchmark/control.py
--workload <cell> --seeds <a,b,..> --control-seeds <c,d,..> --seconds <s>``
reads, in one process, the checks' readings of the program on each seed
and of the control on each control seed, at the cell's own size and load,
and prints them as one JSON line: the readings the limits are set from.
"""

from __future__ import annotations

import numpy as np


class Control:
    """Answers a call as the reference does (``top_k``), in TF32 over the
    system's own inputs; its answers are ``(rows, scores)``."""

    def __init__(self, system, config, traffic):
        from benchmark.harness import load_reference

        self.ref = load_reference(config["reference"])
        blocks, device = system.reference_blocks()
        # the inputs on the device once, as the program holds its block
        self.blocks = [(first, x.to(device) if device is not None else x)
                       for first, x in blocks]
        self.device = None
        self.k = int(traffic["limit"])

    def call(self, qs: np.ndarray) -> list:
        rows, scores = self.ref.top_k(self.blocks, qs, self.k, precision="tf32",
                                      device=self.device)
        return list(zip(rows, scores))

    @staticmethod
    def count_bad(out, b: int, limit: int) -> int:
        return sum(len(r) != limit for r, _s in out) + max(0, b - len(out))

    @staticmethod
    def answer_rows(answer):
        return answer


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time

    from benchmark import run as bench_run

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    devices = bench_run.devices_for(cell)
    out = {"workload": cell.name, "program": {}, "control": {}}
    for key, seeds, control in (("program", args.seeds, False),
                                ("control", args.control_seeds, True)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            res = harness.run_cell(cell, seed, args.seconds, False, devices=devices,
                                   t_start=t0, log=bench_run.log, control=control)
            out[key][seed] = {"correct": res["correct"], **res["info"]["readings"],
                              "judged": res["info"]["judged"], "failed": res["failed"],
                              "counters": res["info"]["counters"]}
            bench_run.log(f"{key} seed {seed}: {json.dumps(out[key][seed])} "
                          f"({time.perf_counter() - t0:.1f}s)")
            bench_run.free(devices)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    raise SystemExit(main())
