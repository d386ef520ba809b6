"""Times K3 ``int8_gmin_scan`` and K6 ``fused_sign_scan`` on one CUDA card,
with and without their epilogues.

Both kernels run the int8 tensor-core mainloop of
``vettore_tpu_torch/csrc/s8_scan.cuh``. At N = 1,000,448 rows, d = 768 and
B = 512, 16 and 1 queries, the script prints the median ms (CUDA events,
around the Python wrapper) of each kernel, in turns, for two builds:

* ``full``: the package as it is;
* ``no-epilogue``: a copy of the package, built in its own directory under
  ``vettore_tpu_torch/_build/``, whose kernels skip the epilogue (the
  products still run, the outputs are left unwritten): the time of the
  mainloop alone, for the ablation in PERF.md.

The last line is a JSON summary. Run from the repository root on a machine
with a CUDA card:

    python3 tools/s8_scan_timing.py
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D, BATCHES = 1_000_448, 768, (512, 16, 1)
#: the epilogue call in the shared mainloop, and its ablated form
EPILOGUE = "if (inside) epi.template finish<QN>(acc, frame, pre);"
NO_EPILOGUE = "if (false) epi.template finish<QN>(acc, frame, pre);"


def measure(reps: int) -> dict:
    """Median ms of K3 (cosine) and K6 at every B, in this process."""
    import numpy as np
    import torch

    from vettore_tpu_torch.ops import flat_scan as fs

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((N, D), generator=gen, device=dev)
    x8, scale = fs.quantize_rows(x)
    xsq = (x * x).sum(dim=1)
    del x
    bias = torch.zeros(N, device=dev)
    signs = torch.where(torch.randn((N, D), generator=gen, device=dev) >= 0, 1, -1)
    signs = signs.to(torch.int8)
    valid8 = torch.ones(N, dtype=torch.int8, device=dev)
    out = {}
    for b in BATCHES:
        q = torch.randn((b, D), generator=gen, device=dev)
        q8, qscale = fs.quantize_rows(q)
        qsq = (q * q).sum(dim=1)
        qsigns = torch.where(q >= 0, 1, -1).to(torch.int8)
        args = (x8, scale, xsq, bias, q8, qscale, qsq)
        out[b] = {"k3": cuda_ms(lambda: fs.int8_gmin_scan(*args, metric="cosine")),
                  "k6": cuda_ms(lambda: fs.fused_sign_scan(signs, valid8, qsigns, d=D))}
    return out


def ablated_copy() -> Path:
    """A copy of the package whose kernels skip the epilogue."""
    dest = ROOT / "vettore_tpu_torch" / "_build" / "no_epilogue"
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "vettore_tpu_torch", dest / "vettore_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = dest / "vettore_tpu_torch" / "csrc" / "s8_scan.cuh"
    text = header.read_text()
    if EPILOGUE not in text:
        raise RuntimeError("the epilogue call in s8_scan.cuh has changed; update this script")
    header.write_text(text.replace(EPILOGUE, NO_EPILOGUE))
    return dest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:  # one build, in a child process
        print(json.dumps(measure(args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("s8_scan_timing: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    paths = {"full": ROOT, "no-epilogue": ablated_copy()}
    runs = []
    for variant in ("full", "no-epilogue", "no-epilogue", "full"):
        env = dict(os.environ, PYTHONPATH=str(paths[variant]))
        child = subprocess.run([sys.executable, __file__, "--measure", "--reps", str(args.reps)],
                               capture_output=True, text=True, env=env, check=True)
        res = json.loads(child.stdout.strip().splitlines()[-1])
        runs.append({"variant": variant, "ms": res})
        print(f"{variant}: " + " | ".join(
            f"B={b} K3 {t['k3']:.3f} K6 {t['k6']:.3f} ms" for b, t in res.items()) + f" [{smi}]",
            flush=True)
    print(json.dumps({"card": smi, "n": N, "d": D, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
