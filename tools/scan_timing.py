"""Times the tensor-core scans on one CUDA card, whole and with their
epilogues or their products cut out: K1 ``gmin_scan`` (f32 and bf16
blocks, cosine and l2), K3 ``int8_gmin_scan`` (cosine) and K6
``fused_sign_scan``.

All of them run the TMA / ``wgmma`` scan skeleton of
``vettore_tpu_torch/csrc/wgmma_scan.cuh``. At N = 1,000,448 rows, d = 768
and B = 512, 16 and 1 queries, the script prints the median ms (CUDA
events, around the Python wrapper) of each kernel, for these builds, each
in a child process of its own, in turns:

* ``full``: the package as it is;
* ``no-epilogue``: a copy of the package, built in its own directory under
  ``vettore_tpu_torch/_build/``, whose kernels skip the epilogue (the
  outputs are left unwritten): the time of the mainloop alone. The
  accumulators still feed a minimum that is stored only if it hits a
  sentinel, so that their products stay;
* ``ring-only``: the epilogue call removed outright. With no reader of
  the accumulators ptxas deletes every ``wgmma`` too, so this times the
  TMA ring, the barriers and the tile walk alone: how long the operands
  take to reach shared memory;
* ``parent`` (with ``--parent DIR``): the package of another checkout, for
  example the parent commit unpacked with ``git archive`` into a directory
  that ``.gitignore`` lists; timed whole, first and last.

``--pairs P`` (with ``--parent``) times only ``full`` and ``parent``, in P
pairs whose order alternates (parent, full, full, parent, ...), and prints
each kernel's median and range over the runs of each. ``--kernels`` picks
the kernels (``k1``, ``k3``, ``k6``; all by default). The last line is a
JSON summary. Run from the repository root on a machine with a CUDA card:

    python3 tools/scan_timing.py [--parent DIR [--pairs P]] [--kernels k3,k6]
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
#: the epilogue call in the shared scan skeleton, and what each ablated
#: build puts in its place
EPILOGUE = "if (inside) epi.template finish<QN>(acc, frame, pre);"
ABLATIONS = {
    "no-epilogue": """if (inside) {
        Acc sink = acc[0];
#pragma unroll
        for (int i = 1; i < QN / 2; ++i) sink = min2(sink, acc[i]);
        if (sink == Acc(12345)) frame.side[0] = 0.f;
      }""",
    "ring-only": "if (false) epi.template finish<QN>(acc, frame, pre);",
}


def measure(reps: int, kernels: set) -> dict:
    """Median ms of each of ``kernels`` at every B, in this process."""
    import numpy as np
    import torch

    from vettore_tpu_torch.ops import flat_scan as fs

    torch.backends.cuda.matmul.allow_tf32 = False

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
    x /= x.norm(dim=1, keepdim=True)
    xsq = (x * x).sum(dim=1)
    xb = x.to(torch.bfloat16)
    xbsq = (xb.float() ** 2).sum(dim=1)
    x8, scale = fs.quantize_rows(x)
    bias = torch.zeros(N, device=dev)
    signs = torch.where(torch.randn((N, D), generator=gen, device=dev) >= 0, 1, -1)
    signs = signs.to(torch.int8)
    valid8 = torch.ones(N, dtype=torch.int8, device=dev)
    out = {}
    for b in BATCHES:
        q = torch.randn((b, D), generator=gen, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        q8, qscale = fs.quantize_rows(q)
        qsq = (q * q).sum(dim=1)
        qsigns = torch.where(q >= 0, 1, -1).to(torch.int8)
        args = (x8, scale, xsq, bias, q8, qscale, qsq)
        # K3 and K6 first: timed right after K1's f32 runs they come out
        # ~10-15% slower than when they run first
        t = {}
        if "k3" in kernels:
            t["k3"] = cuda_ms(lambda: fs.int8_gmin_scan(*args, metric="cosine"))
        if "k6" in kernels:
            t["k6"] = cuda_ms(lambda: fs.fused_sign_scan(signs, valid8, qsigns, d=D))
        for storage, xs, xss in (("f32", x, xsq), ("bf16", xb, xbsq)):
            for metric in ("cosine", "l2") if "k1" in kernels else ():
                t[f"k1_{storage}_{metric}"] = cuda_ms(
                    lambda: fs.gmin_scan(xs, xss, bias, q, metric=metric))
        out[b] = t
    return out


def ablated_copy(name: str) -> Path:
    """A copy of the package whose kernels run ``ABLATIONS[name]`` in place
    of the epilogue."""
    dest = ROOT / "vettore_tpu_torch" / "_build" / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "vettore_tpu_torch", dest / "vettore_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = dest / "vettore_tpu_torch" / "csrc" / "wgmma_scan.cuh"
    text = header.read_text()
    if EPILOGUE not in text:
        raise RuntimeError("the epilogue call in wgmma_scan.cuh has changed; update this script")
    header.write_text(text.replace(EPILOGUE, ABLATIONS[name]))
    return dest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose package is timed whole")
    ap.add_argument("--pairs", type=int, default=0,
                    help="with --parent: time only it and this package, in this many pairs")
    ap.add_argument("--kernels", default="k1,k3,k6", help="comma-separated: k1, k3, k6")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= {"k1", "k3", "k6"} or (args.pairs and args.parent is None):
        ap.error("--kernels takes k1, k3, k6; --pairs needs --parent")
    if args.measure:  # one build, in a child process
        print(json.dumps(measure(args.reps, kernels)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("scan_timing: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.pairs:
        paths = {"full": ROOT, "parent": args.parent.resolve()}
        order = [v for i in range(args.pairs)
                 for v in (("parent", "full") if i % 2 == 0 else ("full", "parent"))]
    else:
        paths = {"full": ROOT, **{name: ablated_copy(name) for name in ABLATIONS}}
        order = ["full", *ABLATIONS, *reversed(ABLATIONS), "full"]
        if args.parent is not None:
            paths["parent"] = args.parent.resolve()
            order = ["parent", *order, "parent"]
    runs = []
    for variant in order:
        env = dict(os.environ, PYTHONPATH=str(paths[variant]))
        child = subprocess.run([sys.executable, __file__, "--measure", "--reps", str(args.reps),
                                "--kernels", args.kernels],
                               capture_output=True, text=True, env=env, check=False)
        if child.returncode:
            print(child.stderr, file=sys.stderr)
            raise RuntimeError(f"the {variant} run failed (exit {child.returncode})")
        res = json.loads(child.stdout.strip().splitlines()[-1])
        runs.append({"variant": variant, "ms": res})
        for b, t in res.items():
            print(f"{variant} B={b}: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
                  + f" ms [{smi}]", flush=True)
    for variant in dict.fromkeys(order):
        for b, t in runs[order.index(variant)]["ms"].items():
            for k in t:
                ms = sorted(r["ms"][b][k] for r in runs if r["variant"] == variant)
                print(f"{variant} B={b} {k}: median {ms[len(ms) // 2]:.3f} ms, "
                      f"{ms[0]:.3f}-{ms[-1]:.3f} over {len(ms)} runs [{smi}]", flush=True)
    print(json.dumps({"card": smi, "n": N, "d": D, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
