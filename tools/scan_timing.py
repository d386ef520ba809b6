"""Times the tensor-core scans on one CUDA card, whole and with their
epilogues or their products cut out: K1 ``gmin_scan`` (f32 and bf16
blocks, cosine and l2), K3 ``int8_gmin_scan`` (cosine), K5
``stage_gmin_scan`` (f32 and bf16 blocks, cosine, dims = 128), K6
``fused_sign_scan`` and the MaxSim ``maxsim_rank_scan`` (cosine); and the
two rescores, K2 ``rescore`` (f32 and bf16 blocks) and K4
``int8_rescore`` (cosine), on the groups that ``select.group_topk`` picks
from K1's group minima at gsel = 18 (the flat search's at limit 10), and
the K7 gather ``extract_group_rows`` at the funnel's and the quantized
mode's shapes (the rows of K5's f32 ranks that ``group_topk`` picks from
K5's group minima at 200 + ``GROUP_SLACK`` groups, and of K6's int16
Hamming distances at 500 groups), whole only: the ablation and
``--phases`` builds cut the scan skeleton, which these do not run. Beside
each one's time around its wrapper, ``torch.profiler`` gives its kernel's
device time (``_kernel``) and all the device time of one call
(``_device``: with the sort and the query norms); the rest of the
wrapper's time is host work. Where the package's
plan may sort the pairs by group (B = 512), ``_sorted`` and ``_unsorted``
time the same call with the sort forced on and off: what reading a
shared group once saves.

All of them run the TMA / ``wgmma`` scan skeleton of
``vettore_tpu_torch/csrc/wgmma_scan.cuh``. At N = 1,000,448 rows, d = 768
and B = 512, 16 and 1 queries (MaxSim at BASELINE config 5's shape:
100,352 docs of 32 tokens, d = 128, 64 sets of 4 tokens, bf16 and f32
blocks, the token norms given as the scan cache keeps them), the script
prints the median ms (CUDA events, around the Python wrapper) of each
kernel, for these builds, each in a child process of its own, in turns:

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
each kernel's median and range over the runs of each. ``--phases`` runs
one call of each kernel in a copy of the package whose consumer
warpgroups count ``clock64()`` cycles (thread 0 of each, summed over
tiles with atomics), and prints per tile and warpgroup the cycles spent
waiting for ring stages, on the products, and in the epilogue. ``--kernels`` picks
the kernels (``k1``, ``k2``, ``k3``, ``k4``, ``k5``, ``k6``, ``k7``,
``maxsim``; all by default); with only whole-only kernels and no
``--parent``, ``full`` runs alone.
The last line is a JSON summary. Run from the repository root on a machine
with a CUDA card:

    python3 tools/scan_timing.py [--parent DIR [--pairs P]] [--kernels k5,maxsim]
    python3 tools/scan_timing.py --parent DIR --pairs 5 --kernels k2,k4
    python3 tools/scan_timing.py --kernels k7
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, D, BATCHES = 1_000_448, 768, (512, 16, 1)
KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "maxsim")
#: the rescores and the gather: whole builds only (no scan skeleton to cut)
WHOLE = {"k2", "k4", "k7"}
#: groups per query the rescores take: limit 10 + GROUP_SLACK
GSEL = 18
#: K7's groups per query: the funnel's (candidates 200 + GROUP_SLACK) and
#: the quantized mode's (candidates 500)
K7_GROUPS = {"funnel": 208, "quantized": 500}
#: K5's prefix; the MaxSim shape: docs, tokens per doc, d, sets, tokens per set
DIMS = 128
MV_N, MV_T, MV_D, MV_B, MV_Q = 100_352, 32, 128, 64, 4
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
#: the ``--phases`` build: cycle counters around the consumers' phases
PHASES = (
    ("namespace {\nnamespace wg {\n",
     "namespace {\nnamespace wg {\n__device__ unsigned long long phases[4];\n"),
    ("      fence_acc(acc);\n      int prev = s;\n",
     "      fence_acc(acc);\n      long long c0 = clock64(), cw = 0;\n      int prev = s;\n"),
    ("        mbar_wait(&full[s], ph);\n",
     "        const long long w0 = clock64();\n        mbar_wait(&full[s], ph);\n"
     "        cw += clock64() - w0;\n"),
    ("      " + EPILOGUE + "\n",
     "      const long long c1 = clock64();\n      " + EPILOGUE + "\n"
     "      if (t == 0) {\n        atomicAdd(&phases[0], (unsigned long long)cw);\n"
     "        atomicAdd(&phases[1], (unsigned long long)(c1 - c0 - cw));\n"
     "        atomicAdd(&phases[2], (unsigned long long)(clock64() - c1));\n"
     "        atomicAdd(&phases[3], 1ull);\n      }\n"),
)
#: the source whose counters each kernel's launches add to
SOURCES = {"k1": "flat_scan", "k3": "int8_scan", "k5": "adaptive_scan", "k6": "adaptive_scan",
           "maxsim": "maxsim"}


def measure(reps: int, kernels: set, phases: bool) -> dict:
    """Median ms of each of ``kernels`` at every B, in this process; with
    ``phases`` (in the ``--phases`` build), cycles per tile and warpgroup
    [ring wait, products, epilogue] of one call instead."""
    import ctypes

    import numpy as np
    import torch

    from vettore_tpu_torch import _build
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops import select

    torch.backends.cuda.matmul.allow_tf32 = False

    def counted(fn, src):
        read = getattr(_build.load(), f"vt_phases_{src}")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        counts = (ctypes.c_ulonglong * 4)()
        fn()
        torch.cuda.synchronize()
        read(counts, 1)
        fn()
        torch.cuda.synchronize()
        read(counts, 1)
        return [counts[i] / max(1, counts[3]) for i in range(3)]

    def cuda_ms(fn, src):
        if phases:
            return counted(fn, src)
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

    def device_ms(fn, key="rescore", reps=10):
        """Device ms per call of ``fn`` (``torch.profiler``): its kernel's
        own (the events whose name holds ``key``), and every kernel's (the
        rest is the sort, the query norms and the like); the wrapper's time
        beside them is host work."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
        kernel = sum(e.self_device_time_total for e in events if key in e.key.lower())
        return kernel / 1e3 / reps, sum(e.self_device_time_total for e in events) / 1e3 / reps

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
            t["k3"] = cuda_ms(lambda: fs.int8_gmin_scan(*args, metric="cosine"), "int8_scan")
        if "k6" in kernels:
            t["k6"] = cuda_ms(lambda: fs.fused_sign_scan(signs, valid8, qsigns, d=D),
                              "adaptive_scan")
        for storage, xs, xss in (("f32", x, xsq), ("bf16", xb, xbsq)):
            for metric in ("cosine", "l2") if "k1" in kernels else ():
                t[f"k1_{storage}_{metric}"] = cuda_ms(
                    lambda: fs.gmin_scan(xs, xss, bias, q, metric=metric), "flat_scan")
            if "k5" in kernels:
                x5sq = (xs[:, :DIMS].float() ** 2).sum(dim=1)
                t[f"k5_{storage}"] = cuda_ms(
                    lambda: fs.stage_gmin_scan(xs, x5sq, bias, q, metric="cosine", dims=DIMS),
                    "adaptive_scan")
        if "k7" in kernels:
            # gathers of real K5 and K6 outputs, as the funnel and the
            # quantized mode make them
            x5sq = (x[:, :DIMS] ** 2).sum(dim=1)
            gmin5, rank5, _bounded = fs.stage_gmin_scan(x, x5sq, bias, q, metric="cosine",
                                                        dims=DIMS)
            gmin6, ham6 = fs.fused_sign_scan(signs, valid8, qsigns, d=D)
            for mode, gmin, mat in (("funnel", gmin5, rank5), ("quantized", gmin6, ham6)):
                gidx = select.group_topk(gmin, K7_GROUPS[mode])[1].int()
                mat = mat.view(b, N // fs.GROUP, fs.GROUP)
                fn = (lambda mat=mat, gidx=gidx: fs.extract_group_rows(mat, gidx))
                t[f"k7_{mode}"] = cuda_ms(fn, None)
                t[f"k7_{mode}_kernel"], t[f"k7_{mode}_device"] = device_ms(fn, "extract_rows")
            del gmin5, rank5, gmin6, ham6, gidx, mat, fn
        if kernels & (WHOLE - {"k7"}):
            gmin, _bounded = fs.gmin_scan(x, xsq, bias, q, metric="cosine")
            gidx = select.group_topk(gmin, GSEL, check_c=GSEL - fs.GROUP_SLACK)[1].int()
            del gmin
            pairs, groups = gidx.numel(), int(gidx.unique().numel())
            print(f"K2/K4 at B={b}: P {pairs}, distinct groups {groups}, sharing "
                  f"{pairs / groups:.2f}", flush=True)
            calls = {}
            if "k2" in kernels:
                for storage, xs, xss in (("f32", x, xsq), ("bf16", xb, xbsq)):
                    calls[f"k2_{storage}"] = (lambda xs=xs, xss=xss: fs.rescore(
                        xs, xss, bias, q, gidx, metric="cosine"))
            if "k4" in kernels:
                calls["k4"] = lambda: fs.int8_rescore(x8, scale, xsq, bias, q, gidx,
                                                      metric="cosine")
            # a package with a group-major plan, at a pair count where it may sort
            if hasattr(fs, "_rescore_plan") and not phases \
                    and gidx.numel() > 4 * fs._sm_count(dev.index):
                for name, fn in list(calls.items()):
                    calls[f"{name}_sorted"] = forced(fn, fs, True)
                    calls[f"{name}_unsorted"] = forced(fn, fs, False)
            for name, fn in calls.items():
                t[name] = cuda_ms(fn, None)
                if not phases:
                    t[f"{name}_kernel"], t[f"{name}_device"] = device_ms(fn)
        out[b] = t
    if "maxsim" in kernels:
        qt = torch.randn((MV_B * MV_Q, MV_D), generator=gen, device=dev)
        qt /= qt.norm(dim=1, keepdim=True)
        qinv = 1.0 / qt.norm(dim=1)
        counts = torch.full((MV_N,), MV_T, dtype=torch.int32, device=dev)
        dbias = torch.zeros(MV_N, device=dev)
        # the cached token norms where the package takes them
        given = "tinv" in inspect.signature(ms.maxsim_rank_scan).parameters
        t = {}
        for storage in ("bf16", "f32"):
            tokens = torch.randn((MV_N, MV_T, MV_D), generator=gen, device=dev)
            tokens = tokens.to(torch.bfloat16 if storage == "bf16" else torch.float32)
            extra = {"tinv": ms.token_norms(tokens)[1]} if given else {}
            t[f"maxsim_{storage}"] = cuda_ms(lambda: ms.maxsim_rank_scan(
                tokens, counts, dbias, qt, qinv, b=MV_B, metric="cosine", **extra), "maxsim")
            del tokens, extra
        out[f"{MV_B}x{MV_Q}"] = t
    return out


def forced(fn, fs, sort):
    """``fn`` with the rescore plan's sort forced on (``sort``: a shared
    group is staged once per window) or off (the kernel walks the pairs in
    their own order, and stages a group once per run of equal groups that
    this order happens to give)."""
    import torch

    def plan(gidx, n, *, d, elt, sms):
        groups, pairs = (torch.sort(gidx.reshape(-1), stable=True) if sort
                         else (gidx.reshape(-1), None))
        return groups, pairs, fs._rescore_geometry(gidx.numel(), d, elt, sms)

    def run():
        sorted_plan, fs._rescore_plan = fs._rescore_plan, plan
        try:
            return fn()
        finally:
            fs._rescore_plan = sorted_plan

    return run


def ablated_copy(name: str) -> Path:
    """A copy of the package whose kernels run ``ABLATIONS[name]`` in place
    of the epilogue, or, for "phases", count the cycles of their phases."""
    dest = ROOT / "vettore_tpu_torch" / "_build" / name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(ROOT / "vettore_tpu_torch", dest / "vettore_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = dest / "vettore_tpu_torch" / "csrc"
    header = csrc / "wgmma_scan.cuh"
    text = header.read_text()
    patches = PHASES if name == "phases" else ((EPILOGUE, ABLATIONS[name]),)
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError("the scan skeleton in wgmma_scan.cuh has changed; update this script")
        text = text.replace(old, new)
    header.write_text(text)
    if name == "phases":  # one reader of the counters per source (each has its own)
        for src in set(SOURCES.values()):
            cu = csrc / f"{src}.cu"
            cu.write_text(cu.read_text() + f"""
extern "C" int vt_phases_{src}(unsigned long long* out, int reset) {{
  cudaMemcpyFromSymbol(out, wg::phases, sizeof(unsigned long long) * 4);
  const unsigned long long zero[4] = {{0, 0, 0, 0}};
  if (reset) cudaMemcpyToSymbol(wg::phases, zero, sizeof(zero));
  return (int)cudaGetLastError();
}}
""")
    return dest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose package is timed whole")
    ap.add_argument("--pairs", type=int, default=0,
                    help="with --parent: time only it and this package, in this many pairs")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated: " + ", ".join(KERNELS))
    ap.add_argument("--phases", action="store_true",
                    help="cycles per tile in the ring wait, the products and the epilogue")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS) or (args.pairs and args.parent is None):
        ap.error(f"--kernels takes {', '.join(KERNELS)}; --pairs needs --parent")
    if args.measure:  # one build, in a child process
        print(json.dumps(measure(args.reps, kernels, args.phases)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("scan_timing: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cut = ",".join(k for k in KERNELS if k in kernels - WHOLE)  # the ablated builds' kernels
    if args.phases and not cut:
        ap.error("--phases times the scans: give one of " + ", ".join(sorted(set(KERNELS) - WHOLE)))
    if args.phases:
        paths, order = {"phases": ablated_copy("phases")}, ["phases"]
    elif args.pairs:
        paths = {"full": ROOT, "parent": args.parent.resolve()}
        order = [v for i in range(args.pairs)
                 for v in (("parent", "full") if i % 2 == 0 else ("full", "parent"))]
    else:
        ablated = ABLATIONS if cut else {}
        paths = {"full": ROOT, **{name: ablated_copy(name) for name in ablated}}
        order = ["full", *ablated, *reversed(ablated), "full"] if cut else ["full"]
        if args.parent is not None:
            paths["parent"] = args.parent.resolve()
            order = ["parent", *order, "parent"]
    runs = []
    for variant in order:
        env = dict(os.environ, PYTHONPATH=str(paths[variant]))
        whole = variant in ("full", "parent")
        child = subprocess.run([sys.executable, __file__, "--measure", "--reps", str(args.reps),
                                "--kernels", args.kernels if whole else cut,
                                *(["--phases"] if args.phases else [])],
                               capture_output=True, text=True, env=env, check=False)
        if child.returncode:
            print(child.stderr, file=sys.stderr)
            raise RuntimeError(f"the {variant} run failed (exit {child.returncode})")
        *notes, last = child.stdout.strip().splitlines()
        if notes and variant not in [r["variant"] for r in runs]:  # once per build
            print("\n".join(notes), flush=True)
        res = json.loads(last)
        runs.append({"variant": variant, "ms": res})
        for b, t in res.items():
            if args.phases:
                print(f"B={b}: " + "; ".join(
                    f"{k} ring wait {v[0]:.0f}, products {v[1]:.0f}, epilogue {v[2]:.0f}"
                    for k, v in t.items()) + f" cycles per tile and warpgroup [{smi}]", flush=True)
                continue
            print(f"{variant} B={b}: " + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
                  + f" ms [{smi}]", flush=True)
    for variant in dict.fromkeys(order) if not args.phases else ():
        for b, t in runs[order.index(variant)]["ms"].items():
            for k in t:
                ms = sorted(r["ms"][b][k] for r in runs if r["variant"] == variant)
                print(f"{variant} B={b} {k}: median {ms[len(ms) // 2]:.3f} ms, "
                      f"{ms[0]:.3f}-{ms[-1]:.3f} over {len(ms)} runs [{smi}]", flush=True)
    print(json.dumps({"card": smi, "n": N, "d": D, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
