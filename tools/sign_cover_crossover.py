"""Where the quantized mode's K6 group cover overtakes the direct Hamming pass.

``vettore_tpu_torch.ops.pipeline._hamming_slots`` finds the top-``count``
(hamming, slot) candidates by one of two exact routes: from
``_GROUP_COVER_MIN`` rows up, the group cover (the K6 scan, a selection
over its 64-row group minima, the K7 gather, a selection over the covered
groups); below it, the direct pass (an f32 product of the widened signs and
one selection over composite keys of every row). Both return the same
slots. This script times both on one CUDA card at d = 768 and count = 500
(BASELINE.json config 3) for B = 1, 16 and 512 queries over N = 16k to 1M
rows, checks that they agree, and prints the median ms of each route, the
smallest N from which the cover wins for each B, and a JSON summary as its
last line. The group cover needs more than ``count`` groups, so it has no
time below 32,064 rows at count = 500.

Run from the repository root on a machine with a CUDA card:

    python3 tools/sign_cover_crossover.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vettore_tpu_torch.ops import pipeline as pipe  # noqa: E402

ROWS = (16_384, 32_768, 65_536, 131_072, 262_144, 524_288, 1_048_576)
BATCHES = (1, 16, 512)


def cuda_ms(fn, reps):
    """Median ms of ``fn`` on the card (CUDA events, after one warm-up)."""
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


def route(signs, valid, qsigns, *, count, d, cover):
    """``_hamming_slots`` forced onto one route."""
    saved = pipe._GROUP_COVER_MIN
    pipe._GROUP_COVER_MIN = 0 if cover else signs.shape[0] + 1
    try:
        return pipe._hamming_slots(signs, valid, qsigns, count=count, d=d)
    finally:
        pipe._GROUP_COVER_MIN = saved


def sweep(gen, d, count, reps, smi):
    """Both routes' median ms at every (N, B); printed when ``smi`` is set."""
    dev = gen.device
    results = []
    for n in ROWS:
        signs = torch.where(torch.randn((n, d), generator=gen, device=dev) >= 0, 1, -1)
        signs = signs.to(torch.int8)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[n - n // 100:] = False  # capacity padding: dead rows at the end
        for b in BATCHES:
            qsigns = torch.where(torch.randn((b, d), generator=gen, device=dev) >= 0, 1, -1)
            qsigns = qsigns.to(torch.int8)
            direct = route(signs, valid, qsigns, count=count, d=d, cover=False)
            row = {"n": n, "b": b, "direct_ms": cuda_ms(
                lambda: route(signs, valid, qsigns, count=count, d=d, cover=False), reps),
                "cover_ms": None}
            if n // 64 > count:
                cover = route(signs, valid, qsigns, count=count, d=d, cover=True)
                assert torch.equal(cover[0], direct[0]), f"routes disagree at n={n} b={b}"
                row["cover_ms"] = cuda_ms(
                    lambda: route(signs, valid, qsigns, count=count, d=d, cover=True), reps)
            results.append(row)
            if smi:
                cover_txt = "-" if row["cover_ms"] is None else f"{row['cover_ms']:.3f}"
                print(f"n={n:>9} b={b:>4}: direct {row['direct_ms']:.3f} ms, group cover "
                      f"{cover_txt} ms [{smi}]", flush=True)
        del signs, valid
        torch.cuda.empty_cache()
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=768)
    ap.add_argument("--count", type=int, default=500)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sign_cover_crossover: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(args.seed)
    d, count = args.d, args.count
    # the first pass warms the allocator, the library kernels' heuristics and
    # the clocks; only the second is reported
    for report in (False, True):
        results = sweep(gen, d, count, args.reps, smi if report else None)
    crossover = {}
    for b in BATCHES:
        # the smallest N from which the cover wins at every larger N measured
        crossover[b] = None
        for r in sorted((r for r in results if r["b"] == b), key=lambda r: -r["n"]):
            if r["cover_ms"] is None or r["cover_ms"] >= r["direct_ms"]:
                break
            crossover[b] = r["n"]
        print(f"B={b}: the group cover wins from N={crossover[b]}", flush=True)
    print(json.dumps({"card": smi, "d": d, "count": count, "results": results,
                      "cover_wins_from": crossover}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
