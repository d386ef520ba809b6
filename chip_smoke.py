"""On-card smoke gate of the PyTorch port (``vettore_tpu_torch``).

Drives the port's main path — exact flat search through ``Collection`` —
on one CUDA card, builds the hand-written CUDA kernels from this checkout,
holds every kernel against its plain PyTorch version at the main path's
shapes, and checks search results against a float64 numpy oracle. Imports
nothing of JAX.

Phases (each prints one line; any failure exits non-zero):

1. device: the card, its power limit, the kernel build;
2. kernels: K1 ``gmin_scan`` and K2 ``rescore`` against their plain versions
   at N = 1,000,448, d = 768, B = 512 (cosine and l2, f32 and bf16), with
   median times of both;
3. BASELINE config 1: 100k x 384 cosine f32, limit 10, 64 queries, against
   the oracle; single-query ``search`` equals ``search_batch``;
4. headline scale: 1M x 768 cosine f32 clustered corpus, batch 512, limit 10:
   oracle parity on 32 queries, no host-oracle route, both kernel launch
   counts grown, bf16 storage overlap@10 >= 0.95, and times per batch;
5. snapshot: the phase-3 collection written and loaded back gives the same
   ids.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py`` (needs one CUDA card
and ``nvcc``; the kernels build at first use, in seconds).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20_261_016
#: the headline corpus and the main path's shapes: _cap_for(1,000,000) rows,
#: d = 768, a 512-query batch
N_CORPUS = 1_000_000
N_MAIN, D_MAIN, B_MAIN = 1_000_448, 768, 512
#: BASELINE.json config 1: flat exact cosine over 100k x 384 f32
N_BASE, D_BASE = 100_000, 384
DEVICE = "cuda"
#: oracle tie tolerance: the f32 scan cannot order two unit-vector dot
#: products that differ by less than its own rounding (~1e-7 over d = 768);
#: ids whose float64 scores lie this close may trade places
TIE_EPS = 1e-6
SCORE_TOL = 1e-4
K1_ATOL = {"f32": 1e-5, "bf16": 1e-4}
K2_ATOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def clustered(rng, n, d, radius=0.4):
    """Unit vectors in Gaussian clusters (n/100 centres, sigma =
    radius/sqrt(d)): the benchmark's embedding-like geometry."""
    centres = rng.standard_normal((max(1, n // 100), d), dtype=np.float32)
    centres /= np.linalg.norm(centres, axis=1, keepdims=True)
    data = centres[rng.integers(0, centres.shape[0], n)]
    data += np.float32(radius / np.sqrt(d)) * rng.standard_normal((n, d), dtype=np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data


def near_queries(rng, data, count, noise=0.4):
    """Held-out queries: corpus points plus noise at the cluster radius."""
    q = data[rng.integers(0, data.shape[0], count)] + np.float32(
        noise / np.sqrt(data.shape[1])) * rng.standard_normal((count, data.shape[1]),
                                                              dtype=np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def f64_oracle(x, ids, q, limit, chunk=1 << 17):
    """Exact cosine top-``limit + 4`` per query in float64 (chunked over
    rows), ordered by (score desc, id asc): ``[(ids, scores)]``."""
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    sims = np.empty((x.shape[0], q.shape[0]), np.float64)
    for s in range(0, x.shape[0], chunk):
        c = x[s:s + chunk].astype(np.float64)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
        sims[s:s + chunk] = c @ q64.T
    width = limit + 4
    out = []
    for b in range(q.shape[0]):
        cand = np.argpartition(-sims[:, b], width)[:width]
        order = sorted(cand, key=lambda i: (-sims[i, b], ids[i]))
        out.append(([ids[i] for i in order], [float(sims[i, b]) for i in order]))
    return out


def check_hits(got, want, limit):
    """Ids in the oracle's order, scores within SCORE_TOL; an id may stand
    where the oracle's score is within TIE_EPS of its own. Returns the
    number of such near-tie substitutions."""
    want_ids, want_scores = want
    score_of = dict(zip(want_ids, want_scores))
    assert len(got) == limit, (len(got), limit)
    swaps = 0
    for i, (gid, gscore) in enumerate(got):
        if gid != want_ids[i]:
            assert gid in score_of and abs(score_of[gid] - want_scores[i]) < TIE_EPS, (
                i, gid, want_ids[:limit])
            swaps += 1
        assert abs(gscore - score_of[gid]) < SCORE_TOL, (gid, gscore, score_of[gid])
    return swaps


def cuda_ms(torch, fn, reps=7):
    """Median milliseconds of ``fn`` on the card (CUDA events, after one
    warm-up call)."""
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


def host_ms(torch, fn, reps=7):
    """Median wall milliseconds of ``fn`` including a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this gate runs only on a GPU", file=sys.stderr)
        return 2
    # the f32 path must stay exact: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import vettore_tpu_torch as vt
    from vettore_tpu_torch import _build
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import scan_host, select
    from vettore_tpu_torch.ops.distance import normalize_rows

    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)

    # ---- phase 1: device and build --------------------------------------
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(smi)
    card = f"[{smi}]"
    _build.load()
    build_s = time.perf_counter() - t0
    log(f"[phase 1] device {kind}, count {torch.cuda.device_count()}: kernels built "
        f"in {build_s:.1f}s ({_build.build_dir()})")
    torch.cuda.synchronize()

    # ---- phase 2: kernels against their plain versions -------------------
    t0 = time.perf_counter()
    corpus = clustered(rng, N_CORPUS, D_MAIN)
    queries = near_queries(rng, corpus, B_MAIN)
    x32 = torch.zeros((N_MAIN, D_MAIN), dtype=torch.float32, device=dev)
    x32[: corpus.shape[0]] = torch.from_numpy(corpus).to(dev)
    bias = torch.zeros(N_MAIN, dtype=torch.float32, device=dev)
    bias[corpus.shape[0]:] = float("inf")  # capacity padding: dead, all-zero rows
    xsq = (x32 * x32).sum(dim=1)
    q = torch.from_numpy(queries).to(dev)
    errs = {"gmin_scan": 0.0, "rescore": 0.0}
    times = {}
    for storage in ("f32", "bf16"):
        x = x32 if storage == "f32" else x32.to(torch.bfloat16)
        for metric in ("cosine", "l2"):
            gmin, bounded = fs.gmin_scan(x, xsq, bias, q, metric=metric)
            ref = fs._gmin_scan_ref(x, xsq, bias, q, metric=metric)
            fin = torch.isfinite(ref)
            assert torch.equal(fin, torch.isfinite(gmin)), "K1 finiteness differs"
            e1 = (gmin[fin] - ref[fin]).abs().max().item()
            assert e1 <= K1_ATOL[storage], f"K1 {storage} {metric} err {e1}"
            assert bool(bounded) == bool(fs._bounded(xsq, (q * q).sum(dim=1)))
            assert bool(bounded), "unit-norm data must pass the overflow bound"
            _v, gidx, _ok = select.group_topk(ref, 24, check_c=16)
            gidx = gidx.int()
            out = fs.rescore(x, xsq, bias, q, gidx, metric=metric)
            ref2 = fs._rescore_ref(x, xsq, bias, q, gidx, metric=metric)
            fin2 = torch.isfinite(ref2)
            assert torch.equal(fin2, torch.isfinite(out)), "K2 finiteness differs"
            e2 = (out[fin2] - ref2[fin2]).abs().max().item()
            assert e2 <= K2_ATOL, f"K2 {storage} {metric} err {e2}"
            del ref, ref2, out, gmin
            errs["gmin_scan"] = max(errs["gmin_scan"], e1)
            errs["rescore"] = max(errs["rescore"], e2)
            t = {
                "k1": cuda_ms(torch, lambda: fs.gmin_scan(x, xsq, bias, q, metric=metric)),
                "k1_plain": cuda_ms(torch, lambda: fs._gmin_scan_ref(x, xsq, bias, q,
                                                                     metric=metric)),
                "k2": cuda_ms(torch, lambda: fs.rescore(x, xsq, bias, q, gidx, metric=metric)),
                "k2_plain": cuda_ms(torch, lambda: fs._rescore_ref(x, xsq, bias, q, gidx,
                                                                   metric=metric)),
            }
            times[(storage, metric)] = t
            log(f"  K1 gmin_scan {storage} {metric}: err {e1:.3g} (atol {K1_ATOL[storage]}), "
                f"{t['k1']:.3f} ms vs plain {t['k1_plain']:.3f} ms | K2 rescore: err "
                f"{e2:.3g} (atol {K2_ATOL}), {t['k2']:.3f} ms vs plain {t['k2_plain']:.3f} ms "
                f"{card}")
    del x, x32, xsq, bias, q
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[phase 2] kernels match their plain versions at N={N_MAIN} d={D_MAIN} "
        f"B={B_MAIN} ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 3: BASELINE config 1 (100k x 384 cosine f32, limit 10) ----
    t0 = time.perf_counter()
    n3, d3 = N_BASE, D_BASE
    data3 = clustered(rng, n3, d3)
    ids3 = [f"doc-{i:06d}" for i in rng.permutation(n3)]
    qs3 = near_queries(rng, data3, 64)
    col3 = vt.Collection(name="baseline-1", dimensions=d3, metric="cosine", index="flat",
                         device=dev)
    col3.put_matrix(ids3, data3)
    got3 = col3.search_batch(qs3, limit=10)
    stored3 = normalize_rows(data3, "l2")  # the bytes the collection stores
    truth3 = f64_oracle(stored3, ids3, qs3, 10)
    # the vectorized oracle against the port's own host oracle (scan_host),
    # on each query's oracle candidates plus a random sample of rows
    for b in range(2):
        sample = set(rng.integers(0, n3, 2000).tolist()) | {
            ids3.index(i) for i in truth3[b][0]}
        pairs = [(ids3[i], stored3[i]) for i in sorted(sample)]
        host = scan_host.vector_top_k(pairs, qs3[b].astype(np.float64), "cosine", d3, 10)
        assert [h[0] for h in host] == truth3[b][0][:10], (host, truth3[b][0])
    swaps3 = sum(check_hits([(r.id, r.score) for r in row], want, 10)
                 for row, want in zip(got3, truth3))
    single = [[r.id for r in col3.search(qv.tolist(), limit=10)] for qv in qs3[:4]]
    assert single == [[r.id for r in row] for row in col3.search_batch(qs3[:4], limit=10)]
    assert col3.index.host_routes == 0, col3.index.host_routes
    torch.cuda.synchronize()
    log(f"[phase 3] BASELINE config 1 ({n3}x{d3} cosine f32, limit 10, 64 queries): ids "
        f"equal the f64 oracle ({swaps3} near-tie swaps), scores within {SCORE_TOL}; "
        f"search == search_batch ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 4: the main path at the headline scale ---------------------
    t0 = time.perf_counter()
    ids = [f"doc-{i:07d}" for i in range(corpus.shape[0])]
    col = vt.Collection(name="headline", dimensions=D_MAIN, metric="cosine", index="flat",
                        device=dev)
    col.put_matrix(ids, corpus)
    ingest_s = time.perf_counter() - t0
    assert col.index._cap == N_MAIN and col.index._fused_eligible(16)
    for name in fs.LAUNCHES:
        fs.LAUNCHES[name] = 0
    t1 = time.perf_counter()
    got = col.search_batch(queries, limit=10)  # first call uploads the block
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    truth = f64_oracle(normalize_rows(corpus, "l2"), ids, queries[:32], 10)
    swaps = sum(check_hits([(r.id, r.score) for r in row], want, 10)
                for row, want in zip(got[:32], truth))
    assert col.index.host_routes == 0, f"host-oracle routes: {col.index.host_routes}"
    view = col.index.storage_view("bf16")
    got16 = view.search_batch(normalize_rows(queries, "l2"), 10)
    overlap = float(np.mean([len({h[0] for h in a} & {r.id for r in b}) / 10
                             for a, b in zip(got16, got)]))
    assert overlap >= 0.95, f"bf16 overlap@10 {overlap}"
    qdev = torch.from_numpy(normalize_rows(queries, "l2")).to(dev)
    ms_f32 = host_ms(torch, lambda: col.index.search_batch_device(qdev, 10))
    ms_bf16 = host_ms(torch, lambda: view.search_batch_device(qdev, 10))
    ms_sync = host_ms(torch, lambda: col.search_batch(queries, limit=10), reps=5)
    launches = dict(fs.LAUNCHES)
    assert col.index.host_routes == 0
    assert all(v > 0 for v in launches.values()), f"kernels not launched: {launches}"
    torch.cuda.synchronize()
    log(f"  ingest {ingest_s:.1f}s, first search_batch (upload + search) {first_s:.1f}s")
    log(f"  search_batch_device B={B_MAIN}: f32 {ms_f32:.3f} ms, bf16 {ms_bf16:.3f} ms; "
        f"search_batch (sync, hydrated) f32 {ms_sync:.3f} ms {card}")
    log(f"[phase 4] {N_CORPUS}x{D_MAIN} cosine f32: ids equal the f64 oracle on 32 queries ({swaps} "
        f"near-tie swaps), host routes f32 0 / bf16 {view.host_routes}, bf16 overlap@10 "
        f"{overlap:.4f}, launches {launches} ({time.perf_counter() - t0:.1f}s)")
    del view, col
    torch.cuda.empty_cache()

    # ---- phase 5: snapshot round trip -------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "baseline-1.vsnap")
        col3.snapshot(path)
        loaded = vt.load_snapshot(path, device=dev)
        again = loaded.search_batch(qs3, limit=10)
        assert [[r.id for r in row] for row in again] == [[r.id for r in row] for row in got3]
        loaded.close()
    col3.close()
    torch.cuda.synchronize()
    log(f"[phase 5] snapshot written and loaded back: same ids "
        f"({time.perf_counter() - t0:.1f}s)")

    main_t = times[("f32", "cosine")]
    kernels = [
        {"name": "gmin_scan", "route": "cuda", "source": "vettore_tpu_torch/csrc/flat_scan.cu",
         "replaces": "vettore_tpu/ops/flat_scan.py:134", "launches": launches["gmin_scan"],
         "max_abs_err": errs["gmin_scan"], "ms": main_t["k1"], "plain_ms": main_t["k1_plain"]},
        {"name": "rescore", "route": "cuda", "source": "vettore_tpu_torch/csrc/flat_scan.cu",
         "replaces": "vettore_tpu/ops/flat_scan.py:208", "launches": launches["rescore"],
         "max_abs_err": errs["rescore"], "ms": main_t["k2"], "plain_ms": main_t["k2_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
