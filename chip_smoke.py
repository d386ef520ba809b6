"""On-card smoke gate of the PyTorch port (``vettore_tpu_torch``).

Drives the port's paths — exact flat search (f32, bf16 and int8 storage),
the funnel and quantized search modes, the HNSW index (its kNN and wave bulk
builds, batched beam search, writes to a bulk graph, compaction and graph
files), the IVF index (its k-means build, probed search, writes and
rebuilds), ``compressed=True``, the multi-vector MaxSim search (exact
and over MUVERA candidates), the hybrid pipelines and MMR, through
``Collection``, and the mesh (4 virtual shards; on a machine with four
cards, also the mesh over the four) — on one CUDA card, builds the
hand-written CUDA kernels from this checkout, holds every
kernel against its plain PyTorch version at the main path's shapes, and
checks search results against float64 numpy oracles. Imports nothing of
JAX.

Phases (each prints one line; any failure exits non-zero):

1. device: the card, its power limit, the kernel build;
2. kernels: K1 ``gmin_scan`` and K2 ``rescore`` against their plain versions
   at N = 1,000,448, d = 768, B = 512 (cosine and l2, f32 and bf16), with
   median times of both (K2's pairs, distinct groups and sharing logged), and ``torch.matmul`` on K1's operands (f32 with
   TF32 off, and bf16: the product alone, a yardstick, not K1's function);
2b. adaptive kernels at the same N, d, B: K5 ``stage_gmin_scan`` (dims =
   128; cosine and l2, f32 and bf16, all on the direct TMA route), K6
   ``fused_sign_scan`` and K7 ``extract_group_rows`` (at the funnel's and
   the quantized mode's shapes) against their plain versions, with median
   times of both (K7's wrapper and, by ``torch.profiler``, its kernel
   alone), K6's operand route and ``torch._int_mm`` on K6's operands (the
   int8 product alone: a yardstick, not K6's function);
2c. K3 ``int8_gmin_scan`` (bit-equal; its route and the ``torch._int_mm``
   yardstick as K6's) and K4 ``int8_rescore`` at the same
   N, d, B (cosine and l2), K2 (f32, bf16) and K4 on 512 copies of one
   query (mass sharing: every pair of a group in one run), and the MaxSim kernel ``maxsim_rank_scan`` at
   BASELINE config 5's shape (N = 100,352 docs x 32 tokens x 128 d, 64 sets
   of 4 query tokens: bf16 and f32 blocks of full docs, and an f32 block with
   random token counts and dead docs; the token norms given as the scan
   cache keeps them) against their plain versions;
3. BASELINE config 1: 100k x 384 cosine f32, limit 10, 64 queries, against
   the oracle; single-query ``search`` equals ``search_batch``;
4. headline scale: 1M x 768 cosine f32 clustered corpus, batch 512, limit 10:
   oracle parity on 32 queries, no host-oracle route, both kernel launch
   counts grown in the f32 run and in the bf16 run, every K1 launch on the
   direct TMA route and every K2 launch on the direct (bulk-copy) route, bf16 storage overlap@10 >= 0.95, times per batch and
   a ``torch.profiler`` trace of the f32 and bf16 device batches;
4b. BASELINE configs 3 and 4 on phase 4's collection (the scan cache shares
   its block): quantized candidates=500 and funnel stages [128, 256, 384]
   candidates=200, limit 10, batch 512, sync and device entry points;
   oracle parity on 16 queries, no host route, the K5/K6/K7 launch counts
   grown (K5 and K6 on the direct TMA route), times per batch, a
   ``torch.profiler`` trace of three batches of
   each device path (device busy time, idle share, top kernels), overlap@10
   against phase 4's exact results; then the funnel pipeline
   (``ops/pipeline.funnel_pipeline_batch``) over a bf16 copy of the block,
   which runs K5 on bf16 rows: its launches, route, ms per batch and
   overlap@10 with the funnel oracle;
4d. BASELINE config 2: ``Collection(index="hnsw")`` (m 16, m0 32,
   ef_construction 100, ef_search 64) over phase 4's corpus; ``put_matrix``
   bulk-builds the graph through the kNN build on the card (timed), then
   ``search_batch_device`` on the batch of 512 at limit 10 (ms per batch,
   a ``torch.profiler`` split with the idle share), one hydrated
   ``search_batch`` and one ``search``: recall@10 >= 0.95 against phase 4's
   exact ids, every raw score within 1e-5 of its float64 dot, hits in
   (rank, id) order; then 3,000 rows through host inserts (below the bulk
   threshold), served by the device beam, against a float64 oracle;
4f. writes to config 2's graph, before phase 4d's collection is dropped:
   one ``put`` (the migration into mutable form plus one wave), a
   ``put_many`` of 8,192 new clustered rows (one full wave; a second one
   traced by ``torch.profiler``: busy, idle, top device operations), a
   replace through ``HnswIndex.put``; ``search_batch_device`` of 512 queries
   near the new rows and of phase 4's 512 against a float64 oracle over the
   live rows (recall@10 >= 0.95, raw scores within 1e-5, (rank, id) order,
   the replaced id's new vector); 10,000 deletes through
   ``HnswIndex.delete``, the entry's id among them (re-elected, no deleted
   id returned, recall@10 >= 0.95, no compaction); then the wave build
   (``build="wave"``, ``put_matrix`` of 20,000 clustered rows, recall@10)
   and 5,001 collection deletes, which compact the graph by a wave build of
   its 14,999 live rows from the device block (n == live, no tombstones,
   recall@10); each step timed;
4e. a flat hybrid on phase 4's collection: ``hybrid_search_batch`` of the
   batch of 512 at limit 10 with the funnel, quantized and search
   generators (100 candidates each) and the exact rerank; its ids equal
   phase 4's exact results (the search generator holds the exact top 100),
   no host route, the K1, K2, K5, K6 and K7 launch counts grown, each of
   those kernels' wrappers held against its plain version on the operands
   the path gave it (recorded during the run: K2 at the search generator's
   k, K5, K6 and K7 at count 100), ms per sync batch and a
   ``torch.profiler`` split of three batches;
4c. ``storage_view("int8")`` of phase 4's index: overlap@10 against exact
   f32 on 32 queries, no host route, the K3/K4 launch counts grown (K3 on
   the direct TMA route, K4 on the direct bulk-copy route), ms per device batch of 512 and its
   ``torch.profiler`` trace;
4g. the IVF index on phase 4's corpus, as ``bench.py`` drives it:
   ``IvfIndex.from_flat`` of phase 4's flat index (n_probe 4, bf16 storage)
   and a cold ``rebuild`` (timed), then a second build (f32 storage) whose
   permutation, routing centroids and block ids must be bit-equal (the
   centroid update is deterministic); the n_probe sweep 4, 8, .., 64 until
   recall@10 against phase 4's exact ids reaches 0.95 (failing if none
   does), its raw scores within 1e-5 of float64 over the bf16 rows and its
   hits in (rank, id) order; at that n_probe the ms per
   ``search_batch_device`` batch of 512 (CUDA events), per sync
   ``search_batch`` and a ``torch.profiler`` split; writes through the
   index into phase 4's flat index (a ``put_many`` of 8,192 new rows, the
   pending tail; 10,000 deletes, tombstones; a replace), each timed, with
   recall@10 >= 0.95 against exact flat over the live rows on phase 4's
   queries and on queries near the new rows, no deleted id returned; an
   explicit ``rebuild`` and an ``n_probe="auto"`` build (timed, its
   ``tuned`` logged); full probe on config 1's corpus (n_probe >= its
   1,563 blocks) equal to exact flat, ids in order; on config 1's corpus
   ``Collection(index="ivf")`` (``put_matrix``, ``search_batch``, the
   default hybrid: search + quantized) and ``Collection(compressed=True)``,
   whose ids equal a float64 oracle over the bf16-rounded rows; every
   kernel the phase launched (K1, K2, K6, K7) held against its plain
   version on the operands it was given; then, after the counts were read,
   K2 on IVF's routing at n_probe 4 and 64 (bf16 block) and 4 (f32 block)
   against its plain version, timed against its bytes bound, with its
   sharing logged;
5. snapshot: the phase-3 collection written and loaded back gives the same
   ids;
6. BASELINE config 5, exact MaxSim: 100,000 docs x 32 bf16-exact tokens x
   128 d through ``put_tokens``, 128 query sets of 4 tokens, limit 10, batch
   64; ids equal a float64 MaxSim oracle on 8 sets, no host route, the
   MaxSim launch count grown by the batches and by one single-set
   ``multi_vector_search``, all on the direct TMA route, ms per batch, a
   ``torch.profiler`` split of one batch; then a small ragged corpus (an f32
   token block: the 3xTF32 kernel) against the oracle, its launches counted
   and direct too;
6b. BASELINE config 5's hybrid pipeline on phase 6's collection, as
   ``bench.py``'s ``run_hybrid_mv``: an ``HnswIndex`` (m 16, m0 32,
   ef_construction 100, ef_search 64) bulk-built from the primary vectors
   (timed), saved and loaded back with and without its vector block (the
   same search results), attached (``index_kind`` "hnsw");
   ``hybrid_search_batch`` of 64 queries at limit 30 with the hnsw and
   quantized generators (1,000 candidates each) and the MaxSim rerank of
   phase 6's query sets, each query's results equal to a float64 MaxSim
   oracle over its candidate union (the HNSW beam's 1,000 and a numpy
   Hamming top 1,000), no host route, the K6 and K7 launch counts grown
   and both held against their plain versions on the operands the path
   gave them (K6 at d = 128 over the cache's sign block, K7 on the
   1,000-candidate cover),
   overlap@10 against exact MaxSim logged; ``mmr_rerank_batch`` (cosine,
   alpha 0.5, final_k 10) on those results, a float64 greedy order;
   ``multi_vector_search_batch(candidates=512)`` with the default MUVERA
   config and with ``muvera_fde.default_config`` (a 2,048-wide FDE block):
   K5 on its fused route, K5 and K7 held against their plain versions on
   the operands each call gave them, the candidates equal to the float64
   top 512 by FDE dot over the card's bf16 block, the results to a float64
   MaxSim oracle over them; and K5 alone at the 2,048-wide FDE shape,
   timed against its plain version;
7. the mesh (``parallel/``) on ``make_mesh([cuda:0] * 4)``: 4 virtual shards
   of the card, data 1, over the host copies of phase 4's corpus, queries
   and exact results and phase 6's token corpus. ``Collection(mesh=)`` at
   1M x 768 (``put_matrix`` through ``put_many``, timed): ``search_batch``
   of the 512 at limit 10 equal to phase 4's ids (0 plain-scan reruns);
   configs 3 and 4 and the flat hybrid equal to phases 4b and 4e;
   ``ShardedIvf`` (n_probe 4, bf16; build timed) at recall@10 >= 0.95;
   config 5's exact MaxSim on a mesh collection equal to phase 6's first
   64 sets; no host route. Every kernel those runs launched (K1, K2 on the
   flat shards and on IVF's, K5, K6, K7, MaxSim) held against its plain
   version at the shard's own shapes and timed there. Per mode the ms per
   batch and the ``torch.profiler`` busy time and idle share, beside one
   device's from the earlier phases. Then ``ShardedHnsw``: the default
   (kNN) build per shard, timed, its recall@10 at ef 64, 128 and 256
   logged against the 0.95 bar, not gated (a shard holds a random quarter
   of each cluster, on which the kNN build falls short: an open fault),
   and the wave build per shard, timed, at recall@10 >= 0.95, an
   ``incremental_put`` of 8,192 new rows and 10,000
   ``incremental_delete``s, recall@10 >= 0.95 over the live rows against a
   float64 oracle (phase 4's queries and queries near the new rows); and
   data 2 x shard 2 at config 1's size: flat, funnel and quantized equal
   to one device's, their launches counted (K1, K2, K5 and K7 each at
   least once) and every call held against its plain version at the
   shapes of those shards;
8. the mesh over four real cards, run only when the machine has four
   (with fewer it logs ``[phase 8] N card(s): not run``): each card's
   ``nvidia-smi`` line and the cards' peer access, then 8a, phase 7's runs
   over ``make_mesh()`` (every card, shard 4, data 1; data 2 x shard 2 at
   config 1 over the same four), with phase 7's checks and every card
   launching each kernel its shards run (``_build.CARD_LAUNCHES``), each
   mode's ms per batch and each card's busy ms beside phase 7's and one
   device's; and 8b, a flat block larger than one card: 4 x 7,000,000 x
   768 f32 (86.0 GB), each shard generated on its card by
   ``synth.clustered`` in chunks of 1,000,000 rows, searched by
   ``parallel.sharded_search`` in batches of 512 near-queries (cosine,
   k = 10): 16 queries' ids equal a float64 oracle computed card by card,
   every K1 / K2 launch held against its plain version (K1 on the first
   2,097,152 rows of its shard), ms per batch, each card's busy ms, the
   gathered bytes, memory per card and the reruns.

The last two lines of standard output are a JSON summary of the kernels
(each with its launches on its path and on phases 4e, 4f, 4g, 6b, 7 ("mesh"),
7f ("mesh data 2") and 8 ("mesh cards", null where phase 8 did not run),
max abs error against its plain version over every check, that error on
each of phases 4e, 6b, 7, 7f and 8 (null where the mesh launched none),
and max relative error where the tolerance is relative, kernel / plain /
library ms and its bound, its ms at the mesh's shard shapes, and
``mesh_cards_ms`` at the shard shapes on the four cards) and ``{"ok":
true, "device": {...}}``.

Run from the repository root: ``python3 chip_smoke.py`` (needs one CUDA card
and ``nvcc``; the kernels build at first use, in seconds; phase 8 runs on a
machine with four cards).
"""

from __future__ import annotations

import contextlib
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
#: K5 group minima and ranks: as K1 (f32 summation order; bf16 products
#: exact, accumulated in another order); K6 and K7 must be bit-equal
K5_ATOL = K1_ATOL
#: K3 must be bit-equal; K4 and the f32 MaxSim ranks within 1e-5 * max(1,
#: |rank|) (f32 sums in another order); bf16 MaxSim ranks within 1e-4 *
#: max(1, |rank|) (exact bf16 products summed in another order)
K4_RTOL = 1e-5
MV_RTOL = {"f32": 1e-5, "bf16": 1e-4}
#: int8 storage against exact f32 (phase 4c)
INT8_OVERLAP_MIN = 0.90
#: BASELINE.json config 5: docs x tokens x d, query sets of 4 tokens, batch
MV_N, MV_T, MV_D, MV_Q, MV_B, MV_SETS = 100_000, 32, 128, 4, 64, 128
MV_ORACLE_SETS = 8
#: config 5's hybrid (bench.py's run_hybrid_mv): candidates per generator and
#: the limit before MMR; MUVERA's candidate count
HYBRID_C, HYBRID_LIMIT, MUVERA_C = 1000, 30, 512
#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
#: f32 on CUDA cores, tf32, bf16 and int8 on tensor cores, HBM3 bytes per
#: second
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "bytes": 3.35e12}
#: BASELINE.json configs 3 (quantized) and 4 (funnel)
QUANT_C = 500
FUNNEL_STAGES, FUNNEL_C = (128, 256, 384), 200
N_ADAPTIVE_ORACLE = 16
#: BASELINE.json config 2: HNSW over the 1M x 768 corpus, its bar on
#: recall@10 against exact flat, and the host-built graph's size (below
#: HnswIndex.BULK_THRESHOLD, above the device beam's 2,048 nodes)
HNSW_OPTS = {"m": 16, "m0": 32, "ef_construction": 100, "ef_search": 64}
HNSW_RECALL_MIN = 0.95
HNSW_HOST_N = 3000
#: HNSW raw scores against float64 dots of the stored rows; the most a raw
#: score may rise from one hit to the next (two f32 sums of one dot)
HNSW_RAW_TOL = 1e-5
HNSW_ORDER_TOL = 1e-6
#: phase 4f, writes to config 2's graph: the rows of one put_many (one full
#: wave, the last of ``hnsw_build.INCR_WAVE_BUCKETS``), the ids deleted from
#: it; the wave build's rows (the bulk threshold) and the deletes that pass
#: ``REBUILD_FRACTION`` and compact it
HNSW_PUT_MANY, HNSW_DELETES = 8192, 10_000
WAVE_N, WAVE_DELETES = 20_000, 5_001
#: phase 4g: bench.py's IVF call and n_probe sweep, its recall bar (bench.py's
#: RECALL_GATE); the writes to the 1M index (as phase 4f's); the queries of
#: the full probe at config 1's size
IVF_OPTS = {"n_probe": 4, "storage": "bf16"}
IVF_SWEEP = (4, 8, 16, 32, 64)
IVF_RECALL_MIN = 0.95
IVF_PUT_MANY, IVF_DELETES = 8192, 10_000
IVF_FULL_B = 16
#: phase 7: the mesh's virtual shards of the card; the HNSW writes (as
#: phase 4f's). The gated shard graphs take the wave build: a shard of this
#: corpus holds a random quarter of each 100-row cluster, and on such 25-row
#: clusters the kNN build (the ``auto`` default from 20,000 rows) falls
#: short of the recall bar, in the JAX package as in the port (an open
#: fault; the phase logs its recall, and
#: ``tests/test_torch_hnsw_knn_build.py`` shows both packages' equal
#: graphs on such a corpus)
MESH_SHARDS = 4
MESH_PUT_MANY, MESH_DELETES = 8192, 10_000
MESH_HNSW_OPTS = dict(HNSW_OPTS, build="wave")
#: phase 8: the mesh over four real cards, run when the machine has them.
#: 8b's block: BIG_SHARD rows x D_MAIN f32 on each card (4 x 7,000,000 x 768
#: x 4 B = 86.0 GB, more than one card's 80 GB; 7,000,000 = 64 x 109,375),
#: generated on its card in chunks of BIG_CHUNK rows (one synth call and
#: seed each); K1 held against its plain version on the first BIG_CHECK
#: rows of a shard; BIG_ORACLE queries against the float64 oracle
CARDS = 4
BIG_SHARD, BIG_CHUNK, BIG_CHECK, BIG_ORACLE = 7_000_000, 1_000_000, 1 << 21, 16


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


def f64_oracle(x, ids, q, limit, chunk=1 << 17, renorm=True):
    """Exact cosine top-``limit + 4`` per query in float64 (chunked over
    rows), ordered by (score desc, id asc): ``[(ids, scores)]``. With
    ``renorm`` False the rows score as they are (a bf16-rounded unit row
    is a little off unit norm, and a bf16 block scores it so)."""
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    sims = np.empty((x.shape[0], q.shape[0]), np.float64)
    for s in range(0, x.shape[0], chunk):
        c = x[s:s + chunk].astype(np.float64)
        if renorm:
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


def bound(ops, rate, nbytes):
    """The least time the card could take, in ms: the larger of ``ops`` at
    the ``rate`` peak and ``nbytes`` at the memory rate; and which bounds
    it."""
    t_ops, t_bytes = ops / PEAK[rate], nbytes / PEAK["bytes"]
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def abs_rel_err(got, want):
    """Largest ``|got - want|`` and largest ``|got - want| / max(1, |want|)``
    over the finite entries; the non-finite entries must be equal."""
    fin = want.isfinite()
    assert got.isfinite().eq(fin).all() and got[~fin].eq(want[~fin]).all(), "finiteness differs"
    diff = (got[fin] - want[fin]).abs()
    return diff.max().item(), (diff / want[fin].abs().clamp_min(1.0)).max().item()


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


def kernel_ms(torch, fn, key, reps=10):
    """Device ms per call of ``fn`` spent in kernels whose name holds
    ``key`` (``torch.profiler``): a kernel's own time, without the
    wrapper's host work that ``cuda_ms`` counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and key in e.key.lower())
    assert total > 0, f"the profiler recorded no {key} kernel"
    return total / 1e3 / reps


def host_ms(torch, fn, reps=7):
    """Median wall milliseconds of ``fn`` including a synchronise of every
    card."""
    fn()
    sync_all(torch)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync_all(torch)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def int_mm_ms(torch, q8, x8):
    """Median ms of ``torch._int_mm(q8, x8.T)``: the int8 product alone into
    an int32 ``[B, N]`` matrix, on the same operands as K3 or K6. A yardstick
    of the product only (the kernels compute more), so it is logged and not
    reported as ``library_ms``; the port never calls it."""
    return cuda_ms(torch, lambda: torch._int_mm(q8, x8.T))


def adaptive_kernels(torch, fs, select, x32, bias, q, card):
    """Phase 2b: K5, K6 and K7 against their plain versions at the main
    path's shapes. Returns (max abs errors by kernel, median ms of the main
    configurations: K5 f32 cosine, K6, K7 at the quantized mode's shape)."""
    dims = FUNNEL_STAGES[0]
    errs = {"stage_gmin_scan": 0.0, "stage_gmin_scan_bf16": 0.0, "sign_scan": 0.0,
            "extract_group_rows": 0.0}
    times = {}
    reset_counts(fs)
    for storage in ("f32", "bf16"):
        x = x32 if storage == "f32" else x32.to(torch.bfloat16)
        xsq = (x[:, :dims].float() ** 2).sum(dim=1)
        for metric in ("cosine", "l2"):
            gmin, rank, bounded = fs.stage_gmin_scan(x, xsq, bias, q, metric=metric, dims=dims)
            refs = fs._stage_gmin_scan_ref(x, xsq, bias, q, metric=metric, dims=dims)
            err = 0.0
            for got, ref in zip((gmin, rank), refs):
                fin = torch.isfinite(ref)
                assert torch.equal(fin, torch.isfinite(got)), "K5 finiteness differs"
                err = max(err, (got[fin] - ref[fin]).abs().max().item())
            del refs
            assert err <= K5_ATOL[storage], f"K5 {storage} {metric} err {err}"
            assert bool(bounded), "unit-norm data must pass the overflow bound"
            k5_name = "stage_gmin_scan" if storage == "f32" else "stage_gmin_scan_bf16"
            errs[k5_name] = max(errs[k5_name], err)
            k5 = cuda_ms(torch, lambda: fs.stage_gmin_scan(x, xsq, bias, q, metric=metric,
                                                           dims=dims))
            k5_plain = cuda_ms(torch, lambda: fs._stage_gmin_scan_ref(x, xsq, bias, q,
                                                                      metric=metric, dims=dims))
            log(f"  K5 stage_gmin_scan {storage} {metric} dims={dims}: err {err:.3g} (atol "
                f"{K5_ATOL[storage]}), {k5:.3f} ms vs plain {k5_plain:.3f} ms {card}")
            if metric == "cosine":
                times[f"k5_{storage}"], times[f"k5_{storage}_plain"] = k5, k5_plain
            if (storage, metric) == ("f32", "cosine"):
                funnel_gmin, funnel_rank = gmin, rank
            del gmin, rank
        del x
    routes = fs.ROUTES["stage_gmin_scan"]
    assert routes == {"direct": fs.LAUNCHES["stage_gmin_scan"], "padded": 0}, routes
    b, n = funnel_rank.shape
    ng = n // fs.GROUP

    def k7_case(mat, gmin, count, label):
        _v, gidx, _ok = select.group_topk(gmin, count)
        gidx = gidx.int()
        out = fs.extract_group_rows(mat, gidx)
        assert torch.equal(out, fs._extract_group_rows_ref(mat, gidx)), f"K7 {label} differs"
        k7 = cuda_ms(torch, lambda: fs.extract_group_rows(mat, gidx))
        k7_kernel = kernel_ms(torch, lambda: fs.extract_group_rows(mat, gidx), "extract_rows")
        k7_plain = cuda_ms(torch, lambda: fs._extract_group_rows_ref(mat, gidx))
        # the one PyTorch call computing the same rows (the port never calls it)
        idx3 = gidx.long()[:, :, None].expand(b, gidx.shape[1], fs.GROUP).contiguous()
        k7_lib = cuda_ms(torch, lambda: torch.gather(mat, 1, idx3))
        log(f"  K7 extract_group_rows {label} [{b}, {gidx.shape[1]}, {fs.GROUP}] "
            f"{mat.dtype}: bit-equal, wrapper {k7:.3f} ms (CUDA events), kernel alone "
            f"{k7_kernel:.4f} ms (torch.profiler) vs plain {k7_plain:.3f} ms, torch.gather "
            f"{k7_lib:.3f} ms {card}")
        return k7, k7_kernel, k7_plain, k7_lib

    k7_case(funnel_rank.view(b, ng, fs.GROUP), funnel_gmin, FUNNEL_C + fs.GROUP_SLACK,
            "funnel")
    del funnel_rank, funnel_gmin
    signs = torch.where(x32 >= 0, 1, -1).to(torch.int8)
    valid8 = (bias == 0).to(torch.int8)
    qsigns = torch.where(q >= 0, 1, -1).to(torch.int8)
    gmin6, ham16 = fs.fused_sign_scan(signs, valid8, qsigns, d=x32.shape[1])
    ref_gmin, ref_ham = fs._fused_sign_scan_ref(signs, valid8, qsigns, d=x32.shape[1])
    assert torch.equal(gmin6, ref_gmin) and torch.equal(ham16, ref_ham), "K6 differs"
    del ref_gmin, ref_ham
    times["k6"] = cuda_ms(torch, lambda: fs.fused_sign_scan(signs, valid8, qsigns,
                                                            d=x32.shape[1]))
    times["k6_plain"] = cuda_ms(torch, lambda: fs._fused_sign_scan_ref(signs, valid8, qsigns,
                                                                       d=x32.shape[1]))
    times["k6_int_mm"] = int_mm_ms(torch, qsigns, signs)
    log(f"  K6 sign_scan d={x32.shape[1]}: bit-equal, {times['k6']:.3f} ms vs plain "
        f"{times['k6_plain']:.3f} ms; product-only yardstick torch._int_mm "
        f"{times['k6_int_mm']:.3f} ms; routes {fs.ROUTES['sign_scan']} {card}")
    times["k7"], times["k7_kernel"], times["k7_plain"], times["k7_lib"] = k7_case(
        ham16.view(b, ng, fs.GROUP), gmin6, QUANT_C, "quantized")
    log(f"  K5 routes {routes} (every K5 call above) {card}")
    return errs, times


def reset_counts(*modules):
    """Zeroes the launch and operand-route counts of the kernel wrappers of
    ``modules`` (``ops.flat_scan``, ``ops.maxsim``) and the launches per
    card (``_build.CARD_LAUNCHES``)."""
    from vettore_tpu_torch import _build

    _build.CARD_LAUNCHES.clear()
    for module in modules:
        for name in module.LAUNCHES:
            module.LAUNCHES[name] = 0
        for routes in module.ROUTES.values():
            for route in routes:
                routes[route] = 0


#: the ``ops.flat_scan`` kernel wrappers this slice's paths run: their launch
#: count names, their plain versions, and how many leading outputs compare
PATH_KERNELS = {
    "gmin_scan": ("gmin_scan", "_gmin_scan_ref", 1),
    "rescore": ("rescore", "_rescore_ref", 0),
    "stage_gmin_scan": ("stage_gmin_scan", "_stage_gmin_scan_ref", 2),
    "fused_sign_scan": ("sign_scan", "_fused_sign_scan_ref", 2),
    "extract_group_rows": ("extract_group_rows", "_extract_group_rows_ref", 0),
    # ops.maxsim's scan (phase 7 holds it at the mesh's shard shapes)
    "maxsim_rank_scan": ("maxsim_rank_scan", "_maxsim_rank_scan_ref", 0),
}


def _signature(args, kwargs):
    return tuple((tuple(a.shape), a.dtype, str(a.device)) if hasattr(a, "shape") else a
                 for a in args) + tuple(sorted(kwargs.items()))


class PathCalls:
    """Within ``with PathCalls(fs, ms) as calls:``, records the operands of
    the first call of each ``PATH_KERNELS`` wrapper per operand shape, type,
    device and option (``ops.maxsim`` binds ``extract_group_rows`` by name, so it
    is patched there too). ``check`` then calls each wrapper again on those
    operands and holds it against its plain version."""

    def __init__(self, fs, *holders):
        self.fs, self.holders, self.calls = fs, (fs, *holders), {}

    def __enter__(self):
        self.saved = [(h, name, getattr(h, name)) for h in self.holders
                      for name in PATH_KERNELS if hasattr(h, name)]
        for holder, name, fn in self.saved:
            setattr(holder, name, self._recording(name, fn))
        return self

    def __exit__(self, *exc):
        for holder, name, fn in self.saved:
            setattr(holder, name, fn)

    def _recording(self, name, fn):
        def call(*args, **kwargs):
            self.calls.setdefault((name, _signature(args, kwargs)), (args, kwargs))
            return fn(*args, **kwargs)
        return call

    def check(self, torch, path, card):
        """Each recorded call's wrapper against its plain version on the same
        operands: K6 and K7 bit-equal, K1, K2 and K5 within their
        tolerances (K5 over MUVERA's FDE block relative, as its row). Returns
        the max abs and max relative errors by launch count name."""
        errs, rels = {}, {}
        for (name, _sig), (args, kwargs) in self.calls.items():
            count, ref, outs = PATH_KERNELS[name]
            holder = next(h for h in self.holders if hasattr(h, ref))
            got = getattr(holder, name)(*args, **kwargs)
            if count == "maxsim_rank_scan" and args[0].dtype == torch.bfloat16:
                # the wrapper rounds the queries of a bf16 block to bf16
                args = (*args[:3], args[3].to(torch.bfloat16).float(), *args[4:])
            want = getattr(holder, ref)(*args, **kwargs)
            if outs:
                got = got[:outs]
                want = (want,) if outs == 1 else want
            else:
                got, want = (got,), (want,)
            storage = "bf16" if args[0].dtype == torch.bfloat16 else "f32"
            err = rel = 0.0
            for g, w in zip(got, want):
                if count in ("sign_scan", "extract_group_rows"):
                    assert torch.equal(g, w), f"{path}: {name} differs from its plain version"
                    continue
                a, e = abs_rel_err(g, w)
                err, rel = max(err, a), max(rel, e)
            if count == "gmin_scan":
                assert err <= K1_ATOL[storage], f"{path}: K1 {storage} err {err}"
            elif count == "rescore":
                assert err <= K2_ATOL, f"{path}: K2 err {err}"
            elif count == "stage_gmin_scan" and kwargs["metric"] == "inner_product":
                assert rel <= MV_RTOL["bf16"], f"{path}: K5 on the FDE block rel err {rel}"
            elif count == "maxsim_rank_scan":
                assert rel <= MV_RTOL[storage], f"{path}: MaxSim {storage} rel err {rel}"
            elif count == "stage_gmin_scan":
                assert err <= K5_ATOL[storage], f"{path}: K5 {storage} err {err}"
            errs[count] = max(errs.get(count, 0.0), err)
            rels[count] = max(rels.get(count, 0.0), rel)
            shapes = ", ".join(f"{list(a.shape)} {str(a.dtype).removeprefix('torch.')}"
                               for a in args if hasattr(a, "shape") and a.dim() > 1)
            log(f"  {path}: {name} at [{shapes}] {kwargs or ''} against its plain version: "
                f"abs err {err:.3g}, rel err {rel:.3g} {card}")
            del got, want
        return errs, rels


def distinct_rows(gidx):
    """Rows of the distinct 64-row groups ``gidx`` selects: what a rescore
    must read at least once."""
    return int(gidx.unique().numel()) * 64


def rescore_bytes(rows, d, elt, b, gsel, *, metric, scaled=False):
    """Bytes a rescore must move: ``rows`` distinct selected rows of ``d``
    elements of ``elt`` bytes with the side values its metric reads (the
    bias; int8's scale when ``scaled``; the row norm only for l2), the
    queries (with their norms for l2) and ``gidx``, and the ``[B, gsel,
    64]`` f32 ranks it writes."""
    l2 = metric in ("l2", "l2_squared")
    return rows * (elt * d + 4 * (1 + scaled + l2)) + 4 * b * (d + l2 + gsel + gsel * 64)


def sharing(gidx):
    """The rescore's pairs, the distinct groups they select and the mean
    number of pairs per distinct group, as a log fragment."""
    pairs, groups = gidx.numel(), distinct_rows(gidx) // 64
    return f"P {pairs}, distinct groups {groups}, sharing {pairs / groups:.2f}"


def mass_sharing(torch, fs, select, x32, xsq, bias, q, card):
    """K2 (f32 and bf16 rows) and K4 on 512 copies of one query, all
    selecting its 24 best groups (each group shared by every pair of one
    run), against their plain versions at the main size. Returns (max abs
    errors, max relative errors) by kernel row name."""
    qm = q[:1].expand_as(q).contiguous()
    gmin = fs._gmin_scan_ref(x32, xsq, bias, qm[:1], metric="cosine")
    _v, g1, _ok = select.group_topk(gmin, 16 + fs.GROUP_SLACK, check_c=16)
    gidx = g1.int().expand(qm.shape[0], -1).contiguous()
    errs, rel = {}, {}
    for name in ("rescore", "rescore_bf16"):
        x = x32 if name == "rescore" else x32.to(torch.bfloat16)
        got = fs.rescore(x, xsq, bias, qm, gidx, metric="l2")
        a, _rel = abs_rel_err(got, fs._rescore_ref(x, xsq, bias, qm, gidx, metric="l2"))
        assert a <= K2_ATOL, f"K2 {name} mass sharing err {a}"
        errs[name] = a
        ms = cuda_ms(torch, lambda: fs.rescore(x, xsq, bias, qm, gidx, metric="l2"))
        log(f"  K2 {name} mass sharing: err {a:.3g} (atol {K2_ATOL}), {ms:.3f} ms; "
            f"{sharing(gidx)} {card}")
        del x, got
    x8, scale = fs.quantize_rows(x32)
    got = fs.int8_rescore(x8, scale, xsq, bias, qm, gidx, metric="l2")
    a, e = abs_rel_err(got, fs._int8_rescore_ref(x8, scale, xsq, bias, qm, gidx, metric="l2"))
    assert e <= K4_RTOL, f"K4 mass sharing err {e}"
    errs["int8_rescore"], rel["int8_rescore"] = a, e
    ms = cuda_ms(torch, lambda: fs.int8_rescore(x8, scale, xsq, bias, qm, gidx, metric="l2"))
    log(f"  K4 int8_rescore mass sharing: abs err {a:.3g}, rel err {e:.3g} (rtol {K4_RTOL}), "
        f"{ms:.3f} ms; {sharing(gidx)} {card}")
    return errs, rel


def int8_kernels(torch, fs, select, x32, bias, q, card):
    """Phase 2c, int8: K3 (bit-equal) and K4 against their plain versions at
    the main path's shapes. Returns (max abs errors, max relative errors,
    times and bounds of the cosine configuration)."""
    n, d = x32.shape
    b = q.shape[0]
    x8, scale = fs.quantize_rows(x32)
    xsq = (x32 * x32).sum(dim=1)
    q8, qscale = fs.quantize_rows(q)
    qsq = (q * q).sum(dim=1)
    errs = {"int8_gmin_scan": 0.0, "int8_rescore": 0.0}
    rel = {"int8_rescore": 0.0}
    out = {}
    for metric in ("cosine", "l2"):
        args = (x8, scale, xsq, bias, q8, qscale, qsq)
        gmin, bounded = fs.int8_gmin_scan(*args, metric=metric)
        ref = fs._int8_gmin_scan_ref(*args, metric=metric)
        assert bool(bounded) and torch.equal(gmin, ref), f"K3 {metric} is not bit-equal"
        _v, gidx, _ok = select.group_topk(ref, 16 + fs.GROUP_SLACK, check_c=16)
        gidx = gidx.int()
        del ref, gmin
        resc = fs.int8_rescore(x8, scale, xsq, bias, q, gidx, metric=metric)
        a4, e4 = abs_rel_err(resc, fs._int8_rescore_ref(x8, scale, xsq, bias, q, gidx,
                                                        metric=metric))
        assert e4 <= K4_RTOL, f"K4 {metric} err {e4}"
        errs["int8_rescore"] = max(errs["int8_rescore"], a4)
        rel["int8_rescore"] = max(rel["int8_rescore"], e4)
        t = {
            "k3": cuda_ms(torch, lambda: fs.int8_gmin_scan(*args, metric=metric)),
            "k3_plain": cuda_ms(torch, lambda: fs._int8_gmin_scan_ref(*args, metric=metric)),
            "k4": cuda_ms(torch, lambda: fs.int8_rescore(x8, scale, xsq, bias, q, gidx,
                                                         metric=metric)),
            "k4_plain": cuda_ms(torch, lambda: fs._int8_rescore_ref(x8, scale, xsq, bias, q,
                                                                    gidx, metric=metric)),
        }
        t["k3_int_mm"] = int_mm_ms(torch, q8, x8)
        log(f"  K3 int8_gmin_scan {metric}: bit-equal, {t['k3']:.3f} ms vs plain "
            f"{t['k3_plain']:.3f} ms, product-only yardstick torch._int_mm "
            f"{t['k3_int_mm']:.3f} ms, routes {fs.ROUTES['int8_gmin_scan']} "
            f"| K4 int8_rescore: abs err {a4:.3g}, rel err {e4:.3g} "
            f"(rtol {K4_RTOL}), "
            f"{t['k4']:.3f} ms vs plain {t['k4_plain']:.3f} ms; {sharing(gidx)} {card}")
        if metric == "cosine":
            gsel = gidx.shape[1]
            t["k3_bound"] = bound(2 * n * d * b, "int8",
                                  n * d + 3 * 4 * n + b * d + 8 * b + 4 * b * (n // 64))
            t["k4_bound"] = bound(2 * b * gsel * 64 * d, "f32",
                                  rescore_bytes(distinct_rows(gidx), d, 1, b, gsel,
                                                metric=metric, scaled=True))
            out = t
    return errs, rel, out


def mv_block(torch, dev, gen, n, t, d, dtype):
    """A config-5-shaped token block on the card: doc centres plus token
    noise 0.3/sqrt(d), in ``dtype``."""
    centres = torch.randn((n, 1, d), generator=gen, device=dev)
    centres /= centres.norm(dim=2, keepdim=True)
    noise = torch.randn((n, t, d), generator=gen, device=dev) * (0.3 / d ** 0.5)
    return (centres + noise).to(dtype)


def maxsim_kernels(torch, ms, card):
    """Phase 2c, MaxSim: the kernel against its plain version at config 5's
    shape (cap of 100,000 docs, 32 tokens, d = 128, 64 sets of 4 tokens).
    Returns (max abs errors, max relative errors, times and bounds of the
    full bf16 and full f32 cases), by kernel row name."""
    from vettore_tpu_torch.collection import _cap_at_least

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, t, d, b, nq = _cap_at_least(MV_N), MV_T, MV_D, MV_B, MV_Q
    qt = torch.randn((b * nq, d), generator=gen, device=dev)
    qt /= qt.norm(dim=1, keepdim=True)
    qinv = 1.0 / qt.norm(dim=1)
    err = {"maxsim_rank_scan": 0.0, "maxsim_rank_scan_f32": 0.0}
    rel, out = dict(err), {}
    for label, dtype, ragged in (("full bf16", torch.bfloat16, False),
                                 ("full f32", torch.float32, False),
                                 ("ragged f32", torch.float32, True)):
        tokens = mv_block(torch, dev, gen, n, t, d, dtype)
        counts = torch.full((n,), t, dtype=torch.int32, device=dev)
        dbias = torch.zeros(n, device=dev)
        if ragged:
            counts = torch.randint(0, t + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
            tokens[torch.arange(t, device=dev)[None, :] >= counts[:, None]] = 0
            dbias[torch.randperm(n, generator=gen, device=dev)[: n // 50]] = float("inf")
        qs = qt.to(torch.bfloat16).float() if dtype == torch.bfloat16 else qt
        _tsq, tinv = ms.token_norms(tokens)  # as the scan cache keeps them
        args = (tokens, counts, dbias, qt, qinv)
        before = dict(ms.ROUTES["maxsim_rank_scan"])
        rank = ms.maxsim_rank_scan(*args, b=b, metric="cosine", tinv=tinv)
        assert ms.ROUTES["maxsim_rank_scan"]["direct"] == before["direct"] + 1, ms.ROUTES
        storage = "bf16" if dtype == torch.bfloat16 else "f32"
        name = "maxsim_rank_scan" if storage == "bf16" else "maxsim_rank_scan_f32"
        a, e = abs_rel_err(rank, ms._maxsim_rank_scan_ref(tokens, counts, dbias, qs, qinv, b=b,
                                                          metric="cosine", tinv=tinv))
        assert e <= MV_RTOL[storage], f"MaxSim {label} err {e}"
        err[name], rel[name] = max(err[name], a), max(rel[name], e)
        k = cuda_ms(torch, lambda: ms.maxsim_rank_scan(*args, b=b, metric="cosine", tinv=tinv))
        plain = cuda_ms(torch, lambda: ms._maxsim_rank_scan_ref(tokens, counts, dbias, qs, qinv,
                                                               b=b, metric="cosine", tinv=tinv),
                        reps=3)
        # bf16 products on the tensor cores; f32 blocks three TF32 products
        # (3xTF32) against the query's two parts
        ops = 2 * n * t * d * b * nq
        qbytes = b * nq * d * (2 if storage == "bf16" else 8)
        nbytes = (tokens.numel() * tokens.element_size() + 4 * n * t + 4 * 2 * n + qbytes
                  + 4 * b * nq + 4 * b * n)
        bnd = bound(ops, "bf16", nbytes) if storage == "bf16" else bound(3 * ops, "tf32", nbytes)
        log(f"  maxsim_rank_scan {label} [{n}, {t}, {d}] x [{b} x {nq}]: abs err {a:.3g}, "
            f"rel err {e:.3g} (rtol "
            f"{MV_RTOL[storage]}), {k:.3f} ms vs plain {plain:.3f} ms; bound {bnd[0]:.3f} ms "
            f"({bnd[1]}) {card}")
        if not ragged:
            out[name] = {"ms": k, "plain_ms": plain, "bound": bnd}
        del tokens, rank, tinv, args
        torch.cuda.empty_cache()
    return err, rel, out


def int8_view(torch, col, queries, exact, card):
    """Phase 4c: ``storage_view("int8")`` of phase 4's index. Returns the
    launch counts of the run that drove it."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops.distance import normalize_rows

    t1 = time.perf_counter()
    view = col.index.storage_view("int8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t1
    assert view._device[0].dtype == torch.int8 and view._fused_eligible(16)
    prepared = normalize_rows(queries, "l2")
    reset_counts(fs)
    got = view.search_batch(prepared, 10)
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    assert launches["int8_gmin_scan"] > 0 and launches["int8_rescore"] > 0, launches
    routes = dict(fs.ROUTES["int8_gmin_scan"])
    assert routes == {"direct": launches["int8_gmin_scan"], "padded": 0}, routes
    k4_routes = dict(fs.ROUTES["int8_rescore"])
    assert k4_routes == {"direct": launches["int8_rescore"], "narrow": 0}, k4_routes
    assert view.host_routes == 0, f"host routes: {view.host_routes}"
    hits = [len({h[0] for h in a} & {r.id for r in w}) / 10 for a, w in zip(got, exact)]
    overlap = float(np.mean(hits[:32]))
    assert overlap >= INT8_OVERLAP_MIN, f"int8 overlap@10 {overlap}"
    qdev = torch.from_numpy(prepared).to(col.device)
    ms_dev = host_ms(torch, lambda: view.search_batch_device(qdev, 10))
    log(f"  int8 view: quantized on the card in {quant_s:.1f}s; overlap@10 against exact f32 "
        f"on 32 queries {overlap:.4f} (all {len(queries)}: {np.mean(hits):.4f}); "
        f"search_batch_device B={len(queries)} {ms_dev:.3f} ms; K3 routes {routes}, K4 routes "
        f"{k4_routes} {card}")
    profile_runs(torch, {"int8 view device": lambda: view.search_batch_device(qdev, 10)}, card)
    return launches, overlap, ms_dev


def bf16_round(torch, a):
    """f32 values rounded to the nearest bf16 (ties to even)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def maxsim_oracle(docs, sets, ids, limit, lens=None, chunk=8192):
    """Exact cosine MaxSim in float64 of every doc (``docs`` [N, T, d], the
    first ``lens[n]`` tokens live, all when ``lens`` is None) against each
    query set; the top ``limit + 4`` by (score desc, id). Returns ``[(ids,
    scores)]``."""
    q = np.concatenate(sets).astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    bounds = np.cumsum([0] + [len(s) for s in sets])
    n, t, d = docs.shape
    totals = np.empty((n, len(sets)))
    for s in range(0, n, chunk):
        c = docs[s:s + chunk].astype(np.float64).reshape(-1, d)
        norms = np.linalg.norm(c, axis=1, keepdims=True)
        sims = (c @ q.T) / np.where(norms > 0, norms, 1.0)
        sims = sims.reshape(-1, t, q.shape[0])
        if lens is not None:
            live = np.arange(t)[None, :] < lens[s:s + chunk, None]
            sims = np.where(live[:, :, None], sims, -np.inf)
        best = sims.max(axis=1)  # [chunk, all query tokens]
        totals[s:s + chunk] = np.add.reduceat(best, bounds[:-1], axis=1)
    out = []
    for j in range(len(sets)):
        cand = np.argpartition(-totals[:, j], limit + 4)[: limit + 4]
        order = sorted(cand, key=lambda i: (-totals[i, j], ids[i]))
        out.append(([ids[i] for i in order], [float(totals[i, j]) for i in order]))
    return out


def profile_split(torch, fn, card, reps=3):
    """``torch.profiler`` device time of ``fn`` per call, split into the
    MaxSim kernel, K7, sorts, gathers and the rest, with the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps
    parts = {"maxsim_rank_scan": 0.0, "K7 extract_group_rows": 0.0, "sorts": 0.0,
             "gathers": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            continue
        name = e.key.lower()
        part = ("maxsim_rank_scan" if "maxsim" in name else
                "K7 extract_group_rows" if "extract_rows" in name else
                "sorts" if "sort" in name else
                "gathers" if "gather" in name or "index" in name else "other")
        parts[part] += e.self_device_time_total / 1e3 / reps
    busy = sum(parts.values())
    log(f"  profile MaxSim device batch: device busy {busy:.3f} ms per call, wall {wall:.3f} "
        f"ms, idle {max(0.0, 1 - busy / wall):.1%}; " +
        ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) + f" (ms per call) {card}")
    return busy, wall


def maxsim_config5(torch, vt, rng, card):
    """Phase 6: BASELINE config 5's exact MaxSim through ``Collection``.
    Returns the launch counts of the run, its ms per device and sync batch,
    and what phase 6b reuses: the collection, the token block (host, id
    order), the ids, the query vectors and sets, and the exact results of
    the first batch."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    docs = clustered(rng, MV_N, MV_D)
    noise = np.float32(0.3 / np.sqrt(MV_D))
    tokens = np.empty((MV_N, MV_T, MV_D), np.float32)
    for s in range(0, MV_N, 10_000):  # bounded temporaries
        part = docs[s:s + 10_000, None, :] + noise * rng.standard_normal(
            (min(10_000, MV_N - s), MV_T, MV_D), dtype=np.float32)
        tokens[s:s + 10_000] = bf16_round(torch, part)
    queries = near_queries(rng, docs, MV_SETS)
    sets = [bf16_round(torch, qv[None, :] + noise * rng.standard_normal((MV_Q, MV_D),
                                                                       dtype=np.float32))
            for qv in queries]
    ids = [f"mv-{i:06d}" for i in range(MV_N)]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    col = vt.Collection(name="config-5", dimensions=MV_D, metric="cosine", index="flat",
                        normalize="none", device=dev)
    col.put_tokens(ids, tokens)
    cache = col._scan_cache()
    block, counts = cache.multi_vectors()
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    assert block.dtype == torch.bfloat16 and bool((counts[:MV_N] == MV_T).all()), block.dtype
    assert ms.supports_fused("cosine", cache.cap, MV_Q)
    query_sets = [s.tolist() for s in sets]
    reset_counts(fs, ms)
    got = []
    for lo in range(0, MV_SETS, MV_B):
        got += col.multi_vector_search_batch(query_sets[lo:lo + MV_B], limit=10)
    single = col.multi_vector_search(query_sets[0], limit=10)
    torch.cuda.synchronize()
    launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    assert launches["maxsim_rank_scan"] == MV_SETS // MV_B + 1, launches
    routes = dict(ms.ROUTES["maxsim_rank_scan"])
    assert routes == {"direct": launches["maxsim_rank_scan"], "padded": 0}, routes
    assert [r.id for r in single] == [r.id for r in got[0]], "single set != batch"
    assert launches["maxsim_rank_scan"] > 0 and launches["extract_group_rows"] > 0, launches
    assert col.host_routes == 0, f"host routes: {col.host_routes}"
    t0 = time.perf_counter()
    want = maxsim_oracle(tokens, sets[:MV_ORACLE_SETS], ids, 10)
    oracle_s = time.perf_counter() - t0
    swaps = sum(check_hits([(r.id, r.score) for r in row], w, 10)
                for row, w in zip(got[:MV_ORACLE_SETS], want))
    qtok, qmask = col._pad_query_sets(query_sets[:MV_B])
    qtok, qmask = torch.from_numpy(qtok).to(dev), torch.from_numpy(qmask).to(dev)
    valid = cache.valid_mask()

    norms = cache.token_norms()

    def device_batch():
        return ms.fused_maxsim_topk_batch(block, counts, valid, qtok, qmask, metric="cosine",
                                          limit=10, norms=norms)

    assert bool(device_batch()[2].all()), "a device batch flagged ok False"
    ms_dev = host_ms(torch, device_batch)
    ms_sync = host_ms(torch, lambda: col.multi_vector_search_batch(query_sets[:MV_B], limit=10),
                      reps=3)
    ms_single = host_ms(torch, lambda: col.multi_vector_search(query_sets[0], limit=10), reps=3)
    log(f"  corpus {MV_N}x{MV_T}x{MV_D} made in {gen_s:.1f}s; put_tokens + bf16 token block "
        f"{ingest_s:.1f}s; ms per batch of {MV_B} sets: device {ms_dev:.3f}, sync (hydrated) "
        f"{ms_sync:.3f}; single-set multi_vector_search {ms_single:.3f} ms {card}")
    split = profile_split(torch, device_batch, card)
    log(f"  ids equal the f64 oracle on {MV_ORACLE_SETS} sets ({swaps} near-tie swaps; oracle "
        f"{oracle_s:.1f}s); single-set search == its batch row; host routes 0; launches "
        f"{launches}; MaxSim routes {routes}")
    state = {"col": col, "tokens": tokens, "ids": ids, "queries": queries, "sets": query_sets,
             "exact": got[:MV_B], "timing": (ms_dev, *split)}
    return launches, ms_dev, ms_sync, state


def maxsim_ragged(torch, vt, rng, query_sets, card):
    """Phase 6, second part: a small ragged corpus (an f32 token block: the
    MaxSim kernel's 3xTF32 instance) against the float64 oracle. Returns its
    launch counts."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms

    dev = torch.device(DEVICE)
    noise = np.float32(0.3 / np.sqrt(MV_D))
    sets = [np.asarray(s, np.float32) for s in query_sets[:MV_ORACLE_SETS]]
    n, ids = 3000, [f"rg-{i:05d}" for i in range(3000)]
    lens = rng.integers(1, MV_T + 1, n)
    docs = clustered(rng, n, MV_D)
    ragged = [docs[i] + noise * rng.standard_normal((lens[i], MV_D), dtype=np.float32)
              for i in range(n)]
    col = vt.Collection(name="ragged", dimensions=MV_D, metric="cosine", index="flat",
                        normalize="none", device=dev)
    col.put_many([{"id": i, "vectors": list(v)} for i, v in zip(ids, ragged)])
    reset_counts(fs, ms)
    got = col.multi_vector_search_batch(query_sets[:MV_ORACLE_SETS], limit=10)
    torch.cuda.synchronize()
    ragged_launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    block, counts = col._scan_cache().multi_vectors()
    assert block.dtype == torch.float32 and (counts[:n] < MV_T).any(), block.dtype
    assert ragged_launches["maxsim_rank_scan"] == 1, ragged_launches
    assert ms.ROUTES["maxsim_rank_scan"] == {"direct": 1, "padded": 0}, ms.ROUTES
    assert col.host_routes == 0
    padded = np.zeros((n, MV_T, MV_D), np.float32)
    for i, v in enumerate(ragged):
        padded[i, : len(v)] = v
    want = maxsim_oracle(padded, sets, ids, 10, lens=lens)
    swaps_r = sum(check_hits([(r.id, r.score) for r in row], w, 10)
                  for row, w in zip(got, want))
    log(f"  ragged corpus ({n} docs of 1..{MV_T} tokens, f32 block): ids equal the f64 "
        f"oracle on {MV_ORACLE_SETS} sets ({swaps_r} near-tie swaps); launches "
        f"{ragged_launches}, MaxSim routes {ms.ROUTES['maxsim_rank_scan']} {card}")
    col.close()
    return ragged_launches


def quantized_oracle(stored, q, count, limit):
    """Config 3 in float64 numpy: Hamming on the packed sign bits, the
    ``count`` best rows by (hamming, id), then the exact cosine top
    ``limit + 4`` by (score desc, id). Rows are in id order. Returns
    ``[(slots, scores)]``."""
    return [_cosine_top(stored, cand, q[b], limit)
            for b, cand in enumerate(hamming_candidates(stored, q, count))]


def hamming_candidates(stored, q, count):
    """The quantized generator in numpy: per query, the ``count`` rows of
    ``stored`` (id order) with the fewest sign bits unlike the query's, by
    (hamming, id)."""
    bits = np.packbits(stored >= 0.0, axis=1, bitorder="little")
    qbits = np.packbits(q >= 0.0, axis=1, bitorder="little")
    if bits.shape[1] % 8 == 0 and hasattr(np, "bitwise_count"):  # numpy >= 2
        words, qwords = bits.view(np.uint64), qbits.view(np.uint64)

        def hamming(b):
            return np.bitwise_count(words ^ qwords[b]).sum(axis=1, dtype=np.int64)
    else:
        table = np.array([bin(v).count("1") for v in range(256)], np.int64)

        def hamming(b):
            return table[bits ^ qbits[b]].sum(axis=1)
    return [_smallest(hamming(b), count)[:count] for b in range(q.shape[0])]


def _smallest(key, count):
    """Row indices in (key, index) order, at least the ``count + 1`` first
    (every row whose key ties the (count+1)-th is kept, so ties resolve by
    index exactly)."""
    kth = np.partition(key, count)[count]
    cand = np.flatnonzero(key <= kth)
    return cand[np.lexsort((cand, key[cand]))]


def funnel_oracle(stored, q, dims, count, limit):
    """Config 4 in float64 numpy: the ``count`` best rows by (prefix cosine
    rank, id) over the first ``dims`` columns, then the exact cosine top
    ``limit + 4``. Later stages keep all ``count`` candidates (they only
    reorder), so the stage-1 set is the final rerank's input. Returns
    ``([(slots, scores)], number of queries whose count-th and next ranks
    lie within TIE_EPS)``."""
    xp = stored[:, :dims].astype(np.float64)
    qp = q[:, :dims].astype(np.float64)
    sims = (xp @ qp.T) / (np.linalg.norm(xp, axis=1)[:, None] * np.linalg.norm(qp, axis=1))
    rank = 1.0 - np.clip(sims, -1.0, 1.0)
    out, near = [], 0
    for b in range(q.shape[0]):
        order = _smallest(rank[:, b], count)
        near += int(rank[order[count], b] - rank[order[count - 1], b] < TIE_EPS)
        out.append(_cosine_top(stored, order[:count], q[b], limit))
    return out, near


def _cosine_top(stored, cand, qv, limit):
    rows = stored[cand].astype(np.float64)
    q64 = qv.astype(np.float64)
    sims = rows @ q64 / (np.linalg.norm(rows, axis=1) * np.linalg.norm(q64))
    order = sorted(range(len(cand)), key=lambda i: (-sims[i], cand[i]))[: limit + 4]
    return [int(cand[i]) for i in order], [float(sims[i]) for i in order]


def adaptive_modes(torch, col, stored, queries, exact, card):
    """Phase 4b: BASELINE configs 3 (quantized) and 4 (funnel) through
    ``Collection`` at the headline scale; ``stored`` is the collection's
    (normalised) corpus in id order. Returns the launch counts of the run
    that drove both modes."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops.distance import normalize_rows

    prepared = normalize_rows(queries, "l2")
    qdev = torch.from_numpy(prepared).to(col.device)
    quant = dict(limit=10, candidates=QUANT_C)
    funnel = dict(limit=10, candidates=FUNNEL_C, stages=list(FUNNEL_STAGES))
    t1 = time.perf_counter()
    cache = col._scan_cache()
    assert cache._x[0] is col.index._device[0], "the scan cache did not share the index block"
    cache.signs()
    cache.stage_xsq(FUNNEL_STAGES[0])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t1
    reset_counts(fs)
    got_q = col.quantized_search_batch(queries, **quant)
    got_f = col.funnel_search_batch(queries, **funnel)
    dev_q = col.results_from_device(col.quantized_search_batch_device(qdev, **quant))
    dev_f = col.results_from_device(col.funnel_search_batch_device(qdev, **funnel))
    torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    for name in ("stage_gmin_scan", "sign_scan", "extract_group_rows"):
        assert launches[name] > 0, f"{name} not launched: {launches}"
    for name in ("stage_gmin_scan", "sign_scan"):
        assert fs.ROUTES[name] == {"direct": launches[name], "padded": 0}, fs.ROUTES
    assert col.host_routes == 0, f"host routes: {col.host_routes}"

    def ids(rows):
        return [[r.id for r in row] for row in rows]

    assert ids(dev_q) == ids(got_q) and ids(dev_f) == ids(got_f), "device path differs"
    ids_all = [f"doc-{i:07d}" for i in range(stored.shape[0])]
    m = N_ADAPTIVE_ORACLE
    t1 = time.perf_counter()
    want_q = quantized_oracle(stored, prepared[:m], QUANT_C, 10)
    want_f, near = funnel_oracle(stored, prepared[:m], FUNNEL_STAGES[0], FUNNEL_C, 10)
    oracle_s = time.perf_counter() - t1
    swaps = {}
    for mode, got_rows, want in (("quantized", got_q, want_q), ("funnel", got_f, want_f)):
        swaps[mode] = sum(
            check_hits([(r.id, r.score) for r in row], ([ids_all[s] for s in w[0]], w[1]), 10)
            for row, w in zip(got_rows[:m], want))
    ms = {
        "quantized device": host_ms(torch, lambda: col.quantized_search_batch_device(
            qdev, **quant)),
        "funnel device": host_ms(torch, lambda: col.funnel_search_batch_device(qdev, **funnel)),
        "quantized sync": host_ms(torch, lambda: col.quantized_search_batch(queries, **quant),
                                  reps=3),
        "funnel sync": host_ms(torch, lambda: col.funnel_search_batch(queries, **funnel),
                               reps=3),
    }
    assert col.host_routes == 0
    prof = profile_runs(torch, {
        "quantized device": lambda: col.quantized_search_batch_device(qdev, **quant),
        "funnel device": lambda: col.funnel_search_batch_device(qdev, **funnel),
    }, card)

    def overlap(rows):
        return float(np.mean([len({r.id for r in a} & {r.id for r in b}) / 10
                              for a, b in zip(rows, exact)]))

    log(f"  cache set-up (bits, signs, prefix norms) {setup_s:.1f}s; ms per batch of "
        f"{len(queries)}: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" {card}")
    log(f"  ids equal the f64 oracles on {m} queries (near-tie swaps: quantized "
        f"{swaps['quantized']}, funnel {swaps['funnel']}; funnel stage-1 boundaries within "
        f"{TIE_EPS}: {near}; oracles {oracle_s:.1f}s); host routes 0; overlap@10 against "
        f"exact flat: quantized {overlap(got_q):.4f}, funnel {overlap(got_f):.4f}; "
        f"launches {launches}")

    # the funnel over bf16 rows: the pipeline's entry point on a bf16 copy
    # of the block (K5's Bf16 policy; its stage 1 selects with bf16 dots)
    from vettore_tpu_torch.ops import pipeline as pipe

    x, valid = cache.vectors()
    x16 = x.to(torch.bfloat16)
    xsq16 = (x16[:, :FUNNEL_STAGES[0]].float() ** 2).sum(dim=1)

    def funnel16():
        return pipe.funnel_pipeline_batch(x16, valid, qdev, xsq16, metric="cosine",
                                          stages=FUNNEL_STAGES, count=FUNNEL_C, limit=10)

    reset_counts(fs)
    slots16, _raws, _ranks, ok16 = funnel16()
    torch.cuda.synchronize()
    launches16 = dict(fs.LAUNCHES)
    assert launches16["stage_gmin_scan"] == 1 and bool(ok16.all()), launches16
    assert fs.ROUTES["stage_gmin_scan"] == {"direct": 1, "padded": 0}, fs.ROUTES
    got16 = slots16[:m].cpu().numpy()
    same = np.mean([len(set(got16[i].tolist()) & set(want_f[i][0][:10])) / 10 for i in range(m)])
    ms16 = host_ms(torch, funnel16)
    log(f"  funnel over a bf16 block (funnel_pipeline_batch): overlap@10 with the f64 funnel "
        f"oracle {same:.4f} on {m} queries, {ms16:.3f} ms per batch of {len(queries)}, "
        f"launches {launches16}, K5 routes {fs.ROUTES['stage_gmin_scan']} {card}")
    del x16, xsq16
    return launches, launches16, {"got_q": got_q, "got_f": got_f, "ms": ms, "profile": prof}


def in_rank_id_order(hits, tol=HNSW_ORDER_TOL):
    """Whether cosine hits ``[(id, raw)]`` come in (rank, id) order: raw
    scores do not rise by more than ``tol`` from one hit to the next (the
    search orders by f32 ranks and recomputes the raw scores by another
    f32 sum), and exactly equal scores come in id order."""
    return all(ra >= rb - tol and (ra != rb or ia < ib)
               for (ia, ra), (ib, rb) in zip(hits, hits[1:]))


def hnsw_hits_check(graph, slots, raws, rows_of, prepared):
    """HNSW results against float64: every raw score within HNSW_RAW_TOL of
    the f64 dot of its id's stored row (``rows_of(ids)``) with its
    (normalised) query, and each query's hits in (rank, id) order. Returns
    (id lists, max raw error)."""
    got, err = [], 0.0
    for b, (row_slots, row_raws) in enumerate(zip(slots.cpu().tolist(), raws.cpu().tolist())):
        hits = [(graph.ids[s], r) for s, r in zip(row_slots, row_raws) if s >= 0]
        ids = [h[0] for h in hits]
        rows = rows_of(ids).astype(np.float64)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        want = rows @ prepared[b].astype(np.float64)
        err = max(err, float(np.abs(np.array([h[1] for h in hits]) - want).max()))
        assert in_rank_id_order(hits), f"query {b}: hits not in (rank, id) order"
        got.append(ids)
    assert err <= HNSW_RAW_TOL, f"HNSW raw scores off by {err}"
    return got, err


class Spans:
    """Wall seconds of calls to ``(module, name)`` functions while active,
    each ended by a device synchronise: ``{name: [seconds per call]}``."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.seconds = torch, targets, {}

    def __enter__(self):
        self.saved = [(module, name, getattr(module, name)) for module, name in self.targets]
        for module, name, fn in self.saved:
            setattr(module, name, self._timed(name, fn))
        return self.seconds

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def recall_at(got, want, k=10):
    return float(np.mean([len(set(g[:k]) & set(w[:k])) / k for g, w in zip(got, want)]))


def f64_top(torch, rows, live, ids, q, limit):
    """Exact cosine top ``limit + 4`` of each query over the ``live`` rows of
    ``rows`` (an f32 tensor on the card), in float64 on the card, chunked
    over rows; ordered by (score desc, id asc): ``[(ids, scores)]``. An
    oracle independent of the code under test."""
    dev, width = rows.device, limit + 4
    q64 = torch.from_numpy(q).to(dev).double()
    q64 /= q64.norm(dim=1, keepdim=True)
    best_s, best_i = [], []
    for s in range(0, rows.shape[0], 1 << 17):
        c = rows[s:s + (1 << 17)].double()
        sims = q64 @ (c / c.norm(dim=1, keepdim=True)).T
        sims.masked_fill_(~live[s:s + (1 << 17)][None, :], float("-inf"))
        v, i = sims.topk(min(width, sims.shape[1]), dim=1)
        best_s.append(v)
        best_i.append(i + s)
    v, pos = torch.cat(best_s, dim=1).topk(width, dim=1)
    i = torch.cat(best_i, dim=1).gather(1, pos)
    out = []
    for row_v, row_i in zip(v.cpu().tolist(), i.cpu().tolist()):
        order = sorted(range(width), key=lambda k: (-row_v[k], ids[row_i[k]]))
        out.append(([ids[row_i[k]] for k in order], [row_v[k] for k in order]))
    return out


def hnsw_writes(torch, vt, rng, col, corpus, queries, card):
    """Phase 4f: writes to config 2's kNN-built 1M x 768 graph (phase 4d's
    collection) on the card, then the wave build and a compaction.

    A ``put`` of one new row (the migration into mutable form plus one
    wave), a ``put_many`` of 8,192 new clustered rows (one full wave; a
    second such batch traced by ``torch.profiler``), and a replace of an
    existing id through ``HnswIndex.put``; searches of 512 queries near the
    new rows and of phase 4's 512 against a float64 oracle over the live
    rows (recall@10, raw scores, (rank, id) order, the replaced id's new
    vector); 10,000 deletes through ``HnswIndex.delete`` (the collection's
    in-memory store copies its whole 1M-record table on every delete, which
    would take most of the phase), the entry's id among them; then
    ``Collection(index="hnsw", build="wave")`` over 20,000 rows and 5,001
    deletes through the collection, which compact it
    by a wave build of the 14,999 live rows from the device block. Returns
    the phase's numbers."""
    from vettore_tpu_torch.index import hnsw_build
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops.distance import normalize_rows

    dev = torch.device(DEVICE)
    index, graph = col.index, col.index._bulk
    n0, d = graph.n, D_MAIN
    out = {}
    reset_counts(fs, ms)
    one = near_queries(rng, corpus, 1)[0]
    new = clustered(rng, 2 * HNSW_PUT_MANY, d)
    new_ids = [f"new-{i:07d}" for i in range(2 * HNSW_PUT_MANY)]
    steps = [(hnsw_build, "_ensure_mutable"), (hnsw_build, "_wave_step")]

    # ---- 1. puts on the 1M graph
    with Spans(torch, steps) as spans:
        t0 = time.perf_counter()
        col.put({"id": "new-one", "vector": one.tolist()})
        torch.cuda.synchronize()
        out["put_s"] = time.perf_counter() - t0
    out["migrate_s"], out["put_wave_s"] = spans["_ensure_mutable"][0], spans["_wave_step"][0]
    assert index._bulk is graph and graph._mut is not None and graph.n == n0 + 1
    assert graph.x.shape[0] == hnsw_build._capacity(n0), (graph.x.shape, n0)
    first = [{"id": i, "vector": v} for i, v in zip(new_ids[:HNSW_PUT_MANY], new)]
    # the wave step's seconds: the construct search (per lane chunk) and the
    # reciprocal prune (per layer)
    parts = [(hnsw_build, "_construct_search"), (hnsw_build, "_reciprocal")]
    with Spans(torch, steps[1:] + parts) as spans:
        t0 = time.perf_counter()
        col.put_many(first)
        torch.cuda.synchronize()
        out["put_many_s"] = time.perf_counter() - t0
    assert len(spans["_wave_step"]) == 1, spans  # one full wave
    out["put_many_wave_s"] = spans["_wave_step"][0]
    out["search_s"] = spans["_construct_search"]
    out["reciprocal_s"] = spans["_reciprocal"]
    second = [{"id": i, "vector": v}
              for i, v in zip(new_ids[HNSW_PUT_MANY:], new[HNSW_PUT_MANY:])]
    out["busy"], out["wall"] = profile_runs(torch, {
        f"HNSW put_many of {HNSW_PUT_MANY} on the 1M graph": lambda: col.put_many(second)},
        card, reps=1, warm=False).popitem()[1]
    replaced = "doc-0000123"
    target = near_queries(rng, new, 1)[0]
    t0 = time.perf_counter()
    index.put(replaced, target)
    torch.cuda.synchronize()
    out["replace_s"] = time.perf_counter() - t0
    assert index._bulk is graph and len(index) == n0 + 1 + 2 * HNSW_PUT_MANY

    # the oracle's rows: the stored corpus, the new rows, the replaced id's
    # new vector; each id's live row
    all_ids = [f"doc-{i:07d}" for i in range(n0)] + ["new-one", *new_ids, replaced]
    stored = torch.from_numpy(np.concatenate([
        normalize_rows(corpus, "l2"), normalize_rows(np.stack([one, *new, target]), "l2")
    ]).astype(np.float32)).to(dev)
    live = torch.ones(stored.shape[0], dtype=torch.bool, device=dev)
    live[123] = False  # the replaced row
    stored_np = stored.cpu().numpy()
    row_of = {i: k for k, i in enumerate(all_ids) if k != 123}

    near = near_queries(rng, new, B_MAIN)
    qsets = {"near the new rows": near, "phase 4's": queries}

    def check(tag):
        recalls, errs = {}, []
        for name, q in qsets.items():
            prep = normalize_rows(q, "l2")
            slots, raws = index.search_batch_device(torch.from_numpy(prep).to(dev), 10)
            got, err = hnsw_hits_check(index._bulk, slots, raws,
                                       lambda h: stored_np[[row_of[i] for i in h]], prep)
            want = f64_top(torch, stored, live, all_ids, q, 10)
            recalls[name] = recall_at(got, [w[0] for w in want])
            errs.append(err)
            assert recalls[name] >= HNSW_RECALL_MIN, f"4f {tag}: recall@10 {recalls}"
            dead = {all_ids[k] for k in (~live).nonzero()[:, 0].tolist()}
            assert not dead & {i for row in got for i in row} - {replaced}, f"4f {tag}: dead id"
        return recalls, max(errs)

    out["recall_puts"], out["err_puts"] = check("after the puts")
    prep = normalize_rows(target[None], "l2")
    slots, raws = index.search_batch_device(torch.from_numpy(prep).to(dev), 1)
    assert graph.ids[int(slots[0, 0])] == replaced, "the replaced id must return its new vector"
    assert abs(float(raws[0, 0]) - float(prep[0].astype(np.float64) @ stored_np[-1])) <= \
        HNSW_RAW_TOL

    # ---- 2. deletes on the 1M graph, the entry's id among them
    entry_id = graph.ids[graph.entry_slot]
    gone = [entry_id] + [i for i in (f"doc-{k:07d}" for k in rng.choice(
        n0, HNSW_DELETES + 2, replace=False)) if i not in (entry_id, replaced)][:HNSW_DELETES - 1]
    t0 = time.perf_counter()
    for i in gone:
        index.delete(i)
    torch.cuda.synchronize()
    out["delete_s"] = time.perf_counter() - t0
    assert index._bulk is graph and graph._mut.dead == HNSW_DELETES + 1, "no compaction"
    assert graph.ids[graph.entry_slot] != entry_id, "the entry must be re-elected"
    live[[row_of[i] for i in gone]] = False
    out["recall_deletes"], out["err_deletes"] = check("after the deletes")
    launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    log(f"  4f on the 1M graph: put {out['put_s']:.2f}s (migration {out['migrate_s']:.2f}s, "
        f"wave {out['put_wave_s']:.3f}s); put_many of {HNSW_PUT_MANY} {out['put_many_s']:.2f}s "
        f"(its wave {out['put_many_wave_s']:.2f}s: construct search "
        f"{', '.join(f'{t:.2f}' for t in out['search_s'])}s by lane chunk, reciprocal prune "
        f"{', '.join(f'{t:.2f}' for t in out['reciprocal_s'])}s by layer 0..); replace "
        f"{out['replace_s']:.3f}s; "
        f"{HNSW_DELETES} deletes {out['delete_s']:.2f}s; recall@10 after the puts "
        f"{out['recall_puts']}, after the deletes {out['recall_deletes']} (bar "
        f"{HNSW_RECALL_MIN}); raw within {max(out['err_puts'], out['err_deletes']):.2g}; "
        f"entry re-elected; no deleted id returned; kernel launches {launches} {card}")

    # ---- 3. the wave build, then a compaction
    wdata = clustered(rng, WAVE_N, d)
    wids = [f"w-{i:05d}" for i in range(WAVE_N)]
    wq = near_queries(rng, wdata, B_MAIN)
    wcol = vt.Collection(name="wave", dimensions=d, metric="cosine", index="hnsw",
                         index_options={**HNSW_OPTS, "build": "wave"}, device=dev)
    with Spans(torch, [(hnsw_build, "_wave_step")]) as spans:
        t0 = time.perf_counter()
        wcol.put_matrix(wids, wdata)
        torch.cuda.synchronize()
        out["wave_build_s"] = time.perf_counter() - t0
    waves = len(spans["_wave_step"])
    assert waves == -(-WAVE_N // hnsw_build._wave_width(WAVE_N)), waves
    wstored = torch.from_numpy(normalize_rows(wdata, "l2")).to(dev)
    wstored_np = wstored.cpu().numpy()
    wlive = torch.ones(WAVE_N, dtype=torch.bool, device=dev)

    def wave_recall(tag):
        prep = normalize_rows(wq, "l2")
        slots, raws = wcol.index.search_batch_device(torch.from_numpy(prep).to(dev), 10)
        got, err = hnsw_hits_check(wcol.index._bulk, slots, raws,
                                   lambda h: wstored_np[[int(i[2:]) for i in h]], prep)
        rec = recall_at(got, [w[0] for w in f64_top(torch, wstored, wlive, wids, wq, 10)])
        assert rec >= HNSW_RECALL_MIN, f"4f {tag}: recall@10 {rec}"
        return rec, err

    out["wave_recall"], _ = wave_recall("the wave build")
    with Spans(torch, [(hnsw_build, "compact"), (hnsw_build, "_wave_step")]) as spans:
        t0 = time.perf_counter()
        for i in wids[:WAVE_DELETES]:
            wcol.delete(i)
        torch.cuda.synchronize()
        out["wave_delete_s"] = time.perf_counter() - t0
    assert len(spans["compact"]) == 1, spans.get("compact")
    out["compact_s"] = spans["compact"][0]
    g2 = wcol.index._bulk
    assert g2.n == g2.live == WAVE_N - WAVE_DELETES and g2.valid is None and g2._mut is None
    assert len(spans["_wave_step"]) == -(-g2.n // hnsw_build._wave_width(g2.n))
    wlive[:WAVE_DELETES] = False
    out["compact_recall"], _ = wave_recall("the compacted graph")
    wcol.close()
    log(f"  4f wave build: {WAVE_N}x{d} through put_matrix (build 'wave', {waves} waves) "
        f"{out['wave_build_s']:.2f}s, recall@10 {out['wave_recall']:.4f}; {WAVE_DELETES} "
        f"collection deletes {out['wave_delete_s']:.2f}s, of which the compaction (a wave "
        f"build of the {g2.n} live rows from the device block) {out['compact_s']:.2f}s; the "
        f"new graph n == live == {g2.n}, no tombstones, recall@10 "
        f"{out['compact_recall']:.4f} {card}")
    return out


def hnsw_config2(torch, vt, rng, corpus, ids, queries, exact, card):
    """Phase 4d: BASELINE config 2, HNSW over phase 4's 1M x 768 corpus
    (``put_matrix`` bulk-builds the graph through the kNN build on the
    card), searched by the batch of 512 at limit 10 against phase 4's exact
    ids; then a 3,000-row graph built by host inserts and served by the
    device beam. Returns the config-2 numbers."""
    from vettore_tpu_torch.index import hnsw_build, hnsw_knn_build
    from vettore_tpu_torch.index.hnsw_device import DeviceGraph
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops.distance import normalize_rows

    dev = torch.device(DEVICE)
    prepared = normalize_rows(queries, "l2")
    qdev = torch.from_numpy(prepared).to(dev)
    exact_ids = [[r.id for r in row] for row in exact]
    col = vt.Collection(name="config-2", dimensions=D_MAIN, metric="cosine", index="hnsw",
                        index_options=HNSW_OPTS, device=dev)
    reset_counts(fs, ms)
    # where the build's seconds go: the index's bulk build within the
    # collection's ingest, the host preamble (levels, slot order) and each
    # layer's adjacency within the build
    targets = [(hnsw_build, "bulk_build"), (hnsw_knn_build, "_prep_order"),
               (hnsw_knn_build, "_layer_adjacency"), (hnsw_knn_build, "_kmeans_assign"),
               (hnsw_knn_build, "_knn_chunk"), (hnsw_knn_build, "_reciprocal_pass")]
    with Spans(torch, targets) as spans:
        t0 = time.perf_counter()
        col.put_matrix(ids, corpus)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    graph = col.index._bulk
    assert graph is not None and graph.n == corpus.shape[0], "no bulk graph"
    assert graph.x.device.type == dev.type, graph.x.device
    t0 = time.perf_counter()
    slots, raws = col.index.search_batch_device(qdev, 10)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    assert slots.device.type == dev.type and slots.shape == (len(queries), 10), slots.shape
    got, err = hnsw_hits_check(graph, slots, raws, lambda h: corpus[[int(i[4:]) for i in h]],
                               prepared)
    recall = recall_at(got, exact_ids)
    assert recall >= HNSW_RECALL_MIN, f"config 2 recall@10 {recall}"
    ms_dev = host_ms(torch, lambda: col.index.search_batch_device(qdev, 10))
    hydrated = col.search_batch(queries, limit=10)
    assert [[r.id for r in row] for row in hydrated] == got, "search_batch != device path"
    single = col.search(queries[0].tolist(), limit=10)
    assert [r.id for r in single] == got[0], "search != its batch row"
    ms_sync = host_ms(torch, lambda: col.search_batch(queries, limit=10), reps=3)
    ms_single = host_ms(torch, lambda: col.search(queries[0].tolist(), limit=10), reps=3)
    launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    layers = ", ".join(f"{t:.1f}" for t in spans["_layer_adjacency"])
    log(f"  config 2 ingest: put_matrix {build_s:.1f}s, of which the index's bulk build "
        f"{spans['bulk_build'][0]:.1f}s: host preamble (levels, slot order) "
        f"{spans['_prep_order'][0]:.1f}s, layer adjacency by layer 0.. [{layers}]s; over all "
        f"layers k-means {sum(spans['_kmeans_assign']):.1f}s, block scoring "
        f"{sum(spans['_knn_chunk']):.1f}s ({len(spans['_knn_chunk'])} chunks), reciprocal "
        f"passes {sum(spans['_reciprocal_pass']):.1f}s {card}")
    log(f"  config 2: {graph.n} nodes, layers 0-{graph.lmax}, kNN bulk build (put_matrix) "
        f"{build_s:.1f}s; search_batch_device B={len(queries)} limit 10: first call "
        f"{first_ms:.1f} ms, then {ms_dev:.3f} ms per batch; search_batch (sync, hydrated) "
        f"{ms_sync:.3f} ms; single search {ms_single:.3f} ms {card}")
    busy, wall = profile_runs(torch, {"hnsw device": lambda: col.index.search_batch_device(
        qdev, 10)}, card)["hnsw device"]
    log(f"  config 2: recall@10 {recall:.4f} against exact flat on {len(queries)} queries "
        f"(bar {HNSW_RECALL_MIN}); raw scores within {err:.2g} of float64 (tol {HNSW_RAW_TOL}); "
        f"(rank, id) order; search_batch and search equal the device path; kernel "
        f"launches {launches} (the HNSW path runs plain PyTorch)")
    del graph, slots, raws

    # ---- phase 4f: writes to the same graph, the wave build, a compaction
    t0 = time.perf_counter()
    writes = hnsw_writes(torch, vt, rng, col, corpus, queries, card)
    writes["launches"] = {**fs.LAUNCHES, **ms.LAUNCHES}
    log(f"[phase 4f] writes to config 2's graph and the wave build: recall@10 >= "
        f"{HNSW_RECALL_MIN} after every step, no deleted id returned "
        f"({time.perf_counter() - t0:.1f}s)")
    col.close()
    del col
    torch.cuda.empty_cache()

    # a graph built by host inserts (below BULK_THRESHOLD), served on the card
    n = HNSW_HOST_N
    data = clustered(rng, n, D_MAIN)
    hids = [f"h-{i:05d}" for i in range(n)]
    hq = near_queries(rng, data, 64)
    colh = vt.Collection(name="hnsw-host", dimensions=D_MAIN, metric="cosine", index="hnsw",
                         index_options=HNSW_OPTS, device=dev)
    t0 = time.perf_counter()
    colh.put_matrix(hids, data)
    insert_s = time.perf_counter() - t0
    index = colh.index
    assert index._bulk is None and index._use_device(), "the host graph should serve on the card"
    hprep = normalize_rows(hq, "l2")
    hslots, hraws = index.search_batch_device(torch.from_numpy(hprep).to(dev), 10)
    assert isinstance(index._device, DeviceGraph) and index._device.x.device.type == dev.type
    stored = normalize_rows(data, "l2").astype(np.float64)
    stored /= np.linalg.norm(stored, axis=1, keepdims=True)
    sims = stored @ hprep.astype(np.float64).T
    want = [[hids[i] for i in sorted(np.argpartition(-sims[:, b], 10)[:10],
                                     key=lambda i: (-sims[i, b], hids[i]))] for b in range(64)]
    hgot, herr = hnsw_hits_check(index._device, hslots, hraws,
                                 lambda h: data[[int(i[2:]) for i in h]], hprep)
    hrecall = recall_at(hgot, want)
    assert hrecall >= HNSW_RECALL_MIN, f"host-built graph recall@10 {hrecall}"
    assert [[r.id for r in row] for row in colh.search_batch(hq, limit=10)] == hgot
    log(f"  host-built graph: {n}x{D_MAIN} through {n} host inserts in {insert_s:.1f}s, served by "
        f"the device beam: recall@10 {hrecall:.4f} against float64 exact on 64 queries, raw "
        f"within {herr:.2g} {card}")
    colh.close()
    return {"build_s": build_s, "ms": ms_dev, "sync_ms": ms_sync, "recall": recall,
            "busy": busy, "wall": wall, "writes": writes}


def flat_hybrid(torch, col, queries, card):
    """Phase 4e: ``hybrid_search_batch`` on phase 4's collection, the batch
    of 512 at limit 10, generators funnel, quantized and search (100
    candidates each by default), exact rerank. The search generator holds
    the exact top 100, so the union holds the exact top 10: the ids must be
    phase 4's exact ``search_batch`` results (which phase 4 holds against
    its f64 oracle; near-ties within TIE_EPS may trade places). Returns
    (launch counts, ms per sync batch, busy and wall ms, and the max abs
    error of each kernel against its plain version at the shapes this run
    gave it)."""
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms

    exact = col.search_batch(queries, limit=14)  # past the boundary, for near-ties
    gens = ["funnel", "quantized", "search"]
    reset_counts(fs)
    with PathCalls(fs, ms) as calls:
        got = col.hybrid_search_batch(queries, limit=10, generators=gens)
        torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    for name in ("gmin_scan", "rescore", "stage_gmin_scan", "sign_scan", "extract_group_rows"):
        assert launches[name] > 0, f"{name} not launched by the flat hybrid: {launches}"
    assert col.host_routes == 0, f"host routes: {col.host_routes}"
    swaps = sum(check_hits([(r.id, r.score) for r in row],
                           ([r.id for r in w], [r.score for r in w]), 10)
                for row, w in zip(got, exact))
    batch_ms = host_ms(torch, lambda: col.hybrid_search_batch(queries, limit=10,
                                                              generators=gens), reps=3)
    busy, wall = profile_runs(torch, {"flat hybrid (sync)": lambda: col.hybrid_search_batch(
        queries, limit=10, generators=gens)}, card)["flat hybrid (sync)"]
    assert col.host_routes == 0
    log(f"  flat hybrid {gens}, rerank exact, B={len(queries)} limit 10: ids equal phase 4's "
        f"exact results ({swaps} near-tie swaps), host routes 0, {batch_ms:.3f} ms per sync "
        f"batch; launches {launches} {card}")
    errs = calls.check(torch, "4e flat hybrid", card)[0]
    assert set(errs) == {"gmin_scan", "rescore", "stage_gmin_scan", "sign_scan",
                         "extract_group_rows"}, errs
    return launches, batch_ms, busy, wall, errs, got


def ivf_routing(torch, ivf, q, p):
    """The ``[B, p]`` int32 block indices IVF's cosine routing gives the
    queries ``q``: what ``ops.ivf.ivf_search`` hands K2 at ``n_probe`` p."""
    from vettore_tpu_torch.ops import ivf as ops_ivf
    from vettore_tpu_torch.ops import select

    ng = ivf._bcb.shape[0]
    crank = -ops_ivf.bf16_dots(q, ivf._bcb) + ivf._bbias[None, :]
    return select.group_topk(crank, min(p, ng))[1].clamp_max(ng - 1).int()


def ivf_hits_check(ivf, slots, raws, rows16, prepared):
    """IVF results against float64: every raw score within HNSW_RAW_TOL of
    the f64 dot of its row as the bf16 block stores it (``rows16``, by
    position in ``ids``) with its query, hits in (rank, id) order. Returns
    (id lists, max raw error)."""
    got, err = [], 0.0
    for b, (row_slots, row_raws) in enumerate(zip(slots.cpu().tolist(), raws.cpu().tolist())):
        hits = [(ivf._block_ids[s], r) for s, r in zip(row_slots, row_raws) if s >= 0]
        rows = rows16[[int(h[0][4:]) for h in hits]].astype(np.float64)
        want = rows @ prepared[b].astype(np.float64)
        err = max(err, float(np.abs(np.array([h[1] for h in hits]) - want).max()))
        assert in_rank_id_order(hits), f"query {b}: IVF hits not in (rank, id) order"
        got.append([h[0] for h in hits])
    assert err <= HNSW_RAW_TOL, f"IVF raw scores off by {err}"
    return got, err


def k2_at(torch, fs, x, xsq, bias, q, gidx, label, card):
    """K2 on IVF's routing ``gidx`` against its plain version (within
    K2_ATOL), timed beside it; its bytes bound and sharing logged. Returns
    (abs err, ms, plain ms, bound)."""
    got = fs.rescore(x, xsq, bias, q, gidx, metric="cosine")
    err, _rel = abs_rel_err(got, fs._rescore_ref(x, xsq, bias, q, gidx, metric="cosine"))
    assert err <= K2_ATOL, f"K2 at {label}: err {err}"
    k_ms = cuda_ms(torch, lambda: fs.rescore(x, xsq, bias, q, gidx, metric="cosine"))
    plain = cuda_ms(torch, lambda: fs._rescore_ref(x, xsq, bias, q, gidx, metric="cosine"))
    b, p = gidx.shape
    d = x.shape[1]
    bnd = bound(2 * b * p * 64 * d, "f32",
                rescore_bytes(distinct_rows(gidx), d, x.element_size(), b, p, metric="cosine"))
    log(f"  K2 at {label} [{b}, {p}] on {str(x.dtype).removeprefix('torch.')} rows: err "
        f"{err:.3g} (atol {K2_ATOL}), {k_ms:.4f} ms vs plain {plain:.3f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); {sharing(gidx)} {card}")
    return err, k_ms, plain, bnd


def ivf_phase(torch, vt, rng, col, corpus, queries, exact, base, card):
    """Phase 4g: the IVF index on phase 4's 1M x 768 corpus, as ``bench.py``
    drives it (``IvfIndex.from_flat`` of phase 4's flat index, n_probe 4,
    bf16 storage, a cold ``rebuild``), then on config 1's corpus; and
    ``compressed=True``. ``exact`` is phase 4's exact results, ``base``
    config 1's ``(collection, ids, data, queries, exact results)``. Writes
    go through the IVF index into phase 4's flat index, its mirror: phase
    4's collection is dropped after this phase. Returns the phase's numbers,
    its launch counts and each kernel's max abs error at the shapes it ran."""
    from vettore_tpu_torch.index.ivf import IvfIndex
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import ivf as ops_ivf
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops.distance import normalize_rows
    from vettore_tpu_torch.ops.transport import round_to_bf16

    dev = torch.device(DEVICE)
    flat = col.index
    prepared = normalize_rows(queries, "l2")
    qdev = torch.from_numpy(prepared).to(dev)
    exact_ids = [[r.id for r in row] for row in exact]
    rows16 = round_to_bf16(normalize_rows(corpus, "l2"))  # the bytes the bf16 block holds
    out = {}
    reset_counts(fs)
    with PathCalls(fs, ms) as calls:
        # ---- the build, cold (bench.py's call), and a second one
        torch.cuda.synchronize()
        targets = [(ops_ivf, "gather_lex_rows"), (ops_ivf, "kmeans_assign"),
                   (ops_ivf, "build_blocks")]
        with Spans(torch, targets) as spans:
            t0 = time.perf_counter()
            ivf = IvfIndex.from_flat(flat, dict(IVF_OPTS))
            ivf.rebuild()
            torch.cuda.synchronize()
            out["build_s"] = time.perf_counter() - t0
        out["build_split"] = {name: sec[0] for name, sec in spans.items()}
        assert ivf._xb.dtype == torch.bfloat16 and ivf._xb.device.type == dev.type
        t0 = time.perf_counter()
        twin = IvfIndex.from_flat(flat, {**IVF_OPTS, "storage": "f32"})
        twin.rebuild()
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t0
        assert torch.equal(twin._lex, ivf._lex), "two builds permute the rows differently"
        assert torch.equal(twin._bcb.view(torch.int16), ivf._bcb.view(torch.int16)), (
            "two builds route by different centroids")
        assert twin._block_ids == ivf._block_ids, "two builds differ in their block ids"
        assert torch.equal(twin._xb.to(torch.bfloat16).view(torch.int16),
                           ivf._xb.view(torch.int16))
        ng = ivf._bcb.shape[0]
        split = out["build_split"]
        log(f"  IVF build (from_flat, n_probe 4, bf16, cold rebuild) {out['build_s']:.2f}s: "
            f"gather {split['gather_lex_rows']:.3f}s, k-means ({ivf.params['kmeans_iters']} "
            f"iterations) "
            f"{split['kmeans_assign']:.3f}s, block state {split['build_blocks']:.3f}s, the rest "
            f"(the sort, the host's block ids) {out['build_s'] - sum(split.values()):.3f}s; "
            f"{ng} blocks of 64; a second build (f32 storage) {twin_s:.2f}s with the same "
            f"permutation, routing centroids and block ids, bit for bit {card}")

        # ---- the n_probe sweep against phase 4's exact ids; the first
        # n_probe at the recall bar is the one timed
        sweep, found = {}, {}
        for p in IVF_SWEEP:
            ivf.params["n_probe"] = p
            slots, raws = ivf.search_batch_device(qdev, 10)
            got, err = ivf_hits_check(ivf, slots, raws, rows16, prepared)
            sweep[p] = recall_at(got, exact_ids)
            log(f"  IVF n_probe {p}: recall@10 {sweep[p]:.4f} against exact flat on "
                f"{len(queries)} queries; raw within {err:.2g} of float64; (rank, id) order")
            if sweep[p] >= IVF_RECALL_MIN and not found:
                found = {"p": p, "got": got}
        assert found, f"no n_probe up to {IVF_SWEEP[-1]} reaches recall@10 {IVF_RECALL_MIN}: {sweep}"
        p, got = found["p"], found["got"]
        ivf.params["n_probe"] = p
        hydrated = ivf.search_batch(prepared, 10)
        assert [[h[0] for h in row] for row in hydrated] == got, "search_batch != device path"
        out.update(sweep=sweep, n_probe=p)
        out["ms"] = cuda_ms(torch, lambda: ivf.search_batch_device(qdev, 10))
        out["sync_ms"] = host_ms(torch, lambda: ivf.search_batch(prepared, 10), reps=5)
        out["busy"], out["wall"] = profile_runs(torch, {"ivf device": lambda: (
            ivf.search_batch_device(qdev, 10))}, card)["ivf device"]
        log(f"  IVF at n_probe {p}: search_batch_device B={len(queries)} {out['ms']:.3f} ms "
            f"(CUDA events), search_batch (sync, hydrated) {out['sync_ms']:.3f} ms {card}")

        # ---- writes: a tail of new rows, tombstones, a replace; rebuilds
        new = clustered(rng, IVF_PUT_MANY, D_MAIN)
        new_ids = [f"new-{i:05d}" for i in range(IVF_PUT_MANY)]
        t0 = time.perf_counter()
        ivf.put_many(list(zip(new_ids, new)))
        torch.cuda.synchronize()
        put_s = time.perf_counter() - t0
        gone = [f"doc-{i:07d}" for i in rng.choice(corpus.shape[0], IVF_DELETES, replace=False)]
        t0 = time.perf_counter()
        for id in gone:
            ivf.delete(id)
        torch.cuda.synchronize()
        delete_s = time.perf_counter() - t0
        moved = exact_ids[0][0]  # phase 4's first query's best hit moves away
        t0 = time.perf_counter()
        ivf.put(moved, -prepared[0])
        torch.cuda.synchronize()
        replace_s = time.perf_counter() - t0
        assert ivf._tombstoned == IVF_DELETES + 1 - len(set(gone) & {moved}) and not ivf._stale()
        near = normalize_rows(near_queries(rng, new, B_MAIN), "l2")
        gone_set = set(gone)
        for label, qs in (("phase 4's", prepared), ("near the new rows", near)):
            want = [[i for i, _ in row] for row in ivf._mirror.search_batch(qs, 10)]
            got = [[i for i, _ in row] for row in ivf.search_batch(qs, 10)]
            assert not gone_set & {i for row in got for i in row}, "a deleted id came back"
            r = recall_at(got, want)
            assert r >= IVF_RECALL_MIN, f"IVF recall@10 {r} after the writes ({label} queries)"
            log(f"  IVF after the writes, {label} queries: recall@10 {r:.4f} against exact "
                f"flat over the live rows")
        assert moved not in {i for i, _ in ivf.search(prepared[0], 10)}
        t0 = time.perf_counter()
        ivf.rebuild()
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        assert ivf._tail is None and len(ivf._block_slot_of) == len(flat)
        del ivf, twin
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        auto = IvfIndex.from_flat(flat, {"n_probe": "auto", "storage": "bf16"})
        auto.rebuild()
        torch.cuda.synchronize()
        auto_s = time.perf_counter() - t0
        log(f"  IVF writes: put_many of {IVF_PUT_MANY} new rows (the tail) {put_s:.3f}s, "
            f"{IVF_DELETES} deletes (tombstones) {delete_s:.3f}s, a replace {replace_s:.4f}s; "
            f"rebuild of {len(flat)} live rows {rebuild_s:.2f}s; an n_probe=\"auto\" build "
            f"{auto_s:.2f}s: tuned {auto.tuned} {card}")
        out.update(put_s=put_s, delete_s=delete_s, replace_s=replace_s, rebuild_s=rebuild_s,
                   auto_s=auto_s, tuned=auto.tuned)
        del auto
        torch.cuda.empty_cache()

        # ---- full probe on config 1's corpus equals exact flat
        col3, ids3, data3, qs3, got3 = base
        full = IvfIndex.from_flat(col3.index, {"n_probe": 65_536, "storage": "f32"})
        prep3 = normalize_rows(qs3[:IVF_FULL_B], "l2")
        full_hits = full.search_batch(prep3, 10)
        assert [[i for i, _ in row] for row in full_hits] == [
            [r.id for r in row] for row in got3[:IVF_FULL_B]], "full probe != exact flat"
        for grow, wrow in zip(full_hits, got3):
            assert max(abs(g[1] - w.score) for g, w in zip(grow, wrow)) <= HNSW_RAW_TOL
        log(f"  IVF full probe on config 1 ({N_BASE}x{D_BASE}, {full._bcb.shape[0]} blocks, "
            f"n_probe 65,536, f32): ids equal exact flat's in order on {IVF_FULL_B} queries")
        del full

        # ---- collections on config 1's corpus
        cols = {}
        for label, kw in (("ivf", {"index": "ivf"}), ("compressed", {"compressed": True})):
            c = vt.Collection(name=f"config-1-{label}", dimensions=D_BASE, metric="cosine",
                              device=dev, **kw)
            t0 = time.perf_counter()
            c.put_matrix(ids3, data3)
            res = c.search_batch(qs3, limit=10)
            torch.cuda.synchronize()
            cols[label] = (c, res, time.perf_counter() - t0)
        civf, ivf_res, ivf_s = cols["ivf"]
        assert civf.index_kind == "ivf" and civf.index.built
        r_ivf = recall_at([[r.id for r in row] for row in ivf_res],
                          [[r.id for r in row] for row in got3])
        hyb = civf.hybrid_search_batch(qs3, limit=10)
        torch.cuda.synchronize()
        assert civf.host_routes == 0, civf.host_routes
        stored3 = normalize_rows(data3, "l2")
        pos3 = {id: i for i, id in enumerate(ids3)}
        herr = 0.0
        for b, row in enumerate(hyb):
            hits = [(r.id, r.score) for r in row]
            assert len(hits) == 10 and in_rank_id_order(hits), f"hybrid query {b}: order"
            want = stored3[[pos3[i] for i, _ in hits]].astype(np.float64) @ normalize_rows(
                qs3[b:b + 1], "l2")[0].astype(np.float64)
            herr = max(herr, float(np.abs(np.array([s for _, s in hits]) - want).max()))
        assert herr <= SCORE_TOL, f"IVF hybrid scores off by {herr}"
        r_hyb = recall_at([[r.id for r in row] for row in hyb], [[r.id for r in row] for row in got3])
        log(f"  Collection(index=\"ivf\") on config 1 (defaults: n_probe 8, bf16): put_matrix + "
            f"search_batch {ivf_s:.1f}s, recall@10 {r_ivf:.4f} against exact flat; default "
            f"hybrid_search_batch (search + quantized, exact rerank) recall@10 {r_hyb:.4f}, "
            f"scores within {herr:.2g} of float64, host routes 0 {card}")
        cz, z_res, z_s = cols["compressed"]
        assert cz.index.storage == "bf16"
        truth16 = f64_oracle(round_to_bf16(stored3), ids3, qs3, 10, renorm=False)
        z_swaps = sum(check_hits([(r.id, r.score) for r in row], want, 10)
                      for row, want in zip(z_res, truth16))
        log(f"  Collection(compressed=True) on config 1: put_matrix + search_batch {z_s:.1f}s; "
            f"ids equal the float64 oracle over the bf16-rounded rows ({z_swaps} near-tie "
            f"swaps), scores within {SCORE_TOL}; host routes {cz.index.host_routes} {card}")
        out.update(recall_ivf_col=r_ivf, recall_hybrid=r_hyb)
        torch.cuda.synchronize()
    launches = dict(fs.LAUNCHES)
    for name in ("gmin_scan", "rescore", "sign_scan", "extract_group_rows"):
        assert launches[name] > 0, f"{name} not launched in phase 4g: {launches}"
    assert fs.ROUTES["rescore"]["narrow"] == 0, fs.ROUTES
    for c, _res, _s in cols.values():
        c.close()
    del cols, civf, cz
    torch.cuda.empty_cache()
    errs = calls.check(torch, "4g IVF", card)[0]
    del calls
    torch.cuda.empty_cache()

    # ---- K2 at IVF's shapes, after the counts were read: a fresh build
    ivf = IvfIndex.from_flat(flat, {**IVF_OPTS, "storage": "f32"})
    ivf.rebuild()
    xb16 = ivf._xb.to(torch.bfloat16)
    k2 = {}
    for label, x, p in (("n_probe 4", xb16, 4), ("n_probe 64", xb16, 64),
                        ("n_probe 4, f32 build", ivf._xb, 4)):
        k2[label] = k2_at(torch, fs, x, ivf._xsq, ivf._bias, qdev, ivf_routing(torch, ivf, qdev, p),
                          label, card)
    del ivf, xb16
    torch.cuda.empty_cache()
    out["k2"] = k2
    return out, launches, errs


def maxsim_subset_oracle(tokens, cand, qset, ids, limit):
    """Exact cosine MaxSim in float64 of the docs ``cand`` (rows of
    ``tokens`` [N, T, d], id order; every token live) against one query
    set: the top ``limit + 4`` by (score desc, id) as ``(ids, scores)``."""
    q = np.asarray(qset, np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    docs = tokens[cand].astype(np.float64)
    docs /= np.linalg.norm(docs, axis=2, keepdims=True)
    scores = (docs @ q.T).max(axis=1).sum(axis=1)
    order = sorted(range(len(cand)), key=lambda i: (-scores[i], ids[cand[i]]))[: limit + 4]
    return [ids[cand[i]] for i in order], [float(scores[i]) for i in order]


def mmr_greedy_ok(picks, initial, vecs, alpha, tol=HNSW_ORDER_TOL):
    """Whether ``picks`` (indices into ``initial``) is a greedy MMR order in
    float64 (cosine pair similarity): at every step the pick's MMR score is
    within ``tol`` of the best remaining one. Returns (ok, whether each step
    took the float64 argmax)."""
    v = vecs.astype(np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    sims = v @ v.T
    scores = np.array([s for _i, s in initial], np.float64)
    chosen, exact = [], True
    for p in picks:
        rest = [j for j in range(len(initial)) if j not in chosen]
        red = sims[np.ix_(rest, chosen)].max(axis=1) if chosen else np.zeros(len(rest))
        mmr = alpha * scores[rest] - (1 - alpha) * red
        best = mmr.max()
        mine = mmr[rest.index(p)]
        if mine < best - tol:
            return False, False
        exact &= rest[int(np.argmax(mmr))] == p
        chosen.append(p)
    return True, exact


def hybrid_config5(torch, vt, state, card):
    """Phase 6b: BASELINE config 5's hybrid pipeline on phase 6's collection
    (as ``bench.py``'s ``run_hybrid_mv``): the HNSW graph bulk-built from the
    primary vectors, saved and loaded back, attached; ``hybrid_search_batch``
    with the hnsw and quantized generators (1,000 candidates each) and the
    MaxSim rerank; MMR on its results; MUVERA candidates + the exact rerank.
    Returns the numbers and launch counts of its runs, and K5's row at the
    FDE shape."""
    from vettore_tpu_torch.index.hnsw import HnswIndex
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops import mmr, muvera_fde

    dev = torch.device(DEVICE)
    col, tokens, ids = state["col"], state["tokens"], state["ids"]
    qsets = state["sets"][:MV_B]
    queries = state["queries"][:MV_B].astype(np.float64)  # normalize="none": as prepared
    exact = [[r.id for r in row] for row in state["exact"]]
    cache = col._scan_cache()
    stored = cache._stack_vectors()  # primary vectors, id order
    out = {}

    # the graph: kNN bulk build, save, load (with and without x), attach
    index = HnswIndex("cosine", HNSW_OPTS, device=dev)
    t0 = time.perf_counter()
    index.put_matrix(cache.ids, stored)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    qdev = torch.from_numpy(queries.astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        full, bare = os.path.join(tmp, "g.npz"), os.path.join(tmp, "g-no-x.npz")
        t0 = time.perf_counter()
        index.save_graph(full)
        index.save_graph(bare, include_x=False)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = HnswIndex.load_graph("cosine", HNSW_OPTS, full, device=dev)
        shared = HnswIndex.load_graph("cosine", HNSW_OPTS, bare, x_device=index._bulk.x,
                                      device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    want_slots = index.search_batch_device(qdev, HYBRID_LIMIT)[0]
    for other in (loaded, shared):
        assert torch.equal(other.search_batch_device(qdev, HYBRID_LIMIT)[0], want_slots), \
            "a loaded graph searches differently"
    assert shared._bulk.x is index._bulk.x
    col.attach_index(loaded)
    assert col.index_kind == "hnsw", col.index_kind
    del index, shared
    # the attach made a new scan cache: its token block and sign block,
    # timed apart from the first hybrid call
    t0 = time.perf_counter()
    cache = col._scan_cache()
    cache.multi_vectors()
    cache.signs()
    torch.cuda.synchronize()
    out["cache_s"] = time.perf_counter() - t0
    log(f"  config 5 graph: kNN bulk build of {MV_N}x{MV_D} primary vectors "
        f"{out['build_s']:.1f}s; save_graph (with and without x) {out['save_s']:.1f}s, "
        f"load_graph (both) {out['load_s']:.1f}s, searches equal; attach_index: index_kind "
        f"{col.index_kind}, the new scan cache's token and sign blocks {out['cache_s']:.1f}s "
        f"{card}")

    # the hybrid: hnsw + quantized candidates, MaxSim rerank
    gens = [("hnsw", {"candidates": HYBRID_C}), ("quantized", {"candidates": HYBRID_C})]
    rerank = ("multi_vector", qsets)
    reset_counts(fs, ms)
    t0 = time.perf_counter()
    with PathCalls(fs, ms) as calls:
        got = col.hybrid_search_batch(queries, limit=HYBRID_LIMIT, generators=gens,
                                      rerank=rerank)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    out["hybrid_launches"] = launches
    # the host's validation of the query token sets, which every
    # multi-vector call (MaxSim rerank, MUVERA, exact) pays
    pad_ms = host_ms(torch, lambda: col._pad_query_sets(qsets), reps=3)
    assert launches["sign_scan"] > 0 and launches["extract_group_rows"] > 0, launches
    assert col.host_routes == 0, f"host routes: {col.host_routes}"
    graph = loaded._bulk
    hnsw_slots = loaded.search_batch_device(qdev, HYBRID_C)[0].cpu().numpy()
    quant = hamming_candidates(stored, queries.astype(np.float32), HYBRID_C)
    slot_of = {i: k for k, i in enumerate(ids)}  # ids are in id order
    t0 = time.perf_counter()
    swaps = 0
    for b, row in enumerate(got):
        union = sorted({slot_of[graph.ids[s]] for s in hnsw_slots[b] if s >= 0}
                       | set(quant[b].tolist()))
        want = maxsim_subset_oracle(tokens, np.array(union), qsets[b], ids, HYBRID_LIMIT)
        swaps += check_hits([(r.id, r.score) for r in row], want, HYBRID_LIMIT)
    oracle_s = time.perf_counter() - t0
    overlap = float(np.mean([len({r.id for r in row[:10]} & set(e)) / 10
                             for row, e in zip(got, exact)]))
    out["hybrid_ms"] = host_ms(torch, lambda: col.hybrid_search_batch(
        queries, limit=HYBRID_LIMIT, generators=gens, rerank=rerank), reps=3)
    beam_ms = host_ms(torch, lambda: loaded.candidate_slots_device(qdev, HYBRID_C), reps=3)
    out["hybrid_busy"], out["hybrid_wall"] = profile_runs(torch, {
        "config 5 hybrid (sync)": lambda: col.hybrid_search_batch(
            queries, limit=HYBRID_LIMIT, generators=gens, rerank=rerank)},
        card)["config 5 hybrid (sync)"]
    out["hybrid_overlap"] = overlap
    log(f"  config 5 hybrid {gens}, MaxSim rerank, B={MV_B} limit {HYBRID_LIMIT}: each query's "
        f"ids and scores equal the f64 MaxSim oracle over its candidate union ({swaps} near-tie "
        f"swaps; oracle {oracle_s:.1f}s), host routes 0; first call {first_s:.2f}s, then "
        f"{out['hybrid_ms']:.3f} ms per sync batch; alone, the HNSW beam at ef {HYBRID_C} "
        f"{beam_ms:.3f} ms and the validation of the {MV_B} query token sets {pad_ms:.3f} ms; "
        f"overlap@10 against exact MaxSim {overlap:.4f}; launches {launches} {card}")
    out["hybrid_errs"] = calls.check(torch, "6b hybrid", card)[0]
    assert set(out["hybrid_errs"]) == {"sign_scan", "extract_group_rows"}, out["hybrid_errs"]
    del calls

    # MMR on the hybrid's results, against the float64 greedy order
    initial = [[(r.id, r.score) for r in row] for row in got]
    vecs = np.stack([stored[[slot_of[i] for i, _s in row]] for row in initial])
    vecs_dev = torch.from_numpy(vecs).to(dev)

    def mmr_batch():
        return mmr.mmr_rerank_batch(initial, vecs_dev, metric="cosine", alpha=0.5, final_k=10,
                                    device=dev)

    picked = mmr_batch()
    equal_host = 0
    for row, init, v in zip(picked, initial, vecs):
        pos = {i: k for k, (i, _s) in enumerate(init)}
        ok, _exact = mmr_greedy_ok([pos[i] for i, _s in row], init, v, 0.5)
        assert ok and len(row) == 10, "device MMR is not a greedy order"
        pool = [(i, [float(x) for x in v[k]]) for k, (i, _s) in enumerate(init)]
        equal_host += row == mmr.mmr_rerank(init, pool, "cosine", 0.5, 10)
    out["mmr_ms"] = cuda_ms(torch, mmr_batch)
    log(f"  MMR (alpha 0.5, final_k 10) on the {MV_B} hybrid lists: a float64 greedy order in "
        f"every query (MMR ties within {HNSW_ORDER_TOL}), equal to the host mmr_rerank in "
        f"{equal_host} of {MV_B}; {out['mmr_ms']:.3f} ms per batch {card}")

    # MUVERA: bench.py's call (the default config: FDE width d) and the
    # module's 2,048-wide internal default
    out["muvera"] = {}
    for label, mu in (("default", None), ("2048", muvera_fde.default_config(MV_D))):
        cfg = muvera_fde.normalize_config(mu, MV_D)
        reset_counts(fs, ms)
        routes = dict(muvera_fde.ROUTES)
        t0 = time.perf_counter()
        with PathCalls(fs, ms) as calls:
            fde_got = col.multi_vector_search_batch(qsets, limit=10, candidates=MUVERA_C,
                                                    muvera=mu)
            torch.cuda.synchronize()
        first = time.perf_counter() - t0
        mv_launches = {**fs.LAUNCHES, **ms.LAUNCHES}
        assert mv_launches["stage_gmin_scan"] > 0, mv_launches
        assert muvera_fde.ROUTES["fused"] == routes["fused"] + 1, muvera_fde.ROUTES
        assert fs.ROUTES["stage_gmin_scan"] == {"direct": mv_launches["stage_gmin_scan"],
                                                "padded": 0}, fs.ROUTES
        assert col.host_routes == 0
        fde16, fde_xsq, fde_bias = cache_fde = col._scan_cache().fde(cfg)
        qtok, qmask = col._pad_query_sets(qsets)
        qfde = muvera_fde.encode_query_sets_host([qtok[i][qmask[i]] for i in range(MV_B)], cfg)
        qfde_dev = torch.from_numpy(qfde).to(dev)
        cand = muvera_fde.fde_candidates(*cache_fde, qfde_dev, count=MUVERA_C)[0].cpu().numpy()
        # the oracle: K5 selects at the block's bf16 precision (the query
        # FDE rounded to bf16 too), so float64 dots of those values
        fde64 = fde16.float().cpu().numpy().astype(np.float64)
        dots = bf16_round(torch, qfde).astype(np.float64) @ fde64.T
        dots[:, np.isinf(fde_bias.cpu().numpy())] = -np.inf
        cswaps = 0
        for b in range(MV_B):
            kth = np.sort(dots[b])[::-1][MUVERA_C - 1]
            diff = set(cand[b].tolist()) ^ set(np.flatnonzero(dots[b] >= kth).tolist())
            assert all(abs(dots[b, s] - kth) <= 1e-5 * max(1.0, abs(kth)) for s in diff), \
                f"MUVERA candidates of set {b} differ from the f64 top {MUVERA_C}"
            cswaps += len(diff) // 2
        mswaps = sum(check_hits([(r.id, r.score) for r in row],
                                maxsim_subset_oracle(tokens, cand[b], qsets[b], ids, 10), 10)
                     for b, row in enumerate(fde_got))
        ms_batch = host_ms(torch, lambda: col.multi_vector_search_batch(
            qsets, limit=10, candidates=MUVERA_C, muvera=mu), reps=3)
        fde_overlap = float(np.mean([len({r.id for r in row} & set(e)) / 10
                                     for row, e in zip(fde_got, exact)]))
        width = fde16.shape[1]
        path_errs, path_rels = calls.check(torch, f"6b MUVERA {label}", card)
        assert set(path_errs) == {"stage_gmin_scan", "extract_group_rows"}, path_errs
        del calls
        out["muvera"][label] = {"width": width, "first_s": first, "ms": ms_batch,
                                "overlap": fde_overlap, "launches": mv_launches,
                                "errs": path_errs, "rels": path_rels}
        log(f"  MUVERA ({label} config, FDE block [{fde16.shape[0]}, {width}] bf16), "
            f"candidates {MUVERA_C}, B={MV_B} limit 10: first call {first:.2f}s (the device FDE "
            f"encode), then {ms_batch:.3f} ms per batch; K5 on the fused route, operand routes "
            f"{fs.ROUTES['stage_gmin_scan']}; candidates equal the f64 top {MUVERA_C} by FDE dot "
            f"over "
            f"the card's bf16 block ({cswaps} near-tie swaps); results equal the f64 MaxSim "
            f"oracle over them ({mswaps} near-tie swaps); overlap@10 against exact MaxSim "
            f"{fde_overlap:.4f}; launches {mv_launches} {card}")
        if label == "2048":
            # K5 alone at the FDE shape, against its plain version
            def k5():
                return fs.stage_gmin_scan(fde16, fde_xsq, fde_bias, qfde_dev,
                                          metric="inner_product", dims=width)

            def plain():
                return fs._stage_gmin_scan_ref(fde16, fde_xsq, fde_bias, qfde_dev,
                                               metric="inner_product", dims=width)

            err, rel = 0.0, 0.0
            for g, w in zip(k5()[:2], plain()):
                a, e = abs_rel_err(g, w)
                err, rel = max(err, a), max(rel, e)
            assert rel <= MV_RTOL["bf16"], f"K5 at the FDE shape: rel err {rel}"
            n = fde16.shape[0]
            out["k5_fde"] = {
                "launches": mv_launches["stage_gmin_scan"], "err": err, "rel": rel,
                "ms": cuda_ms(torch, k5), "plain_ms": cuda_ms(torch, plain, reps=3),
                # bf16 products; the block, its norms and biases and the bf16
                # query read once, the ranks and group minima written once
                "bound": bound(2 * n * width * MV_B, "bf16",
                               2 * n * width + 8 * n + 2 * MV_B * width
                               + 4 * MV_B * n + 4 * MV_B * (n // fs.GROUP))}
            k = out["k5_fde"]
            log(f"  K5 stage_gmin_scan at the FDE shape [{n}, {width}] bf16 x [{MV_B}, {width}] "
                f"inner_product: abs err {err:.3g}, rel err {rel:.3g} (rtol {MV_RTOL['bf16']}), "
                f"{k['ms']:.3f} ms vs plain {k['plain_ms']:.3f} ms; bound {k['bound'][0]:.4f} ms "
                f"({k['bound'][1]}) {card}")
        del fde16, fde_xsq, fde_bias, cache_fde, fde64, dots
    return out



def same_rows(got, want, label):
    """The mesh's results against one device's: the same ids in order (an id
    may stand where one device's score is within TIE_EPS of its own) and
    scores within SCORE_TOL. Returns the near-tie substitutions."""
    assert len(got) == len(want), (label, len(got), len(want))
    swaps = 0
    for row, w in zip(got, want):
        assert len(row) == len(w), (label, len(row), len(w))
        swaps += check_hits([(r.id, r.score) for r in row],
                            ([r.id for r in w], [r.score for r in w]), len(w))
    return swaps


def mesh_phase(torch, vt, rng, inp, one, card, *, devices=None, tag="7", seven=None):
    """Phase 7: the mesh over ``devices`` (``[cuda:0] * 4``: 4 virtual
    shards, data 1; None: ``make_mesh()``, every card, for phase 8a), over
    the host copies of phase 4's corpus, queries and exact results, phase
    4b's and 4e's results and phase 6's token corpus and exact MaxSim
    results (``inp``); ``one`` holds the one-device ms per batch and
    profiler splits of those phases, ``seven`` phase 7's (beside phase
    8a's). Then data 2 x shard 2 at config 1's size over the same devices.
    Every kernel the mesh launched is held against its plain version at the
    shard's own shapes and timed there, and every card of the mesh must
    have launched each kernel its shards run. ``tag`` begins every line
    logged. Returns the launch counts (in all and per card), the kernels'
    errors and ms at shard shapes, and the numbers the summary prints."""
    from vettore_tpu_torch import _build
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.ops import maxsim as ms
    from vettore_tpu_torch.ops.distance import normalize_rows
    from vettore_tpu_torch.parallel import ShardedHnsw, make_mesh
    from vettore_tpu_torch.parallel.ivf_mesh import ShardedIvf

    dev = torch.device(DEVICE)
    mesh = make_mesh() if devices is None else make_mesh(devices)
    shards = mesh.shape["shard"]
    corpus, ids, queries = inp["corpus"], inp["ids"], inp["queries"]
    prepared = normalize_rows(queries, "l2")
    qdev = torch.from_numpy(prepared).to(dev)
    exact_ids = [[r.id for r in row] for row in inp["exact"]]
    quant = dict(limit=10, candidates=QUANT_C)
    funnel = dict(limit=10, candidates=FUNNEL_C, stages=list(FUNNEL_STAGES))
    gens = ["funnel", "quantized", "search"]
    out = {"timing": {}}

    # ---- 7a-7b and 7d-7e: every mode that launches a kernel, counted -----
    # (per card too: _build.launch counts each launch on its card)
    t0 = time.perf_counter()
    col = vt.Collection(name="mesh-flat", dimensions=D_MAIN, metric="cosine", mesh=mesh)
    col.put_matrix(ids, corpus)  # a mesh flat index takes put_many, as JAX's
    put_s = time.perf_counter() - t0
    stored = normalize_rows(corpus, "l2")
    t0 = time.perf_counter()
    ivf = ShardedIvf("cosine", mesh, ids, stored, options=IVF_OPTS)
    sync_all(torch)
    ivf_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mvcol = vt.Collection(name="mesh-c5", dimensions=MV_D, metric="cosine",
                          normalize="none", mesh=mesh)
    mvcol.put_tokens(inp["mv_ids"], inp["mv_tokens"])
    mv_put_s = time.perf_counter() - t0
    sets = inp["mv_sets"][:MV_B]
    reset_counts(fs, ms)
    with PathCalls(fs, ms) as calls:
        t0 = time.perf_counter()
        got = col.search_batch(queries, limit=10)
        sync_all(torch)
        first_s = time.perf_counter() - t0
        got_q = col.quantized_search_batch(queries, **quant)
        got_f = col.funnel_search_batch(queries, **funnel)
        got_h = col.hybrid_search_batch(queries, limit=10, generators=gens)
        ivf_rows, _raws = ivf.search_device(qdev, nprobe=IVF_OPTS["n_probe"], k=10)
        got_mv = mvcol.multi_vector_search_batch(sets, limit=10)
        sync_all(torch)
    launches = {**fs.LAUNCHES, **ms.LAUNCHES}
    card_launches = cards_launched(_build, mesh, (
        "gmin_scan", "rescore", "stage_gmin_scan", "sign_scan", "extract_group_rows",
        "maxsim_rank_scan"), f"{tag}a-{tag}e")
    assert col.index.reruns == 0, f"plain-scan reruns on the mesh: {col.index.reruns}"
    assert col.host_routes == 0 and mvcol.host_routes == 0, (col.host_routes, mvcol.host_routes)
    flat_swaps = same_rows(got, inp["exact"], f"{tag}a flat")
    swaps = {"quantized": same_rows(got_q, inp["got_q"], f"{tag}b quantized"),
             "funnel": same_rows(got_f, inp["got_f"], f"{tag}b funnel"),
             "hybrid": same_rows(got_h, inp["got_h"], f"{tag}b flat hybrid"),
             "maxsim": same_rows(got_mv, inp["mv_exact"], f"{tag}e MaxSim")}
    ivf_ids = [[ids[r] for r in row if r >= 0] for row in ivf_rows.cpu().tolist()]
    ivf_recall = recall_at(ivf_ids, exact_ids)
    assert ivf_recall >= IVF_RECALL_MIN, f"mesh IVF recall@10 {ivf_recall}"
    log(f"  {tag}a flat ({N_CORPUS}x{D_MAIN} over {shards} shards of "
        f"{col.index._sharded._x.rows} rows): put_matrix (through put_many) {put_s:.1f}s, "
        f"first search_batch (shards + upload + search) {first_s:.1f}s; ids equal phase 4's "
        f"({flat_swaps} near-tie swaps), plain-scan reruns 0 {card}")
    log(f"  {tag}b configs 3 and 4 and the flat hybrid on the mesh: ids equal phases 4b and "
        f"4e (near-tie swaps {swaps}); {tag}d IVF build {ivf_build_s:.2f}s, recall@10 "
        f"{ivf_recall:.4f} at n_probe {IVF_OPTS['n_probe']}; {tag}e config 5 put_tokens "
        f"{mv_put_s:.1f}s, ids equal phase 6's on {len(sets)} sets; host routes 0; launches "
        f"{launches}, per card {card_launches} {card}")
    errs, rels = calls.check(torch, f"{tag} mesh", card)

    # each recorded kernel call at its shard shape, timed
    shard_ms = {}
    for (name, _sig), (args, kwargs) in calls.calls.items():
        count = PATH_KERNELS[name][0]
        holder = fs if hasattr(fs, name) else ms
        with on_card(torch, args[0]):  # the events on the kernel's card
            t = cuda_ms(torch, lambda: getattr(holder, name)(*args, **kwargs), reps=5)
        # the mesh runs K2 on f32 flat shards and on IVF's bf16 shards
        key = "rescore_ivf" if count == "rescore" and args[0].dtype == torch.bfloat16 else count
        shard_ms[key] = max(shard_ms.get(key, 0.0), t)
    del args, kwargs
    log("  kernels at the shard shapes, ms per call (one device's in brackets): "
        + ", ".join(f"{k} {v:.3f} ({one['kernel_ms'].get(k, float('nan')):.3f})"
                    for k, v in sorted(shard_ms.items())) + f" {card}")
    del calls

    # per mode: ms per batch and the device split, on the mesh
    sharded = col.index._sharded
    cache = mvcol._scan_cache()
    qtok, qmask = mvcol._pad_query_sets(sets)
    runs = {
        "flat": lambda: sharded.search_device(qdev, 10),
        "quantized": lambda: col.quantized_search_batch_device(qdev, **quant),
        "funnel": lambda: col.funnel_search_batch_device(qdev, **funnel),
        "ivf": lambda: ivf.search_device(qdev, nprobe=IVF_OPTS["n_probe"], k=10),
        "maxsim": lambda: mvcol._mv_full_scan(cache, qtok, qmask, metric="cosine", k=10),
    }
    for mode, fn in runs.items():
        out["timing"][mode] = (host_ms(torch, fn), *profile_runs(
            torch, {f"{tag} mesh {mode}": fn}, card, by_card=True)[f"{tag} mesh {mode}"])
    hyb_ms = host_ms(torch, lambda: col.hybrid_search_batch(queries, limit=10, generators=gens),
                     reps=1)
    assert sharded.reruns == 0 and col.host_routes == 0 and mvcol.host_routes == 0
    del col, mvcol, cache, sharded, ivf, got_q, got_f, got_h, got_mv
    torch.cuda.empty_cache()

    # ---- 7c: ShardedHnsw over the same corpus, then writes ---------------
    ef = HNSW_OPTS["ef_search"]

    def recall_of(index, ef=ef):
        rows, _raws = index.search_device(qdev, ef=ef, k=10)
        return recall_at([[ids[r] for r in row if r >= 0] for row in rows.cpu().tolist()],
                         exact_ids)

    # the default (auto: kNN) build per shard: below the bar on these
    # shards (an open fault of the build in both packages), so recorded at
    # ef 64 and wider beams, not gated
    t0 = time.perf_counter()
    knn = ShardedHnsw("cosine", mesh, ids, stored, options=HNSW_OPTS)
    sync_all(torch)
    knn_build_s = time.perf_counter() - t0
    knn_recalls = {e: recall_of(knn, e) for e in (ef, 2 * ef, 4 * ef)}
    knn_recall = knn_recalls[ef]
    del knn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hnsw = ShardedHnsw("cosine", mesh, ids, stored, options=MESH_HNSW_OPTS)
    sync_all(torch)
    hnsw_build_s = time.perf_counter() - t0
    hnsw_recall = recall_of(hnsw)
    assert hnsw_recall >= HNSW_RECALL_MIN, f"mesh HNSW recall@10 {hnsw_recall}"
    out["timing"]["hnsw"] = (host_ms(torch, lambda: hnsw.search_device(qdev, ef=ef, k=10)),
                             *profile_runs(torch, {f"{tag} mesh hnsw": lambda: hnsw.search_device(
                                 qdev, ef=ef, k=10)}, card, by_card=True)[f"{tag} mesh hnsw"])
    new = near_queries(rng, stored, MESH_PUT_MANY)
    new_ids = [f"new-{i:05d}" for i in range(MESH_PUT_MANY)]
    t0 = time.perf_counter()
    hnsw.incremental_put(new_ids, new)
    sync_all(torch)
    put_many_s = time.perf_counter() - t0
    gone = rng.choice(len(ids), MESH_DELETES, replace=False)
    t0 = time.perf_counter()
    removed = hnsw.incremental_delete([ids[i] for i in gone])
    sync_all(torch)
    delete_s = time.perf_counter() - t0
    assert removed == MESH_DELETES, removed
    all_ids = ids + new_ids
    rows_t = torch.from_numpy(np.concatenate([stored, new])).to(dev)
    live = torch.ones(len(all_ids), dtype=torch.bool, device=dev)
    live[torch.from_numpy(gone).to(dev)] = False
    near_new = near_queries(rng, new, B_MAIN)
    recalls = {}
    for label, q in (("phase 4's queries", prepared), ("near the new rows", near_new)):
        truth = [w[0][:10] for w in f64_top(torch, rows_t, live, all_ids, q, 10)]
        rows, _raws = hnsw.search_device(torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                                         ef=ef, k=10)
        got_ids = [[hnsw.ids[r] for r in row if r >= 0] for row in rows.cpu().tolist()]
        gone_ids = {ids[i] for i in gone}
        assert not any(i in gone_ids for row in got_ids for i in row), "a deleted id returned"
        recalls[label] = recall_at(got_ids, truth)
        assert recalls[label] >= HNSW_RECALL_MIN, f"mesh HNSW recall@10 {label} {recalls}"
    log(f"  {tag}c ShardedHnsw ({shards} shards): the auto (kNN) build per shard "
        f"{knn_build_s:.1f}s, recall@10 "
        + ", ".join(f"{v:.4f} at ef {e}" for e, v in knn_recalls.items())
        + f" ({'below' if knn_recall < HNSW_RECALL_MIN else 'at or above'} the "
        f"{HNSW_RECALL_MIN} bar at ef {ef}; recorded, not the gate); the wave "
        f"build per shard {hnsw_build_s:.1f}s, recall@10 {hnsw_recall:.4f}; incremental_put "
        f"of {MESH_PUT_MANY} {put_many_s:.2f}s, "
        f"{MESH_DELETES} incremental_deletes {delete_s:.2f}s; recall@10 over the live rows "
        + ", ".join(f"{k} {v:.4f}" for k, v in recalls.items()) + f" {card}")
    del hnsw, rows_t, live
    torch.cuda.empty_cache()

    # ---- 7f: data 2 x shard 2 at config 1's size, counted ----------------
    col3, data3, ids3, qs3, got3 = inp["base"]
    f1 = dict(limit=10, candidates=FUNNEL_C, stages=list(FUNNEL_STAGES))
    q1 = dict(limit=10, candidates=QUANT_C)
    want_f, want_q = col3.funnel_search_batch(qs3, **f1), col3.quantized_search_batch(qs3, **q1)
    mesh2 = make_mesh(list(mesh.devices[0]), data=2)
    col2 = vt.Collection(name="mesh-config-1", dimensions=data3.shape[1], metric="cosine",
                         mesh=mesh2)
    col2.put_matrix(ids3, data3)
    reset_counts(fs, ms)
    with PathCalls(fs, ms) as calls:
        got2 = (col2.search_batch(qs3, limit=10), col2.funnel_search_batch(qs3, **f1),
                col2.quantized_search_batch(qs3, **q1))
        sync_all(torch)
    launches2 = {**fs.LAUNCHES, **ms.LAUNCHES}
    # shards of 50,048 rows: the fused flat search (K1 + K2) and the funnel's
    # K5 + K7; the quantized stage's group cover starts at 65,536 rows
    card_launches2 = cards_launched(_build, mesh2, (
        "gmin_scan", "rescore", "stage_gmin_scan", "extract_group_rows"), f"{tag}f data 2")
    swaps2 = {"flat": same_rows(got2[0], got3, f"{tag}f flat"),
              "funnel": same_rows(got2[1], want_f, f"{tag}f funnel"),
              "quantized": same_rows(got2[2], want_q, f"{tag}f quantized")}
    assert col2.host_routes == 0 and col2.index.reruns == 0
    log(f"  {tag}f data 2 x shard 2 at config 1 ({data3.shape[0]}x{data3.shape[1]}, "
        f"{len(qs3)} queries): flat, funnel and quantized equal one device's (near-tie swaps "
        f"{swaps2}); launches {launches2}, per card {card_launches2} {card}")
    errs2, _rels2 = calls.check(torch, f"{tag}f mesh data 2", card)
    del col2, calls, got2

    t = out["timing"]
    one_t = one["timing"]
    log("  per mode, mesh against one device (ms per batch; device busy ms, idle share): "
        + "; ".join(f"{m} {t[m][0]:.3f} vs {one_t[m][0]:.3f} (busy {t[m][1]:.3f}, idle "
                    f"{max(0.0, 1 - t[m][1] / t[m][2]):.1%} vs busy {one_t[m][1]:.3f}, idle "
                    f"{max(0.0, 1 - one_t[m][1] / one_t[m][2]):.1%})" for m in t)
        + f"; flat hybrid sync {hyb_ms:.1f} ms {card}")
    if seven is not None:
        log(f"  {tag} per mode on the cards, ms per batch (virtual mesh, one device) and each "
            "card's busy ms: " + "; ".join(
                f"{m} {t[m][0]:.3f} ({seven[m][0]:.3f}, {one_t[m][0]:.3f}) busy "
                + "/".join(f"{v:.3f}" for v in t[m][3].values()) for m in t) + f" {card}")
    out.update(launches=launches, errs=errs, rels=rels, shard_ms=shard_ms,
               launches2=launches2, errs2=errs2, card_launches=card_launches,
               card_launches2=card_launches2,
               hnsw_recall=hnsw_recall, hnsw_recalls=recalls, hnsw_build_s=hnsw_build_s,
               knn_recall=knn_recall, knn_build_s=knn_build_s,
               ivf_recall=ivf_recall, ivf_build_s=ivf_build_s, put_s=put_s)
    return out


def cards_line(torch):
    """Every card's ``nvidia-smi --query-gpu=name,power.limit`` line and
    which pairs of cards have peer access; the label of phase 8's lines."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[:CARDS]
    for i, line in enumerate(smi):
        log(f"  cuda:{i}: {line}")
    peers = {f"{a}-{b}": torch.cuda.can_device_access_peer(a, b)
             for a in range(CARDS) for b in range(CARDS) if a != b}
    log(f"  peer access between the cards: {peers}")
    return "[" + "; ".join(smi) + "]"


def big_oracle(torch, xs, q, limit):
    """Exact top-``limit + 4`` of every query in float64, card by card over
    float64 chunks of each shard (global row = shard * rows + row), merged
    by (score desc, row asc): ``[(ids, scores)]``, ids the zero-padded
    rows."""
    width = limit + 4
    scores, rows = [], []
    for s, x in enumerate(xs):
        q64 = torch.from_numpy(q).to(x.device, torch.float64)
        for lo in range(0, x.shape[0], BIG_CHUNK):
            sims = x[lo:lo + BIG_CHUNK].double() @ q64.T  # [chunk, queries]
            v, i = sims.topk(min(width, sims.shape[0]), dim=0)
            scores.append(v.T.cpu().numpy())
            rows.append((i.T + s * x.shape[0] + lo).cpu().numpy())
            del sims
    scores, rows = np.concatenate(scores, axis=1), np.concatenate(rows, axis=1)
    out = []
    for b in range(q.shape[0]):
        order = sorted(range(scores.shape[1]), key=lambda j: (-scores[b, j], rows[b, j]))[:width]
        out.append(([f"{rows[b, j]:08d}" for j in order], [float(scores[b, j]) for j in order]))
    return out


def big_block(torch, rng, devices, card):
    """Phase 8b: a flat block larger than one card, ``BIG_SHARD`` rows per
    card generated there by ``synth.clustered`` (clusters of 100 rows,
    radius 0.4) with no host copy, valid rows, lex rank = global row;
    ``sharded_search`` of 512 near-queries at cosine, k = 10: 16 queries'
    ids against a float64 oracle, every K1 / K2 launch held against its
    plain version (K1 on the first ``BIG_CHECK`` rows of its shard, K2 at
    the path's shapes), ms per batch, each card's busy ms, gathered bytes,
    memory and reruns. Returns the launches, errors and K1's ms per card."""
    from vettore_tpu_torch import _build, synth
    from vettore_tpu_torch.ops import flat_scan as fs
    from vettore_tpu_torch.parallel import make_mesh, sharded_search
    from vettore_tpu_torch.parallel.cost import gathered_bytes

    mesh = make_mesh() if devices is None else make_mesh(devices)
    devs = list(mesh.devices[0])
    rows, d = BIG_SHARD, D_MAIN
    t0 = time.perf_counter()
    xs = []
    for s, dev in enumerate(devs):
        x = torch.empty((rows, d), dtype=torch.float32, device=dev)
        for c, lo in enumerate(range(0, rows, BIG_CHUNK)):
            n = min(BIG_CHUNK, rows - lo)
            x[lo:lo + n] = synth.clustered(n, d, max(1, n // 100), 0.4, SEED + 1000 * s + c,
                                           device=dev)
        xs.append(x)
    sync_all(torch)
    gen_s = time.perf_counter() - t0
    bx = mesh.place(xs)  # each shard already on its card: placed, not copied
    bv = mesh.place([torch.ones(rows, dtype=torch.bool, device=dev) for dev in devs])
    bl = mesh.place([torch.arange(s * rows, (s + 1) * rows, dtype=torch.int32, device=dev)
                     for s, dev in enumerate(devs)])
    total = len(devs) * rows
    # near-queries: 512 distinct rows of the block plus noise at the radius
    picks = rng.choice(total, B_MAIN, replace=False)
    base = np.empty((B_MAIN, d), np.float32)
    for s, x in enumerate(xs):
        mine = np.flatnonzero(picks // rows == s)
        base[mine] = x[torch.from_numpy(picks[mine] % rows).to(x.device)].cpu().numpy()
    q = base + np.float32(0.4 / np.sqrt(d)) * rng.standard_normal((B_MAIN, d), dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qdev = torch.from_numpy(q).to(mesh.first)

    def run():
        return sharded_search(mesh, bx, bv, bl, qdev, metric="cosine", k=10)

    reset_counts(fs)
    with PathCalls(fs) as calls:
        t1 = time.perf_counter()
        slots, raws = run()
        sync_all(torch)
        first_s = time.perf_counter() - t1
    launches = dict(fs.LAUNCHES)
    card_launches = cards_launched(_build, mesh, ("gmin_scan", "rescore"), "8b")
    assert mesh.reruns == 0, f"8b plain-scan reruns: {mesh.reruns}"
    truth = big_oracle(torch, xs, q[:BIG_ORACLE], 10)
    slots, raws = slots.cpu().numpy(), raws.cpu().numpy()
    swaps = sum(check_hits([(f"{r:08d}", float(w)) for r, w in zip(slots[b], raws[b]) if r >= 0],
                           truth[b], 10) for b in range(BIG_ORACLE))
    # each card's K1 and K2 calls against their plain versions
    errs, k1_ms = {}, {}
    for (name, _sig), (args, kwargs) in calls.calls.items():
        x, xsq, bias, qq = args[:4]
        if name == "gmin_scan":
            with on_card(torch, x):
                k1_ms[x.device.index] = cuda_ms(torch, lambda: fs.gmin_scan(*args, **kwargs),
                                                reps=5)
            part = [t[:BIG_CHECK] for t in (x, xsq, bias)]
            got = fs.gmin_scan(*part, qq, **kwargs)[0]
            want = fs._gmin_scan_ref(*part, qq, **kwargs)
            tol = K1_ATOL["f32"]
        else:
            got = fs.rescore(*args, **kwargs)
            want = fs._rescore_ref(*args, **kwargs)
            tol = K2_ATOL
        err, _rel = abs_rel_err(got, want)
        assert err <= tol, f"8b {name} on {x.device}: err {err}"
        errs[PATH_KERNELS[name][0]] = max(errs.get(PATH_KERNELS[name][0], 0.0), err)
        del got, want
    del calls, args, kwargs
    torch.cuda.empty_cache()
    batch_ms = host_ms(torch, run, reps=5)
    merge_bytes = gathered_bytes(mesh, run)
    busy, wall, per_card = profile_runs(torch, {"8b sharded_search": run}, card,
                                        by_card=True)["8b sharded_search"]
    mem = [torch.cuda.memory_allocated(dev) / 2**30 for dev in devs]
    assert mesh.reruns == 0, f"8b plain-scan reruns: {mesh.reruns}"
    k1_bound = bound(3 * 2 * rows * d * B_MAIN, "tf32", 4 * (rows * d + 2 * rows + 2 * B_MAIN * d
                                                            + B_MAIN + B_MAIN * rows // 64))
    log(f"  8b block {len(devs)} x {rows} x {d} f32 ({4 * total * d / 1e9:.1f} GB) generated on "
        f"the cards in {gen_s:.1f}s; first sharded_search {first_s:.2f}s; ids of "
        f"{BIG_ORACLE} queries equal the float64 oracle ({swaps} near-tie swaps), scores "
        f"within {SCORE_TOL}; K1 (first {BIG_CHECK} rows of each shard) and K2 held, errs "
        f"{errs}; launches {launches}, per card {card_launches}; reruns {mesh.reruns} {card}")
    log(f"  8b per batch of {B_MAIN}: {batch_ms:.3f} ms (every card synchronised), busy "
        f"{busy:.3f} ms summed over the cards, per card "
        + ", ".join(f"cuda:{i} {v:.3f}" for i, v in per_card.items())
        + f"; K1 alone per card at {rows} rows "
        + ", ".join(f"cuda:{i} {v:.3f}" for i, v in sorted(k1_ms.items()))
        + f" ms (bound {k1_bound[0]:.3f}); gathered {merge_bytes} bytes per batch; memory "
        "allocated " + ", ".join(f"{m:.1f}" for m in mem) + f" GiB {card}")
    del xs, bx, bv, bl
    torch.cuda.empty_cache()
    return {"launches": launches, "card_launches": card_launches, "errs": errs,
            "ms": batch_ms, "busy": per_card, "k1_ms": k1_ms, "gen_s": gen_s,
            "bytes": merge_bytes}


def cards_phase(torch, vt, rng, inp, one, seven):
    """Phase 8: the mesh over four real cards (``make_mesh()``, every card,
    when the machine has four; cards 0-3 when it has more): 8a, phase 7's
    runs on the cards (``mesh_phase``), then 8b, a flat block larger than
    one card (``big_block``). Returns both's outputs."""
    devices = None if torch.cuda.device_count() == CARDS else [
        torch.device("cuda", i) for i in range(CARDS)]
    card = cards_line(torch)
    t0 = time.perf_counter()
    out = mesh_phase(torch, vt, rng, inp, one, card, devices=devices, tag="8a/7", seven=seven)
    torch.cuda.empty_cache()
    log(f"  8a phase 7's runs on {CARDS} cards: {time.perf_counter() - t0:.1f}s {card}")
    t0 = time.perf_counter()
    out["big"] = big_block(torch, rng, devices, card)
    log(f"  8b: {time.perf_counter() - t0:.1f}s {card}")
    return out


def profile_runs(torch, runs, card, reps=3, warm=True, by_card=False):
    """Traces ``reps`` calls of each run with ``torch.profiler`` (after one
    untraced call unless ``warm`` is false: a write runs once) and prints
    device-busy and wall ms per call, the device's idle share, and the
    kernels that took the most device time. Returns (busy, wall) ms per
    call by label (busy summed over the cards), and with ``by_card`` also
    ``{card index: busy ms per call}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, fn in runs.items():
        if warm:
            fn()
        sync_all(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync_all(torch)
            wall = 1e3 * (time.perf_counter() - t0) / reps
        # device events only: an operator's row repeats its kernels' time
        kernels = sorted((e for e in prof.key_averages() if e.device_type != DeviceType.CPU),
                         key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
        top = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / reps:.3f}"
                        for e in kernels[:4])
        log(f"  profile {label}: device busy {busy:.3f} ms per call, wall {wall:.3f} ms, "
            f"idle {max(0.0, 1 - busy / wall):.1%}; top kernels (ms per call): {top} {card}")
        out[label] = (busy, wall)
        if by_card:
            cards = {}
            for e in prof.events():
                if e.device_type != DeviceType.CPU:
                    cards[e.device_index] = (cards.get(e.device_index, 0.0)
                                             + e.self_device_time_total / 1e3 / reps)
            cards = dict(sorted(cards.items()))
            if len(cards) > 1:
                log(f"  profile {label} per card: " + ", ".join(
                    f"cuda:{i} busy {v:.3f} ms, idle {max(0.0, 1 - v / wall):.1%}"
                    for i, v in cards.items()) + f" {card}")
            out[label] = (busy, wall, cards)
    return out


def sync_all(torch):
    """Waits for every visible card (``torch.cuda.synchronize()`` waits for
    the current one only)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def on_card(torch, t):
    """The device guard of ``t``'s card (nothing for a CPU tensor)."""
    return torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext()


def cards_launched(build, mesh, names, label):
    """Each of ``names`` launched on every card of ``mesh`` since the counts
    were reset (``build.CARD_LAUNCHES``, counted where a kernel launches):
    ``{name: [launches per card]}``, cards in index order."""
    cards = sorted({d.index or 0 for d in mesh.distinct()})
    counts = {name: [build.CARD_LAUNCHES.get((name, c), 0) for c in cards] for name in names}
    missing = {name: n for name, n in counts.items() if not all(n)}
    assert not missing, f"{label}: kernels a card did not launch (cards {cards}): {missing}"
    return counts


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
    from vettore_tpu_torch.ops import maxsim as ms
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
    errs = {"gmin_scan": 0.0, "gmin_scan_bf16": 0.0, "rescore": 0.0, "rescore_bf16": 0.0}
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
            sfx = "" if storage == "f32" else "_bf16"
            errs["gmin_scan" + sfx] = max(errs["gmin_scan" + sfx], e1)
            errs["rescore" + sfx] = max(errs["rescore" + sfx], e2)
            t = {
                "k1": cuda_ms(torch, lambda: fs.gmin_scan(x, xsq, bias, q, metric=metric)),
                "k1_plain": cuda_ms(torch, lambda: fs._gmin_scan_ref(x, xsq, bias, q,
                                                                     metric=metric)),
                "k2": cuda_ms(torch, lambda: fs.rescore(x, xsq, bias, q, gidx, metric=metric)),
                "k2_plain": cuda_ms(torch, lambda: fs._rescore_ref(x, xsq, bias, q, gidx,
                                                                   metric=metric)),
            }
            t["k2_rows"] = distinct_rows(gidx)
            times[(storage, metric)] = t
            log(f"  K1 gmin_scan {storage} {metric}: err {e1:.3g} (atol {K1_ATOL[storage]}), "
                f"{t['k1']:.3f} ms vs plain {t['k1_plain']:.3f} ms | K2 rescore: err "
                f"{e2:.3g} (atol {K2_ATOL}), {t['k2']:.3f} ms vs plain {t['k2_plain']:.3f} ms; "
                f"{sharing(gidx)} {card}")
        # the product alone on K1's operands, in the precision K1 keeps: a
        # yardstick of the matmul only (K1 also ranks and reduces, and never
        # writes the [B, N] matrix), so it is logged and not library_ms
        qk = q if storage == "f32" else q.to(torch.bfloat16)
        mm = cuda_ms(torch, lambda: torch.matmul(qk, x.T))
        log(f"  K1 {storage}: product-only yardstick torch.matmul {qk.dtype} [{B_MAIN}, "
            f"{D_MAIN}] x [{D_MAIN}, {N_MAIN}] {mm:.3f} ms; routes {fs.ROUTES['gmin_scan']} "
            f"{card}")
    del x
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[phase 2] kernels match their plain versions at N={N_MAIN} d={D_MAIN} "
        f"B={B_MAIN} ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 2b: the adaptive kernels against their plain versions ------
    t0 = time.perf_counter()
    adaptive_errs, adaptive_times = adaptive_kernels(torch, fs, select, x32, bias, q, card)
    errs.update(adaptive_errs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[phase 2b] K5/K6/K7 match their plain versions at N={N_MAIN} d={D_MAIN} "
        f"B={B_MAIN} ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 2c: K3/K4 and the MaxSim kernel against their plain versions
    t0 = time.perf_counter()
    int8_errs, rel_errs, int8_times = int8_kernels(torch, fs, select, x32, bias, q, card)
    errs.update(int8_errs)
    mass_errs, mass_rel = mass_sharing(torch, fs, select, x32, xsq, bias, q, card)
    for name, a in mass_errs.items():
        errs[name] = max(errs[name], a)
    rel_errs["int8_rescore"] = max(rel_errs["int8_rescore"], mass_rel["int8_rescore"])
    del x32, xsq, bias, q
    torch.cuda.empty_cache()
    mv_errs, mv_rel, mv_times = maxsim_kernels(torch, ms, card)
    errs.update(mv_errs)
    rel_errs.update(mv_rel)
    torch.cuda.synchronize()
    log(f"[phase 2c] K3 bit-equal and K4 match at N={N_MAIN} d={D_MAIN} B={B_MAIN} (K2 and K4 "
        f"also on 512 copies of one query); the "
        f"MaxSim kernel matches at config 5's shape ({time.perf_counter() - t0:.1f}s)")

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
    reset_counts(fs)
    t1 = time.perf_counter()
    got = col.search_batch(queries, limit=10)  # first call uploads the block
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    launches = dict(fs.LAUNCHES)
    assert launches["gmin_scan"] > 0 and launches["rescore"] > 0, (
        f"kernels not launched: {launches}")
    assert fs.ROUTES["gmin_scan"] == {"direct": launches["gmin_scan"], "padded": 0}, fs.ROUTES
    assert fs.ROUTES["rescore"] == {"direct": launches["rescore"], "narrow": 0}, fs.ROUTES
    stored = normalize_rows(corpus, "l2")  # the bytes the collection stores
    truth = f64_oracle(stored, ids, queries[:32], 10)
    swaps = sum(check_hits([(r.id, r.score) for r in row], want, 10)
                for row, want in zip(got[:32], truth))
    assert col.index.host_routes == 0, f"host-oracle routes: {col.index.host_routes}"
    view = col.index.storage_view("bf16")
    reset_counts(fs)
    got16 = view.search_batch(normalize_rows(queries, "l2"), 10)
    torch.cuda.synchronize()
    launches16 = dict(fs.LAUNCHES)
    assert launches16["gmin_scan"] > 0 and launches16["rescore"] > 0, launches16
    assert fs.ROUTES["gmin_scan"] == {"direct": launches16["gmin_scan"], "padded": 0}, fs.ROUTES
    assert fs.ROUTES["rescore"] == {"direct": launches16["rescore"], "narrow": 0}, fs.ROUTES
    overlap = float(np.mean([len({h[0] for h in a} & {r.id for r in b}) / 10
                             for a, b in zip(got16, got)]))
    assert overlap >= 0.95, f"bf16 overlap@10 {overlap}"
    qdev = torch.from_numpy(normalize_rows(queries, "l2")).to(dev)
    ms_f32 = host_ms(torch, lambda: col.index.search_batch_device(qdev, 10))
    ms_bf16 = host_ms(torch, lambda: view.search_batch_device(qdev, 10))
    ms_sync = host_ms(torch, lambda: col.search_batch(queries, limit=10), reps=5)
    assert col.index.host_routes == 0
    torch.cuda.synchronize()
    log(f"  ingest {ingest_s:.1f}s, first search_batch (upload + search) {first_s:.1f}s")
    log(f"  search_batch_device B={B_MAIN}: f32 {ms_f32:.3f} ms, bf16 {ms_bf16:.3f} ms; "
        f"search_batch (sync, hydrated) f32 {ms_sync:.3f} ms {card}")
    prof4 = profile_runs(torch, {
        "flat f32 device": lambda: col.index.search_batch_device(qdev, 10),
        "flat bf16 device": lambda: view.search_batch_device(qdev, 10)}, card)
    log(f"[phase 4] {N_CORPUS}x{D_MAIN} cosine f32: ids equal the f64 oracle on 32 queries ({swaps} "
        f"near-tie swaps), host routes f32 0 / bf16 {view.host_routes}, bf16 overlap@10 "
        f"{overlap:.4f}, launches f32 {launches}, bf16 {launches16}, K1 and K2 all on the "
        f"direct route ({time.perf_counter() - t0:.1f}s)")
    del view
    torch.cuda.empty_cache()

    # ---- phase 4c: int8 storage view of the same index ---------------------
    t0 = time.perf_counter()
    int8_launches, int8_overlap, ms_int8 = int8_view(torch, col, queries, got, card)
    torch.cuda.empty_cache()
    log(f"[phase 4c] int8 view: overlap@10 {int8_overlap:.4f} against exact f32, host routes "
        f"0, launches {int8_launches} ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 4b: BASELINE configs 3 and 4 on the same collection --------
    t0 = time.perf_counter()
    adaptive_launches, funnel16_launches, adaptive_out = adaptive_modes(
        torch, col, stored, queries, got, card)
    del stored
    torch.cuda.empty_cache()
    log(f"[phase 4b] configs 3 and 4 ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 4e: a flat hybrid on the same collection --------------------
    t0 = time.perf_counter()
    hybrid_launches, hybrid_ms, hybrid_busy, hybrid_wall, hybrid_errs, got_h = flat_hybrid(
        torch, col, queries, card)
    log(f"[phase 4e] flat hybrid (funnel + quantized + search, exact rerank, batch {B_MAIN}): "
        f"ids equal phase 4's exact results, host routes 0, {hybrid_ms:.3f} ms per sync batch "
        f"(busy {hybrid_busy:.3f} ms, idle {max(0.0, 1 - hybrid_busy / hybrid_wall):.1%}) "
        f"({time.perf_counter() - t0:.1f}s)")

    # ---- phase 4g: IVF on the same corpus; compressed; config 1's IVF -----
    t0 = time.perf_counter()
    ivf, ivf_launches, ivf_errs = ivf_phase(torch, vt, rng, col, corpus, queries, got,
                                            (col3, ids3, data3, qs3, got3), card)
    del col
    torch.cuda.empty_cache()
    log(f"[phase 4g] IVF ({N_CORPUS}x{D_MAIN} cosine, bf16, batch {B_MAIN}, limit 10): build "
        f"{ivf['build_s']:.2f}s, two builds bit-equal; recall@10 "
        + ", ".join(f"{r:.4f} at n_probe {p}" for p, r in ivf["sweep"].items())
        + f"; {ivf['ms']:.3f} ms per device batch, {ivf['sync_ms']:.3f} ms per sync batch "
        f"(busy {ivf['busy']:.3f} ms, idle {max(0.0, 1 - ivf['busy'] / ivf['wall']):.1%}); "
        f"recall held through the writes; full probe equals exact flat at config 1; "
        f"launches {ivf_launches} ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 4d: BASELINE config 2, HNSW on the same corpus -------------
    t0 = time.perf_counter()
    hnsw = hnsw_config2(torch, vt, rng, corpus, ids, queries, got, card)
    log(f"[phase 4d] config 2 HNSW ({N_CORPUS}x{D_MAIN} cosine, m 16, m0 32, ef_search 64, "
        f"batch {B_MAIN}, limit 10): recall@10 {hnsw['recall']:.4f} against exact flat, build "
        f"{hnsw['build_s']:.1f}s, {hnsw['ms']:.3f} ms per batch (busy {hnsw['busy']:.3f} ms, "
        f"idle {max(0.0, 1 - hnsw['busy'] / hnsw['wall']):.1%}); a host-built graph on the "
        f"device beam ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 5: snapshot round trip -------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "baseline-1.vsnap")
        col3.snapshot(path)
        loaded = vt.load_snapshot(path, device=dev)
        again = loaded.search_batch(qs3, limit=10)
        assert [[r.id for r in row] for row in again] == [[r.id for r in row] for row in got3]
        loaded.close()
    torch.cuda.synchronize()
    log(f"[phase 5] snapshot written and loaded back: same ids "
        f"({time.perf_counter() - t0:.1f}s)")

    # ---- phase 6: BASELINE config 5, exact MaxSim --------------------------
    t0 = time.perf_counter()
    mv_launches, _ms_mv, _ms_mv_sync, mv_state = maxsim_config5(torch, vt, rng, card)
    ragged_launches = maxsim_ragged(torch, vt, rng, mv_state["sets"], card)
    log(f"[phase 6] config 5 exact MaxSim ({MV_N}x{MV_T}x{MV_D} bf16, {MV_SETS} sets of "
        f"{MV_Q}, limit 10, batch {MV_B}): ids equal the f64 oracle, ok all true, launches "
        f"maxsim_rank_scan {mv_launches['maxsim_rank_scan']}; the ragged f32 corpus "
        f"({time.perf_counter() - t0:.1f}s)")

    # ---- phase 6b: config 5's hybrid, MMR and MUVERA on the same corpus ---
    t0 = time.perf_counter()
    c5 = hybrid_config5(torch, vt, mv_state, card)
    mv_state["col"].close()
    mesh_in = {"corpus": corpus, "ids": ids, "queries": queries, "exact": got,
               "got_q": adaptive_out["got_q"], "got_f": adaptive_out["got_f"], "got_h": got_h,
               "base": (col3, data3, ids3, qs3, got3), "mv_ids": mv_state["ids"],
               "mv_tokens": mv_state["tokens"], "mv_sets": mv_state["sets"],
               "mv_exact": mv_state["exact"]}
    mv_timing = mv_state["timing"]
    del mv_state
    torch.cuda.empty_cache()
    log(f"[phase 6b] config 5 hybrid (hnsw + quantized, {HYBRID_C} candidates each, MaxSim "
        f"rerank, limit {HYBRID_LIMIT}, batch {MV_B}): equal to the f64 oracle over its "
        f"candidate unions, "
        f"{c5['hybrid_ms']:.3f} ms per sync batch (busy {c5['hybrid_busy']:.3f} ms), overlap@10 "
        f"{c5['hybrid_overlap']:.4f}; MMR {c5['mmr_ms']:.3f} ms; MUVERA candidates {MUVERA_C}: "
        + ", ".join(f"width {m['width']} {m['ms']:.3f} ms, overlap@10 {m['overlap']:.4f}"
                    for m in c5["muvera"].values())
        + f"; graph build {c5['build_s']:.1f}s ({time.perf_counter() - t0:.1f}s)")

    # ---- phase 7: the mesh, 4 virtual shards of the card ------------------
    t0 = time.perf_counter()
    one = {"timing": {
        "flat": (ms_f32, *prof4["flat f32 device"]),
        "quantized": (adaptive_out["ms"]["quantized device"],
                      *adaptive_out["profile"]["quantized device"]),
        "funnel": (adaptive_out["ms"]["funnel device"], *adaptive_out["profile"]["funnel device"]),
        "ivf": (ivf["ms"], ivf["busy"], ivf["wall"]),
        "maxsim": mv_timing,
        "hnsw": (hnsw["ms"], hnsw["busy"], hnsw["wall"])},
        "kernel_ms": {"gmin_scan": times[("f32", "cosine")]["k1"],
                      "rescore": times[("f32", "cosine")]["k2"],
                      "rescore_ivf": ivf["k2"]["n_probe 4"][1],
                      "stage_gmin_scan": adaptive_times["k5_f32"],
                      "sign_scan": adaptive_times["k6"],
                      "extract_group_rows": adaptive_times["k7"],
                      "maxsim_rank_scan": mv_times["maxsim_rank_scan"]["ms"]}}
    mesh_out = mesh_phase(torch, vt, rng, mesh_in, one, card, devices=[dev] * MESH_SHARDS)
    torch.cuda.empty_cache()
    log(f"[phase 7] the mesh ({MESH_SHARDS} virtual shards of one card): flat, configs 3 and "
        f"4, the flat hybrid, config 5 MaxSim and data 2 x shard 2 equal one device; HNSW "
        f"recall@10 {mesh_out['hnsw_recall']:.4f} (wave build {mesh_out['hnsw_build_s']:.1f}s; "
        f"the kNN build's {mesh_out['knn_recall']:.4f}), "
        + ", ".join(f"{k} {v:.4f}" for k, v in mesh_out["hnsw_recalls"].items())
        + f" after the writes; IVF recall@10 {mesh_out['ivf_recall']:.4f} (build "
        f"{mesh_out['ivf_build_s']:.2f}s); every kernel held at its shard shapes "
        f"({time.perf_counter() - t0:.1f}s)")

    # ---- phase 8: the mesh over four real cards ---------------------------
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    cards_out = None
    if n_cards >= CARDS:
        cards_out = cards_phase(torch, vt, rng, mesh_in, one, mesh_out["timing"])
        big = cards_out["big"]
        log(f"[phase 8] the mesh over {CARDS} cards: phase 7's runs equal one device, every "
            f"card launched each kernel its shards run; the {CARDS} x {BIG_SHARD} x {D_MAIN} "
            f"block (larger than one card) equals the float64 oracle, {big['ms']:.3f} ms per "
            f"batch of {B_MAIN} ({time.perf_counter() - t0:.1f}s)")
    else:
        log(f"[phase 8] {n_cards} card(s): not run")
    col3.close()
    del mesh_in, corpus, got
    torch.cuda.empty_cache()

    # bounds from this run's shapes: the cosine main configurations, config
    # 5's full bf16 and f32 blocks; K2 and K4 read the distinct selected rows
    n, d, b, g = N_MAIN, D_MAIN, B_MAIN, N_MAIN // fs.GROUP
    gsel, dims, c7 = 16 + fs.GROUP_SLACK, FUNNEL_STAGES[0], QUANT_C
    main_t, bf16_t = times[("f32", "cosine")], times[("bf16", "cosine")]
    # K5 reads the prefix, its norms and biases and the query prefix (f32:
    # its two TF32 parts), writes the rank matrix and the group minima
    k5_out = 4 * (b + b * n + b * g) + 8 * n
    rows = [
        # f32 blocks: three TF32 products (3xTF32) over x, q_hi and q_lo
        ("gmin_scan", "flat_scan.cu", "flat_scan.py:134", launches, main_t["k1"],
         main_t["k1_plain"], None,
         bound(3 * 2 * n * d * b, "tf32", 4 * (n * d + 2 * n + 2 * b * d + b + b * g))),
        ("gmin_scan_bf16", "flat_scan.cu", "flat_scan.py:134", launches16, bf16_t["k1"],
         bf16_t["k1_plain"], None,
         bound(2 * n * d * b, "bf16", 2 * n * d + 4 * 2 * n + 2 * b * d + 4 * b + 4 * b * g)),
        # K2 and K4 read the distinct selected rows once (rescore_bytes)
        ("rescore", "flat_scan.cu", "flat_scan.py:208", launches, main_t["k2"],
         main_t["k2_plain"], None,
         bound(2 * b * gsel * 64 * d, "f32",
               rescore_bytes(main_t["k2_rows"], d, 4, b, gsel, metric="cosine"))),
        ("rescore_bf16", "flat_scan.cu", "flat_scan.py:208", launches16, bf16_t["k2"],
         bf16_t["k2_plain"], None,
         bound(2 * b * gsel * 64 * d, "f32",
               rescore_bytes(bf16_t["k2_rows"], d, 2, b, gsel, metric="cosine"))),
        ("int8_gmin_scan", "int8_scan.cu", "flat_scan.py:579", int8_launches, int8_times["k3"],
         int8_times["k3_plain"], None, int8_times["k3_bound"]),
        ("int8_rescore", "int8_scan.cu", "flat_scan.py:634", int8_launches, int8_times["k4"],
         int8_times["k4_plain"], None, int8_times["k4_bound"]),
        ("stage_gmin_scan", "adaptive_scan.cu", "flat_scan.py:380", adaptive_launches,
         adaptive_times["k5_f32"], adaptive_times["k5_f32_plain"], None,
         bound(3 * 2 * n * dims * b, "tf32", 4 * n * dims + 8 * b * dims + k5_out)),
        ("stage_gmin_scan_bf16", "adaptive_scan.cu", "flat_scan.py:380", funnel16_launches,
         adaptive_times["k5_bf16"], adaptive_times["k5_bf16_plain"], None,
         bound(2 * n * dims * b, "bf16", 2 * n * dims + 2 * b * dims + k5_out)),
        ("sign_scan", "adaptive_scan.cu", "flat_scan.py:518", adaptive_launches,
         adaptive_times["k6"], adaptive_times["k6_plain"], None,
         bound(2 * n * d * b, "int8", n * d + n + b * d + 2 * b * n + 4 * b * g)),
        ("extract_group_rows", "adaptive_scan.cu", "flat_scan.py:789", adaptive_launches,
         adaptive_times["k7"], adaptive_times["k7_plain"], adaptive_times["k7_lib"],
         bound(0, "f32", 2 * (b * c7 * 64 * 2) + 4 * b * c7)),
        *(("maxsim_rank_scan" + sfx, "maxsim.cu", "maxsim.py:526,490", counts,
           mv_times["maxsim_rank_scan" + sfx]["ms"], mv_times["maxsim_rank_scan" + sfx]["plain_ms"],
           None, mv_times["maxsim_rank_scan" + sfx]["bound"])
          for sfx, counts in (("", mv_launches), ("_f32", ragged_launches))),
        # K5 as MUVERA's candidate scan: the 2,048-wide bf16 FDE block
        ("stage_gmin_scan_fde", "adaptive_scan.cu", "flat_scan.py:380",
         {"stage_gmin_scan_fde": c5["k5_fde"]["launches"]}, c5["k5_fde"]["ms"],
         c5["k5_fde"]["plain_ms"], None, c5["k5_fde"]["bound"]),
        # K2 at IVF's shape: the routing's 4 blocks per query of the bf16 block
        ("rescore_ivf", "flat_scan.cu", "flat_scan.py:208", ivf_launches,
         ivf["k2"]["n_probe 4"][1], ivf["k2"]["n_probe 4"][2], None, ivf["k2"]["n_probe 4"][3]),
    ]
    errs["rescore_ivf"] = max(k[0] for k in ivf["k2"].values())
    # K5 on the FDE block is held to a relative tolerance, on MUVERA's
    # calls as alone
    errs["stage_gmin_scan_fde"] = c5["k5_fde"]["err"]
    rel_errs["stage_gmin_scan_fde"] = max([c5["k5_fde"]["rel"], *(
        m["rels"]["stage_gmin_scan"] for m in c5["muvera"].values())])
    # each kernel's launches on this slice's paths and its max abs error
    # against its plain version at the shapes they gave it, under the rows
    # of the storage each path scans: 4e's block is f32, MUVERA's FDE block
    # bf16
    new_paths = {
        "4e flat hybrid": (hybrid_launches, hybrid_errs, (
            "gmin_scan", "rescore", "stage_gmin_scan", "sign_scan", "extract_group_rows")),
        "6b hybrid": (c5["hybrid_launches"], c5["hybrid_errs"],
                      ("sign_scan", "extract_group_rows")),
        **{f"6b MUVERA {k}": (m["launches"], m["errs"],
                              ("stage_gmin_scan_fde", "extract_group_rows"))
           for k, m in c5["muvera"].items()},
        # the HNSW writes, the wave build and the compaction run no hand kernel
        "4f HNSW writes": (hnsw["writes"]["launches"], {}, ()),
        "4g IVF": (ivf_launches, ivf_errs, ("gmin_scan", "gmin_scan_bf16", "rescore",
                                            "rescore_bf16", "rescore_ivf", "sign_scan",
                                            "extract_group_rows")),
        # phase 7: f32 flat and cache shards, IVF's bf16 shards, config 5's
        # bf16 token shards
        "mesh": (mesh_out["launches"], mesh_out["errs"], (
            "gmin_scan", "rescore", "rescore_ivf", "stage_gmin_scan", "sign_scan",
            "extract_group_rows", "maxsim_rank_scan")),
        # 7f, data 2 x shard 2 at config 1: the f32 rows of what it launched
        "mesh data 2": (mesh_out["launches2"], mesh_out["errs2"], tuple(mesh_out["errs2"]))}
    if cards_out is not None:
        # phase 8: 8a's runs (as phase 7's, with data 2) and 8b's K1 + K2
        cards_launches = {name: cards_out["launches"][name] + cards_out["launches2"][name]
                          + cards_out["big"]["launches"].get(name, 0)
                          for name in cards_out["launches"]}
        cards_errs = dict(cards_out["errs"])
        for more in (cards_out["errs2"], cards_out["big"]["errs"]):
            for name, e in more.items():
                cards_errs[name] = max(cards_errs.get(name, 0.0), e)
        new_paths["mesh cards"] = (cards_launches, cards_errs, new_paths["mesh"][2])

    def base(name):
        return (name.removesuffix("_bf16").removesuffix("_f32").removesuffix("_fde")
                .removesuffix("_ivf"))

    def path_errs(name):
        return {path: path_e[base(name)] for path, (_l, path_e, path_rows) in new_paths.items()
                if name in path_rows}

    kernels = [
        {"name": name, "route": "cuda", "source": f"vettore_tpu_torch/csrc/{src}",
         "replaces": f"vettore_tpu/ops/{tpu}",
         "launches": counts[name] if name in counts else counts[base(name)],
         "max_abs_err": max([errs[name], *path_errs(name).values()]),
         "max_rel_err": rel_errs.get(name), "ms": k_ms,
         "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib_ms,
         "launches_on_new_paths": {path: launches[base(name)] if name in path_rows else 0
                                   for path, (launches, _e, path_rows) in new_paths.items()},
         "max_abs_err_on_new_paths": path_errs(name)}
        for name, src, tpu, counts, k_ms, plain_ms, lib_ms, bnd in rows
    ]
    for k in kernels:  # K7's kernel alone, beside its wrapper's time
        if k["name"] == "extract_group_rows":
            k["kernel_ms"] = adaptive_times["k7_kernel"]
        # the mesh's: the error of every row (null where the mesh launched
        # none) and the ms at the shard shapes
        for path in ("mesh", "mesh data 2", "mesh cards"):
            k["max_abs_err_on_new_paths"].setdefault(path, None)
        k["mesh_ms"] = mesh_out["shard_ms"].get(k["name"])
        # phase 8 (null where it did not run): launches on the cards and the
        # ms at the shard shapes on the cards
        k["launches_on_new_paths"].setdefault("mesh cards", None)
        k["mesh_cards_ms"] = cards_out["shard_ms"].get(k["name"]) if cards_out else None
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
