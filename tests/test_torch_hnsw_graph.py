"""The HNSW beam at a fixed batch, on the CPU.

``hnsw_device.search_impl`` runs every query of a batch through every
layer-0 step, converged or not (on a CUDA device those steps replay as
captured graphs; on the CPU they run eagerly, as here). It is held against
the loop it replaced, which took the converged queries out of the batch at
each read of the convergence flags (``_compacting_search`` below, kept as
it was), and against the JAX package's ``_search_impl``: the same ids, raw
scores within 1e-5 of JAX's (f32 sums in another order), and the same
``hnsw.steps`` and ``hnsw.nodes`` as the compacting loop. The cases cover
the three metrics, hub seeding and the greedy descent, bf16 and f32
traversal, a ``valid`` mask with tombstones, batches of 1, 5 and 64, ef at
the limit and at 64, a batch that converges before ``max_steps`` and one
that runs to it. The captured beams' padded batch sizes, the bound on the
beams a graph keeps and the step's duplicate test (``_repeats``) against
the pairwise mask it replaced are checked here too.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

jnp = pytest.importorskip("jax.numpy")

from vettore_tpu.index import hnsw as jhnsw
from vettore_tpu.index import hnsw_device as jdev
from vettore_tpu_torch import observability as obs
from vettore_tpu_torch.convert import hnsw_graph_state
from vettore_tpu_torch.index import hnsw_device as tdev
from vettore_tpu_torch.ops.topk import lex_sort, smallest

torch.set_num_threads(2)

RAW_TOL = 1e-5
PARAMS = {"m": 4, "m0": 8, "ef_construction": 32, "ef_search": 32}
LIMIT = 10


def _compacting_search(x, a0, up_index, up_adj, lex_rank, entry_slot, entry_level, queries, *,
                       metric, lmax, ef, limit, max_steps, xb=None, expand_w=None,
                       hub_slots=None, hub_x=None, hub_valid=None, valid=None):
    """The beam as it was before it kept a fixed batch: every
    ``_DONE_EVERY`` steps the converged queries left the working set.
    Returns ``(ids, raws, ranks, steps, nodes)``."""
    n, m0 = a0.shape
    dev = x.device
    B = queries.shape[0]
    words = (n + 31) // 32
    xt = x if xb is None else xb
    W = min(expand_w or tdev.EXPAND_W, ef)
    use_hubs = hub_slots is not None
    S = min(ef, max(W, 8), hub_x.shape[0]) if use_hubs else 1
    q = queries.float()
    qt = q.to(xt.dtype)
    rank_rows = tdev._rank_rows

    beam_d = torch.full((B, ef), float("inf"), device=dev)
    beam_id = torch.full((B, ef), -1, dtype=torch.int64, device=dev)
    beam_exp = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((B, words), dtype=torch.int64, device=dev)

    if use_hubs:
        hd = tdev._rank_matrix(qt, hub_x, metric)
        if hub_valid is not None:
            hd = hd.masked_fill(~hub_valid[None, :], float("inf"))
        seed_d, hpos = smallest(hd, S)
        ok_seed = torch.isfinite(seed_d)
        seeds = torch.where(ok_seed, hub_slots[hpos], -1)
        beam_d[:, :S] = seed_d
        beam_id[:, :S] = seeds
        tdev._set_bits(visited, seeds.clamp_min(0), ok_seed)
    else:
        g = torch.full((B,), int(entry_slot), dtype=torch.int64, device=dev)
        for layer in range(min(lmax, int(entry_level)), 0, -1):
            gd = rank_rows(xt[g][:, None, :], qt, metric)[:, 0]
            moved = torch.ones(B, dtype=torch.bool, device=dev)
            while bool(moved.any()):
                u = up_index[g].long()
                row = up_adj[u.clamp_min(0), layer - 1].long()
                row = torch.where((u >= 0)[:, None], row, torch.full_like(row, -1))
                ok = row >= 0
                dists = torch.where(ok, rank_rows(xt[row.clamp_min(0)], qt, metric),
                                    torch.full(row.shape, float("inf"), device=dev))
                j = dists.argmin(dim=1, keepdim=True)
                best = dists.gather(1, j)[:, 0]
                moved = best < gd
                g = torch.where(moved, row.gather(1, j)[:, 0], g)
                gd = torch.where(moved, best, gd)
        beam_d[:, 0] = rank_rows(xt[g][:, None, :], qt, metric)[:, 0]
        beam_id[:, 0] = g
        tdev._set_bits(visited, g[:, None], torch.ones((B, 1), dtype=torch.bool, device=dev))

    E = W * m0
    inf = float("inf")
    earlier = torch.ones((E, E), dtype=torch.bool, device=dev).tril(-1)
    a0x = torch.cat([a0, a0.new_full((1, m0), -1)])
    final_d, final_id = beam_d.clone(), beam_id.clone()
    live = torch.arange(B, device=dev)
    scored = 0
    steps = 0
    for step in range(max_steps):
        top_d, jpos = smallest(beam_d.masked_fill(beam_exp | (beam_id < 0), inf), W)
        best = top_d[:, 0]
        done = torch.isinf(best) | (best > beam_d[:, -1])
        n_done = 0
        if step and step % tdev._DONE_EVERY == 0:
            n_done = int(done.sum())
        if n_done:
            order = torch.sort(done.to(torch.int8), stable=True).indices
            keep, gone = order[:done.numel() - n_done], order[done.numel() - n_done:]
            final_d[live[gone]], final_id[live[gone]] = beam_d[gone], beam_id[gone]
            if not keep.numel():
                break
            live, beam_d, beam_id, beam_exp = live[keep], beam_d[keep], beam_id[keep], beam_exp[keep]
            visited, qt, top_d, jpos, done = (visited[keep], qt[keep], top_d[keep],
                                              jpos[keep], done[keep])
        expand_ok = torch.isfinite(top_d.masked_fill(done[:, None], inf))
        nodes = torch.where(expand_ok, beam_id.gather(1, jpos), n)
        nbrs = a0x.index_select(0, nodes.reshape(-1)).reshape(-1, E).long()
        dup = ((nbrs[:, None, :] == nbrs[:, :, None]) & earlier).any(dim=2)
        safe = nbrs.clamp_min(0)
        word, shift = safe >> 5, safe & 31
        seen = (visited.gather(1, word) >> shift) & 1
        fresh = (nbrs >= 0) & ~dup & (seen == 0)
        visited.scatter_add_(1, word, fresh.long() << shift)
        rows = xt.index_select(0, safe.reshape(-1)).reshape(*safe.shape, -1)
        nd = rank_rows(rows, qt, metric).masked_fill(~fresh, inf)
        steps += 1
        scored += int(fresh.sum())
        cat_d = torch.cat([beam_d, nd], dim=1)
        cat_id = torch.cat([beam_id, nbrs.masked_fill(~fresh, -1)], dim=1)
        cat_exp = torch.cat([beam_exp.scatter(1, jpos, beam_exp.gather(1, jpos) | expand_ok),
                             torch.zeros_like(fresh)], dim=1)
        beam_d, order = smallest(cat_d, ef)
        beam_id = cat_id.gather(1, order)
        beam_exp = cat_exp.gather(1, order)
    final_d[live], final_id[live] = beam_d, beam_id
    beam_id = final_id

    ok = beam_id >= 0
    safe = beam_id.clamp_min(0)
    if valid is not None:
        ok = ok & valid[safe]
        beam_id = torch.where(ok, beam_id, -1)
    rank32 = rank_rows(x[safe], q, metric).masked_fill(~ok, float("inf"))
    lex = torch.where(ok, lex_rank[safe].long(), tdev._BIG32)
    order = lex_sort(rank32, lex)
    top_id = beam_id.gather(1, order)[:, :limit]
    top_d = rank32.gather(1, order)[:, :limit]
    raw = top_d if metric == "l2" else tdev._dots(x[top_id.clamp_min(0)], q)
    return top_id, raw.masked_fill(top_id < 0, float("inf")), top_d, steps, scored


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def graphs():
    """A host graph of 400 x 16 per metric (the JAX package's, carried
    across), 64 queries, and a liveness mask with one slot in nine dead."""
    rng = np.random.default_rng(19)
    data = _unit(rng, 400, 16) * rng.uniform(0.5, 2.0, (400, 1)).astype(np.float32)
    q = _unit(rng, 64, 16)
    out = {}
    for metric in ("cosine", "l2", "inner_product"):
        index = jhnsw.HnswIndex(metric, PARAMS)
        index.put_many((f"g{i:04d}", v) for i, v in enumerate(data))
        jgraph = jdev.DeviceGraph(index)
        out[metric] = (jgraph, hnsw_graph_state(jgraph, device="cpu"))
    valid = np.ones(400, dtype=bool)
    valid[rng.choice(400, 44, replace=False)] = False
    return out, q, valid


def _inputs(jgraph, tgraph, *, traversal, hubs, valid):
    bf16 = traversal == "bf16"
    jkw = {"xb": jgraph.xb if bf16 else None}
    tkw = {"xb": tgraph.xb if bf16 else None}
    if valid is not None:
        jkw["valid"] = jnp.asarray(valid)
        tkw["valid"] = torch.from_numpy(valid)
    if hubs:
        jslots, jblock = jgraph.hubs(jnp.bfloat16 if bf16 else jnp.float32)
        tslots, tblock = tgraph.hubs(torch.bfloat16 if bf16 else torch.float32)
        jkw.update(hub_slots=jslots, hub_x=jblock)
        tkw.update(hub_slots=tslots, hub_x=tblock)
        if valid is not None:
            jkw["hub_valid"] = jnp.asarray(valid[np.asarray(jslots)])
            tkw["hub_valid"] = torch.from_numpy(valid)[tslots]
    return jkw, tkw


def _fixed(tgraph, q, beams, **kw):
    """The fixed-batch beam, with its ``hnsw.steps`` and ``hnsw.nodes``."""
    with profile(activities=[ProfilerActivity.CPU]):
        ids, raws, ranks = tdev.search_impl(
            tgraph.x, tgraph.a0, tgraph.up_index, tgraph.up_adj, tgraph.lex_rank,
            tgraph.entry_slot, tgraph.entry_level, torch.from_numpy(q), beams=beams, **kw)
    counters = obs.snapshot()["counters"]
    return ids.numpy(), raws.numpy(), ranks.numpy(), counters["hnsw.steps"], counters["hnsw.nodes"]


CASES = [
    # metric, hub seeding, traversal, tombstones, batch, ef
    ("cosine", True, "bf16", False, 64, 64),
    ("cosine", True, "f32", True, 5, LIMIT),
    ("cosine", False, "bf16", True, 1, 64),
    ("cosine", False, "f32", False, 64, LIMIT),
    ("l2", True, "bf16", True, 64, LIMIT),
    ("l2", True, "f32", False, 1, 64),
    ("l2", False, "bf16", False, 5, 64),
    ("l2", False, "f32", True, 64, 64),
    ("inner_product", True, "bf16", False, 5, LIMIT),
    ("inner_product", True, "f32", True, 64, 64),
    ("inner_product", False, "bf16", True, 64, LIMIT),
    ("inner_product", False, "f32", False, 1, LIMIT),
]


@pytest.mark.parametrize("metric,hubs,traversal,tombstones,b,ef,max_steps", [
    *[(*case, None) for case in CASES],
    ("cosine", True, "bf16", True, 64, 64, "converges"),
    ("l2", True, "bf16", False, 64, 64, 5),
])
def test_fixed_batch_beam_matches_compacting_loop_and_jax(graphs, metric, hubs, traversal,
                                                          tombstones, b, ef, max_steps):
    """``max_steps`` None: ``step_bound(ef)``; "converges": the bound, and
    every query must converge before it; 5: the loop must run to it (the
    last block one step long)."""
    by_metric, queries, valid = graphs
    jgraph, tgraph = by_metric[metric]
    q = queries[:b]
    bound = tdev.step_bound(ef) if max_steps in (None, "converges") else max_steps
    jkw, tkw = _inputs(jgraph, tgraph, traversal=traversal, hubs=hubs,
                       valid=valid if tombstones else None)
    common = {"metric": metric, "lmax": tgraph.lmax, "ef": ef, "limit": LIMIT,
              "max_steps": bound, "expand_w": 8}

    beams = tdev.BeamGraphs()
    ids, raws, ranks, steps, nodes = _fixed(tgraph, q, beams, **common, **tkw)
    # a second call reuses the adjacency copy and the mask: the same answer
    again = _fixed(tgraph, q, beams, **common, **tkw)
    for got, want in zip(again, (ids, raws, ranks, steps, nodes)):
        np.testing.assert_array_equal(got, want)

    rids, rraws, rranks, rsteps, rnodes = _compacting_search(
        tgraph.x, tgraph.a0, tgraph.up_index, tgraph.up_adj, tgraph.lex_rank,
        tgraph.entry_slot, tgraph.entry_level, torch.from_numpy(q), **common, **tkw)
    np.testing.assert_array_equal(ids, rids.numpy())
    np.testing.assert_array_equal(raws, rraws.numpy())
    np.testing.assert_array_equal(ranks, rranks.numpy())
    assert (steps, nodes) == (rsteps, rnodes)

    jids, jraws, _jranks = jdev._search_kernel(
        jgraph.x, jgraph.a0, jgraph.up_index, jgraph.up_adj, jgraph.lex_rank,
        jgraph.entry_slot, jgraph.entry_level, jnp.asarray(q), **common, **jkw)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    jraws = np.asarray(jraws)
    fin = np.isfinite(jraws)
    np.testing.assert_array_equal(np.isfinite(raws), fin)
    assert np.abs(raws[fin] - jraws[fin]).max(initial=0.0) <= RAW_TOL

    assert 0 < steps <= bound and nodes > 0
    if max_steps == "converges":
        assert steps < bound
    elif max_steps == 5:
        assert steps == 5
    if tombstones:
        dead = set(np.flatnonzero(~valid).tolist())
        assert not dead & set(ids[ids >= 0].tolist())


@pytest.mark.parametrize("span", [8, 1 << 20])
@pytest.mark.parametrize("shape", [(64, 4 * 32), (64, 8 * 32), (4, 64, 88)],
                         ids=["build step", "search step", "knn chunk"])
def test_repeats_equal_the_pairwise_earlier_mask(shape, span):
    """``_repeats`` (a stable sort) marks what the ``[..., E, E]`` mask it
    replaced marked: every key equal to an earlier key of its row, -1s
    included, at the shapes of the build's step, the search's step and the
    kNN build's candidate chunk. Few distinct keys (``span`` 8) and many,
    with runs of equal neighbours in both."""
    gen = torch.Generator().manual_seed(span)
    keys = torch.randint(0, span, shape, generator=gen)
    keys = torch.where(torch.rand(shape, generator=gen) < 0.3, keys.roll(1, -1), keys)
    keys[torch.rand(shape, generator=gen) < 0.1] = -1
    k = shape[-1]
    earlier = torch.ones((k, k), dtype=torch.bool).tril(-1)  # [i, j]: j < i
    want = ((keys[..., None, :] == keys[..., :, None]) & earlier).any(dim=-1)
    assert want.any() and not want.all()
    assert torch.equal(tdev._repeats(keys), want)


@pytest.mark.parametrize("b,bucket", [(1, 1), (5, 8), (64, 64), (65, 128), (300, 320),
                                      (512, 512), (513, 576)])
def test_a_batch_pads_to_its_bucket_by_fewer_than_64_rows(b, bucket):
    assert tdev._bucket(b) == bucket


@pytest.mark.parametrize("fit,chunk", [(0, 1), (1, 1), (50, 32), (64, 64), (976, 960)])
def test_a_chunk_is_the_largest_bucket_that_fits(fit, chunk):
    assert tdev._chunk(fit) == chunk and tdev._bucket(chunk) == chunk


def test_beam_graphs_keep_the_most_recently_used_beams():
    """Every ``ef`` above ``ef_search`` is a key of its own: beyond
    ``_BEAMS_KEPT`` the least recently used beam is dropped."""
    beams = tdev.BeamGraphs()
    kept = tdev._BEAMS_KEPT
    made = {key: beams.beam(key, object) for key in range(kept + 2)}
    assert list(beams._beams) == list(range(2, kept + 2))
    # a use of a kept key returns its beam and makes it the most recent
    assert beams.beam(2, lambda: pytest.fail("made again")) is made[2]
    beams.beam("new", object)
    assert list(beams._beams) == [*range(4, kept + 2), 2, "new"]
