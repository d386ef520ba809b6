"""BASELINE config 5's path through the port on the CPU, against the
benchmark's plain reference (``benchmark/reference/colbert_hybrid.py``).

A small corpus made with the configuration's generator
(``benchmark/data/synth.py``), at a size of its own: document bases in
100-row clusters, each document's tokens its base plus noise of norm 1.0,
each query one document's tokens plus noise of norm 0.4 and their
normalised mean as its primary row. The path is a user's: ``Collection(index="hnsw",
normalize="none").put_tokens``, ``hybrid_search_batch`` with the hnsw and
quantized generators and the MaxSim rerank, the hits' primary vectors read
with ``get``, ``ops.mmr.mmr_rerank_batch``; the answer is MMR's picks, then
the other hits in the hybrid's order.

With candidates covering the corpus the hybrid is exact MaxSim: the same ids
in the same order as the reference, scores within ``TOL`` a query token,
MMR's picks the reference's float64 greedy order. With fewer candidates the
scores are the reference's MaxSim of the returned documents and the hits
are in relevance order.
"""

import numpy as np
import pytest
import torch

import vettore_tpu_torch as vt
from benchmark.data import synth
from benchmark.reference import colbert_hybrid as ref
from vettore_tpu_torch.ops import mmr

torch.set_num_threads(2)

N, T, D = 400, 8, 32
LIMIT, PICKS, ALPHA = 30, 10, 0.5
#: the largest gap between a float32 MaxSim score and its float64 value,
#: per query token (each a cosine of float32 sums over D products)
TOL = 1e-6
OPTS = {"m": 16, "m0": 32, "ef_construction": 100, "ef_search": 64}


def _corpus(seed):
    dev = torch.device("cpu")
    bases = synth.clustered(N, D, 100, 0.4, synth.subseed(seed, 1), dev)
    tokens = synth.perturbed(bases.repeat_interleave(T, dim=0), 1.0,
                             synth.subseed(seed, 2)).view(N, T, D)
    return tokens


def _queries(tokens, q, seed, count=12):
    picks = synth.picks(N, count, synth.subseed(seed, 3), torch.device("cpu"))
    base = tokens[picks].repeat(1, -(-q // T), 1)[:, :q]
    qtok = synth.perturbed(base.reshape(-1, D), 0.4, synth.subseed(seed, 4)).view(count, q, D)
    primary = qtok.mean(dim=1)
    primary = primary / torch.linalg.vector_norm(primary, dim=1, keepdim=True)
    return torch.cat([primary[:, None], qtok], dim=1).numpy()


@pytest.fixture(scope="module")
def deployment():
    tokens = _corpus(2**31 + 5)
    col = vt.Collection(name="config5", dimensions=D, metric="cosine", normalize="none",
                        index="hnsw", index_options=OPTS, device="cpu")
    col.put_tokens([f"{i:03d}" for i in range(N)], tokens.numpy())
    return col, tokens


def _hybrid(col, queries, candidates):
    gens = [("hnsw", {"candidates": candidates}), ("quantized", {"candidates": candidates})]
    return col.hybrid_search_batch(queries[:, 0], limit=LIMIT, generators=gens,
                                   rerank=("multi_vector", [list(s) for s in queries[:, 1:]]))


def _answers(col, hits):
    """MMR's picks of each hit list, then the other hits in order:
    ``(rows [b, LIMIT], scores [b, LIMIT])``."""
    initial = [[(r.id, r.score) for r in row] for row in hits]
    vecs = np.stack([[col.get(r.id).vector for r in row] for row in hits])
    picks = mmr.mmr_rerank_batch(initial, vecs, metric="cosine", alpha=ALPHA, final_k=PICKS,
                                 device="cpu")
    rows, scores = [], []
    for first, rest in zip(picks, initial):
        taken = {i for i, _s in first}
        ordered = first + [h for h in rest if h[0] not in taken]
        rows.append([int(i) for i, _s in ordered])
        scores.append([s for _i, s in ordered])
    return np.array(rows, dtype=np.int64), np.array(scores)


QUERY_TOKENS = [pytest.param(8, id="q8"), pytest.param(32, id="q32")]


@pytest.mark.parametrize("q", QUERY_TOKENS)
def test_covering_candidates_give_the_reference_answer(deployment, q):
    col, tokens = deployment
    queries = _queries(tokens, q, seed=q)
    rows, scores = _answers(col, _hybrid(col, queries, N))
    want_rows, want_rel = ref.top_k([(0, tokens)], queries, LIMIT)
    assert rows.tolist() == want_rows.tolist()
    assert np.abs(scores - want_rel).max() <= TOL * q
    assert col.host_routes == 0


@pytest.mark.parametrize("q", QUERY_TOKENS)
def test_covering_candidates_rank_exactly(deployment, q):
    """Before MMR: the exact top LIMIT by (relevance desc, id asc)."""
    col, tokens = deployment
    queries = _queries(tokens, q, seed=q + 1)
    hits = _hybrid(col, queries, N)
    rel = ref.relevance(ref._cut(tokens, "f64"), ref._cut(torch.from_numpy(queries[:, 1:]), "f64"))
    for row, r in zip(hits, rel.numpy()):
        want = np.lexsort((np.arange(N), -r))[:LIMIT]
        assert [int(h.id) for h in row] == want.tolist()
        assert max(abs(h.score - r[int(h.id)]) for h in row) <= TOL * q


@pytest.mark.parametrize("q", QUERY_TOKENS)
@pytest.mark.parametrize("candidates", [40, 120])
def test_fewer_candidates_score_and_order_the_returned(deployment, q, candidates):
    col, tokens = deployment
    queries = _queries(tokens, q, seed=q + candidates)
    hits = _hybrid(col, queries, candidates)
    rows = np.array([[int(h.id) for h in row] for row in hits], dtype=np.int64)
    scores = np.array([[h.score for h in row] for row in hits])
    rel, _sim = ref.scores_of([(0, tokens)], queries, rows)
    assert np.abs(scores - rel).max() <= TOL * q
    # the hybrid's order is its float32 scores': exact relevance may only
    # rise across a near-tie within the scores' error
    assert (rel[:, 1:] - rel[:, :-1]).max() <= 2 * TOL * q
    assert (scores[:, 1:] <= scores[:, :-1]).all()


@pytest.mark.parametrize("q", QUERY_TOKENS)
def test_mmr_picks_are_the_reference_greedy_order(deployment, q):
    """MMR over each answer's own hits: the picks are the float64 greedy
    order of ``ref.mmr_order`` (exact relevance, float64 cosines of the
    primary vectors), and ``numbers`` reads no gap."""
    col, tokens = deployment
    queries = _queries(tokens, q, seed=q + 2)
    rows, scores = _answers(col, _hybrid(col, queries, 60))
    rel, sim = ref.scores_of([(0, tokens)], queries, rows)
    for r, s in zip(rel, sim):
        assert ref.mmr_order(r, s, PICKS) == list(range(PICKS))
    truth_rows, truth_rel = ref.top_k([(0, tokens)], queries, LIMIT)
    got = ref.numbers(rows, scores, truth_rows, truth_rel, (rel, sim))
    assert got["mmr_gap"] == 0.0 and got["order_gap"] <= 2 * TOL * q
    assert got["score_err"] <= TOL * q and 0.5 <= got["recall"] <= 1.0
