"""The ColBERT hybrid deployment's plain reference: every document scored by
MaxSim relevance, the ``k`` best by (relevance desc, row asc), of which
``DEPTH`` are picked first by maximal marginal relevance and the rest follow
in relevance order; in float64 (the reference) or with every unit operand
cut to TF32 and multiplied in float32 (the control, below the
configuration's float32).

A query is a ``[1 + Q, d]`` array: its pooled primary row (which only the
program's candidate generators read), then its ``Q`` tokens. A document's
relevance is the sum over the query's tokens of each one's largest cosine
over the document's ``T`` tokens. Its primary vector is the mean of its
tokens as given (``put_tokens`` with ``normalize="none"``), and MMR's
similarity of two documents the cosine of their primary vectors. Unit
tokens and primary vectors are worked out again here from the inputs.

``scores_of`` gives the float64 relevance of given (query, document) pairs
and the cosines of each answer's primary vectors; ``numbers`` the readings
that the checks hold.
"""

from __future__ import annotations

import numpy as np
import torch

#: MMR's picks, and its weight of relevance against similarity to the
#: picks before (the configuration's ``guarantees``)
DEPTH, ALPHA = 10, 0.5

#: candidates kept per query beyond ``k``, so that the final (relevance,
#: row) order is decided among enough near-ties
PAD = 4

#: elements of one block of token similarities
_BLOCK = 1 << 28


def _cut(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Unit rows of ``x`` in float64, or in float32 with the low 13 of the
    23 mantissa bits dropped, as a TF32 product reads them."""
    if precision == "f64":
        x = x.double()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    x = x.float()
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tokens(blocks, device) -> torch.Tensor:
    return torch.cat([x.to(device) if device is not None else x
                      for _first, x in sorted(blocks, key=lambda b: b[0])])


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` with TF32 off, so that a float32 product of cut operands
    is the TF32 product and no coarser one."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def relevance(units: torch.Tensor, qunits: torch.Tensor) -> torch.Tensor:
    """``[b, n]`` MaxSim relevance of ``n`` documents of unit tokens
    ``units [n, T, d]`` to ``b`` queries of unit tokens ``qunits [b, Q,
    d]``, block by block."""
    n, t, d = units.shape
    b, q, _ = qunits.shape
    out = torch.empty((b, n), dtype=units.dtype, device=units.device)
    qb = min(b, 64)
    m = max(1, _BLOCK // (qb * q * t))
    for i in range(0, b, qb):
        qq = qunits[i:i + qb]
        for j in range(0, n, m):
            docs = units[j:j + m]
            sim = _product(qq.reshape(-1, d), docs.reshape(-1, d))
            out[i:i + qb, j:j + m] = sim.view(qq.shape[0], q, docs.shape[0], t).amax(-1).sum(1)
            del sim
    return out


def _primary_units(tokens: torch.Tensor, precision: str) -> torch.Tensor:
    """Unit primary vectors of documents ``tokens [..., T, d]``: each the
    float64 mean of its tokens as given."""
    return _cut(tokens.double().mean(dim=-2), precision)


def mmr_order(rel: np.ndarray, sim: np.ndarray, m: int) -> list:
    """MMR's ``m`` picks among hits of relevance ``rel [k]`` and primary
    cosines ``sim [k, k]``: each next the hit of most ``ALPHA * rel - (1 -
    ALPHA) * (its largest cosine with a pick before it, 0 before the first
    pick)``, the earlier hit on a tie."""
    penalty, order = np.full(len(rel), -np.inf), []
    for _ in range(min(m, len(rel))):
        value = ALPHA * rel - (1 - ALPHA) * np.where(np.isfinite(penalty), penalty, 0.0)
        value[order] = -np.inf
        j = int(np.argmax(value))
        order.append(j)
        penalty = np.maximum(penalty, sim[j])
    return order


def top_k(blocks, queries, k: int, *, precision: str = "f64", device=None):
    """``(rows [b, k] int64, relevances [b, k] float64)`` numpy arrays:
    the ``DEPTH`` MMR picks among the ``k`` documents of highest relevance,
    then the others by (relevance desc, row asc). ``blocks`` is
    ``[(first_row, [n, T, d] tokens)]``, ``queries`` ``[b, 1 + Q, d]``."""
    tokens = _tokens(blocks, device)
    queries = torch.as_tensor(queries).to(tokens.device)
    rel = relevance(_cut(tokens, precision), _cut(queries[:, 1:], precision))
    vals, cand = rel.topk(min(k + PAD, rel.shape[1]), dim=1)
    vals, cand = vals.double().cpu().numpy(), cand.cpu().numpy()
    order = np.lexsort((cand, -vals), axis=-1)[:, :k]
    rows, rel = np.take_along_axis(cand, order, 1), np.take_along_axis(vals, order, 1)
    for i in range(rows.shape[0]):
        p = _primary_units(tokens[torch.from_numpy(rows[i]).to(tokens.device)], precision)
        sim = _product(p, p).double().cpu().numpy()
        picks = mmr_order(rel[i], sim, DEPTH)
        rest = [j for j in range(rows.shape[1]) if j not in picks]
        rows[i], rel[i] = rows[i, picks + rest], rel[i, picks + rest]
    return rows, rel


def scores_of(blocks, queries, rows: np.ndarray):
    """``(relevance [b, k], cosines [b, k, k] of each answer's primary
    vectors)`` of documents ``rows [b, k]``, in float64."""
    tokens = _tokens(blocks, None)
    queries = torch.as_tensor(queries)
    rel, sims = [], []
    for i in range(0, rows.shape[0], 64):
        docs = tokens[torch.from_numpy(rows[i:i + 64]).to(tokens.device)]
        q = _cut(queries[i:i + 64, 1:].to(tokens.device), "f64")
        rel.append(torch.einsum("bqd,bktd->bqkt", q, _cut(docs, "f64")).amax(-1).sum(1))
        p = _primary_units(docs, "f64")
        sims.append(p @ p.transpose(1, 2))
    return torch.cat(rel).cpu().numpy(), torch.cat(sims).cpu().numpy()


def numbers(rows, scores, truth_rows, truth_scores, exact) -> dict:
    """The readings of ``m`` answers of ``k`` hits, ``rows`` and their
    ``scores`` as the system returned them, against the ``truth`` of the
    same queries and ``exact`` (``scores_of`` of the returned rows):

    * ``recall``: the mean share of the truth's ``k`` documents returned;
    * ``score_err``: the largest gap between a returned score and the
      exact relevance of its document;
    * ``order_gap``: the most by which a hit's exact relevance lies above
      that of the hit before it, over the places after the first ``DEPTH``;
    * ``mmr_gap``: the most by which an answer's pick at one of the first
      ``DEPTH`` places lies below MMR's best value among its hits there,
      given the picks before it (exact relevance, float64 cosines).
    """
    rel, sim = exact
    k = rows.shape[1]
    m = min(DEPTH, k)
    hits = [len(set(a.tolist()) & set(t.tolist())) for a, t in zip(rows, truth_rows[:, :k])]
    gap = 0.0
    for r, s in zip(rel, sim):
        penalty, taken = np.full(k, -np.inf), np.zeros(k, dtype=bool)
        for j in range(m):
            value = ALPHA * r - (1 - ALPHA) * np.where(np.isfinite(penalty), penalty, 0.0)
            gap = max(gap, float(np.max(value[~taken]) - value[j]))
            taken[j] = True
            penalty = np.maximum(penalty, s[j])
    return {
        "recall": float(np.mean(hits) / k),
        "score_err": float(np.max(np.abs(scores - rel))),
        "order_gap": float(max(0.0, np.max(rel[:, m + 1:] - rel[:, m:-1], initial=0.0))),
        "mmr_gap": gap,
    }
