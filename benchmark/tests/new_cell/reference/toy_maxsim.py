"""The toy hybrid system's plain reference: every document scored by
relevance (the primary row's cosine with the document's first token plus
the token set's MaxSim over cosines), the ``k`` best by (relevance desc, row
asc), the first ``DEPTH`` reordered by MMR, in float64 (the reference) or
with every unit operand cut to TF32 (the control, below the toy's float32).
Unit rows are worked out again here from the inputs as they were made.

``scores_of`` gives the float64 relevance of given (query, document) pairs
and the cosines of the first tokens of each answer's first ``DEPTH``
documents; ``numbers`` the readings that the checks hold.
"""

from __future__ import annotations

import numpy as np
import torch

#: as the configuration's ``guarantees`` state them
DEPTH, LAMBDA = 10, 0.5


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


def relevance(tokens: torch.Tensor, queries: torch.Tensor, precision: str) -> torch.Tensor:
    """``[b, n]`` relevance of every document to every query."""
    t, q = _cut(tokens, precision), _cut(queries, precision)
    return q[:, 0] @ t[:, 0].T + torch.einsum("bqd,ntd->bqnt", q[:, 1:], t).amax(-1).sum(1)


def mmr_order(rel: np.ndarray, sim: np.ndarray) -> list:
    """MMR's order of ``m`` hits of relevance ``rel [m]`` and cosines ``sim
    [m, m]`` of their first tokens; the earlier hit on a tie."""
    penalty, order = np.zeros_like(rel), []
    for _ in range(len(rel)):
        value = LAMBDA * rel - (1 - LAMBDA) * penalty
        value[order] = -np.inf
        j = int(np.argmax(value))
        order.append(j)
        penalty = np.maximum(penalty, sim[j])
    return order


def top_k(blocks, queries, k: int, *, precision: str = "f64", device=None):
    """``(rows [b, k] int64, relevances [b, k] float64)`` numpy arrays.
    ``blocks`` is ``[(first_row, [n, T, d] tokens)]``, ``queries`` ``[b, 1
    + Q, d]``."""
    tokens = _tokens(blocks, device)
    queries = torch.as_tensor(queries).to(tokens.device)
    rel = relevance(tokens, queries, precision).double().cpu().numpy()
    rows = np.lexsort((np.broadcast_to(np.arange(rel.shape[1]), rel.shape), -rel),
                      axis=-1)[:, :k]
    first = _cut(tokens[:, 0], precision)
    m = min(DEPTH, k)
    for b in range(rows.shape[0]):
        f = first[torch.from_numpy(rows[b, :m]).to(first.device)]
        order = mmr_order(rel[b, rows[b, :m]], (f @ f.T).double().cpu().numpy())
        rows[b, :m] = rows[b, :m][order]
    return rows, np.take_along_axis(rel, rows, 1)


def scores_of(blocks, queries, rows: np.ndarray):
    """``(relevance [b, k], cosines [b, m, m] of the first tokens of each
    answer's first m = DEPTH documents)``, in float64."""
    tokens = _tokens(blocks, None)
    t = _cut(tokens[torch.from_numpy(rows).to(tokens.device)], "f64")
    q = _cut(torch.as_tensor(queries).to(tokens.device), "f64")
    rel = (torch.einsum("bd,bkd->bk", q[:, 0], t[:, :, 0])
           + torch.einsum("bqd,bktd->bqkt", q[:, 1:], t).amax(-1).sum(1))
    first = t[:, :DEPTH, 0]
    return rel.cpu().numpy(), (first @ first.transpose(1, 2)).cpu().numpy()


def numbers(rows, scores, truth_rows, truth_scores, exact) -> dict:
    """The readings of ``m`` answers of ``k`` hits, ``rows`` and their
    ``scores`` as the system returned them, against the ``truth`` of the
    same queries and ``exact`` (``scores_of`` of the returned rows):

    * ``rank_gap``: the most by which the i-th best exact relevance of an
      answer's hits lies below the truth's i-th best;
    * ``score_err``: the largest gap between a returned score and the
      exact relevance of its document;
    * ``mmr_gap``: the most by which an answer's pick at one of the first
      ``DEPTH`` places lies below MMR's best value there, given the picks
      before it.
    """
    rel, sim = exact
    best = -np.sort(-truth_scores, axis=1)
    got = -np.sort(-rel, axis=1)
    m = sim.shape[1]
    gap = 0.0
    for r, s in zip(rel[:, :m], sim):
        penalty, taken = np.zeros(m), np.zeros(m, dtype=bool)
        for j in range(m):
            value = LAMBDA * r - (1 - LAMBDA) * penalty
            gap = max(gap, float(np.max(value[~taken]) - value[j]))
            taken[j] = True
            penalty = np.maximum(penalty, s[j])
    return {
        "rank_gap": float(np.max(best - got)),
        "score_err": float(np.max(np.abs(scores - rel))),
        "mmr_gap": gap,
    }
