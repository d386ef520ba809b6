"""Exact cosine search in plain torch: the reference of every cell whose
guarantee is stated against exact search.

``top_k`` scores every row against every query, chunk by chunk, in float64
(the reference) or in single-pass TF32 (the control: the nearest precision
below the configuration's float32 with TF32 off), and keeps the ``k`` best
by (score descending, row ascending). ``scores_of`` gives the float64
cosine of given (query, row) pairs, and ``numbers`` the readings that a
cell's checks hold against their limits. Rows and queries are the inputs
as the benchmark made them; whatever the program derived from them (unit
rows, norms) is worked out again here.
"""

from __future__ import annotations

import numpy as np
import torch

#: candidates kept per query and chunk beyond ``k``, so that the final
#: (score, row) order is decided among enough near-ties
PAD = 4


def _unit(x: torch.Tensor, dtype) -> torch.Tensor:
    x = x.to(dtype)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) as a TF32 tensor-core product reads it from f32
    registers: the low 13 of the 23 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def products(rows: torch.Tensor, queries: torch.Tensor, precision: str) -> torch.Tensor:
    """``[n, b]`` cosine similarities of ``rows`` and ``queries`` (same
    device), in float64 or single-pass TF32. The TF32 product is made
    explicit, operands cut to TF32 and multiplied in f32 with TF32 off, so
    that every shape takes it: a library may run a product of one query as a
    matrix-vector kernel with no TF32 mode."""
    if precision == "f64":
        return _unit(rows, torch.float64) @ _unit(queries, torch.float64).T
    if precision != "tf32":
        raise ValueError(f"unknown precision {precision!r}")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return tf32(_unit(rows, torch.float32)) @ tf32(_unit(queries, torch.float32)).T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def top_k(blocks, queries, k: int, *, precision: str = "f64", device=None,
          chunk: int = 1 << 17):
    """The ``k`` best rows of each query by (score desc, row asc).

    ``blocks`` is a list of ``(first_row, [n, d] tensor)``: row ``i`` of a
    block is global row ``first_row + i``. Each chunk of rows is scored on
    ``device``, or where its block lies when ``device`` is None.
    ``queries`` is ``[b, d]``. Returns ``(rows [b, k] int64, scores [b, k]
    float64)`` numpy arrays."""
    queries = torch.as_tensor(queries, dtype=torch.float32)
    vals, rows = [], []
    for first, x in blocks:
        dev = torch.device(device) if device is not None else x.device
        q = queries.to(dev)
        for lo in range(0, x.shape[0], chunk):
            s = products(x[lo:lo + chunk].to(dev), q, precision)
            v, i = s.topk(min(k + PAD, s.shape[0]), dim=0)
            vals.append(v.T.double().cpu())
            rows.append((i.T + (first + lo)).cpu())
            del s
    vals, rows = torch.cat(vals, 1).numpy(), torch.cat(rows, 1).numpy()
    order = np.lexsort((rows, -vals), axis=-1)[:, :k]
    return np.take_along_axis(rows, order, 1), np.take_along_axis(vals, order, 1)


def gather(blocks, rows: np.ndarray) -> torch.Tensor:
    """The rows ``rows`` (global, ``[m]``) of ``blocks`` as one ``[m, d]``
    float64 CPU tensor."""
    out = None
    for first, x in blocks:
        mine = np.flatnonzero((rows >= first) & (rows < first + x.shape[0]))
        if not mine.size:
            continue
        got = x[torch.from_numpy(rows[mine] - first).to(x.device)].double().cpu()
        if out is None:
            out = torch.empty((rows.shape[0], x.shape[1]), dtype=torch.float64)
        out[torch.from_numpy(mine)] = got
    return out


def scores_of(blocks, queries, rows: np.ndarray) -> np.ndarray:
    """float64 cosine of query ``b`` and row ``rows[b, i]``: ``[b, k]``."""
    b, k = rows.shape
    x = _unit(gather(blocks, rows.reshape(-1)), torch.float64).reshape(b, k, -1)
    q = _unit(torch.as_tensor(queries), torch.float64)
    return torch.einsum("bkd,bd->bk", x, q).numpy()


def numbers(rows, scores, truth_rows, truth_scores, exact_scores) -> dict:
    """The readings of ``m`` answers of ``k`` hits each, ``rows`` and their
    ``scores`` as the system returned them, against the ``truth`` of the
    same queries and the float64 scores ``exact_scores`` of the returned
    rows:

    * ``rank_gap``: the most by which a returned hit's exact score lies
      below the exact score of the hit that belongs at its place;
    * ``score_err``: the largest gap between a returned score and the exact
      score of its row;
    * ``recall``: the mean share of the true ``k`` that came back;
    * ``order_gap``: the most by which a hit's exact score lies above the
      one returned before it (0 when every answer is in order).
    """
    k = rows.shape[1]
    hits = [len(set(a.tolist()) & set(t.tolist())) for a, t in zip(rows, truth_rows[:, :k])]
    return {
        "rank_gap": float(np.max(truth_scores[:, :k] - exact_scores)),
        "score_err": float(np.max(np.abs(scores - exact_scores))),
        "recall": float(np.mean(hits) / k),
        "order_gap": float(max(0.0, np.max(exact_scores[:, 1:] - exact_scores[:, :-1],
                                           initial=0.0))),
    }
