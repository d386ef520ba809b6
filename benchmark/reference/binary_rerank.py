"""Binary-quantized retrieval with a float rescore, in plain torch: the
reference of the quantized deployment (``BASELINE.json`` config 3).

Each row's sign bits are ``x >= 0`` on its stored float32 values, and a
query's the same on its own. For each query, the Hamming distance to every
row is computed exactly, as an integer; the ``candidates`` rows of least
distance, by (Hamming asc, row asc), are rescored by their cosine to the
query, in float64 (the reference) or with both unit operands cut to TF32
and multiplied in float32 (the control, the precision below the
configuration's float32); the ``k`` best by (score desc, row asc) are the
answer. ``scores_of`` gives the float64 cosine of given (query, row) pairs,
and ``numbers`` the readings that the checks hold.
"""

from __future__ import annotations

import numpy as np
import torch

#: Hamming candidates a query, as the configuration states
CANDIDATES = 500

#: rows of one block of sign products, and queries of one rescore block
_ROWS, _QUERIES = 1 << 17, 64


def _unit(x: torch.Tensor, precision: str) -> torch.Tensor:
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


def _signs(x: torch.Tensor) -> torch.Tensor:
    """``+1`` where ``x >= 0``, else ``-1``, in float64: a product of two
    such rows is an integer of magnitude at most ``d``, exact in float64."""
    return torch.where(x >= 0, 1.0, -1.0).to(torch.float64)


def hamming_candidates(blocks, queries, candidates: int = CANDIDATES, *, device=None):
    """``[b, c]`` int64 rows of least Hamming distance to each query, in
    (Hamming asc, row asc) order, with their distances; ``c`` is
    ``candidates`` or the rows there are, if fewer."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    n = sum(x.shape[0] for _first, x in blocks)
    keys = []
    for first, x in blocks:
        dev = torch.device(device) if device is not None else x.device
        qs = _signs(q.to(dev))
        d = qs.shape[1]
        for lo in range(0, x.shape[0], _ROWS):
            chunk = x[lo:lo + _ROWS].to(dev)
            ham = ((d - qs @ _signs(chunk).T) / 2).round().long()
            rows = torch.arange(first + lo, first + lo + chunk.shape[0], device=dev)
            key = ham * n + rows[None, :]
            least = key.topk(min(candidates, key.shape[1]), dim=1, largest=False).values
            keys.append(least.cpu())
    key = torch.cat(keys, dim=1)
    key = key.topk(min(candidates, key.shape[1]), dim=1, largest=False, sorted=True).values
    return (key % n).numpy(), (key // n).numpy()


def gather(blocks, rows: np.ndarray, device=None) -> torch.Tensor:
    """The rows ``rows`` (global, ``[m]``) of ``blocks`` as one ``[m, d]``
    tensor on ``device`` (the CPU where it is None), in their own dtype."""
    out = None
    for first, x in blocks:
        mine = np.flatnonzero((rows >= first) & (rows < first + x.shape[0]))
        if not mine.size:
            continue
        got = x[torch.from_numpy(rows[mine] - first).to(x.device)]
        if out is None:
            out = torch.empty((rows.shape[0], x.shape[1]), dtype=x.dtype, device=device)
        out[torch.from_numpy(mine).to(out.device)] = got.to(out.device)
    return out


def _cosines(blocks, queries, rows: np.ndarray, precision: str, device=None) -> np.ndarray:
    """``[b, m]`` cosine of query ``i`` and row ``rows[i, j]``, a block of
    queries at a time on ``device`` (where the first block lies when it is
    None); TF32 products with TF32 off, so no coarser one."""
    q = torch.as_tensor(queries, dtype=torch.float32)
    device = device if device is not None else blocks[0][1].device
    out = np.empty(rows.shape, dtype=np.float64)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, rows.shape[0], _QUERIES):
            part = rows[lo:lo + _QUERIES]
            x = _unit(gather(blocks, part.reshape(-1), device), precision)
            x = x.reshape(part.shape[0], part.shape[1], -1)
            qq = _unit(q[lo:lo + _QUERIES].to(x.device), precision)
            out[lo:lo + _QUERIES] = torch.bmm(x, qq[:, :, None])[:, :, 0].double().cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return out


def top_k(blocks, queries, k: int, *, precision: str = "f64", device=None,
          candidates: int = CANDIDATES):
    """The ``k`` best of each query's Hamming candidates by (cosine desc,
    row asc).

    ``blocks`` is a list of ``(first_row, [n, d] float32 tensor)``: row
    ``i`` of a block is global row ``first_row + i``; each is read on
    ``device``, or where it lies when ``device`` is None. ``queries`` is
    ``[b, d]``. Returns ``(rows [b, k] int64, scores [b, k] float64)``
    numpy arrays."""
    cand, _ham = hamming_candidates(blocks, queries, candidates, device=device)
    scores = _cosines(blocks, queries, cand, precision, device)
    order = np.lexsort((cand, -scores), axis=-1)[:, :k]
    return np.take_along_axis(cand, order, 1), np.take_along_axis(scores, order, 1)


def scores_of(blocks, queries, rows: np.ndarray) -> np.ndarray:
    """float64 cosine of query ``b`` and row ``rows[b, i]``: ``[b, k]``."""
    return _cosines(blocks, queries, rows, "f64")


def numbers(rows, scores, truth_rows, truth_scores, exact_scores) -> dict:
    """The readings of ``m`` answers of ``k`` hits each, ``rows`` and their
    ``scores`` as the system returned them, against the reference's answers
    ``truth_rows`` of the same queries and the float64 cosines
    ``exact_scores`` of the returned rows:

    * ``match``: the mean share of the reference's ``k`` rows that came
      back;
    * ``score_err``: the largest gap between a returned score and the exact
      cosine of its row;
    * ``order_gap``: the most by which a hit's exact cosine lies above the
      one returned before it (0 when every answer is in order).
    """
    k = rows.shape[1]
    hits = [len(set(a.tolist()) & set(t.tolist())) for a, t in zip(rows, truth_rows[:, :k])]
    return {
        "match": float(np.mean(hits) / k),
        "score_err": float(np.max(np.abs(scores - exact_scores))),
        "order_gap": float(max(0.0, np.max(exact_scores[:, 1:] - exact_scores[:, :-1],
                                           initial=0.0))),
    }
