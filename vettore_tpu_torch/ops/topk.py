"""Deterministic top-k selection with (rank, id) tie-breaking.

The reference keeps a bounded max-heap ordered by ``(rank, external_id)``
(flat.rs:34-40, search.rs:23-29) so equal-rank hits always come back in
lexicographic id order, independent of insertion order. Here the same
guarantee comes without a heap:

* the host maintains ``lex_order`` — a permutation of slots sorted by external
  id (invalid/padded slots at the end);
* ranks are gathered into lex order and sorted with a STABLE sort, so ties
  resolve to the lowest lex position, i.e. the lexicographically smallest id.
  ``torch.topk`` promises no order among ties, so it is not used here.

``topk_exact`` (full multi-key sort) is the differential oracle used in tests.
"""

from __future__ import annotations

import torch


def bucket_limit(limit: int, n: int) -> int:
    """Rounds ``limit`` up to a power-of-two bucket (capped at ``n``), so a
    batch of searches with nearby limits shares one selection width.

    >>> bucket_limit(10, 1000)
    16
    >>> bucket_limit(10, 12)
    12
    """
    if limit >= n:
        return n
    b = 1
    while b < limit:
        b <<= 1
    return min(b, n)


def smallest(values: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of ``values`` [B, M], ascending,
    ties to the lowest index (the order XLA's ``top_k`` gives). Returns
    ``(vals [B, k], idx [B, k] int64)``."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def lex_sort(rank: torch.Tensor, lex: torch.Tensor):
    """Permutation ordering each row by ``(rank, lex)``: a stable sort by the
    secondary key, then a stable sort by the primary key."""
    o1 = torch.sort(lex, dim=-1, stable=True).indices
    o2 = torch.sort(rank.gather(-1, o1), dim=-1, stable=True).indices
    return o1.gather(-1, o2)


def topk_slots(rank: torch.Tensor, lex_order: torch.Tensor, *, limit: int):
    """Selects the ``limit`` slots with smallest rank, ties by id order.

    ``rank``: [..., N] float32 ascending-is-better; invalid slots must be
    +inf. ``lex_order``: [N] int permutation, slots sorted by external id
    with invalid slots last. Returns (slots [..., limit] int64,
    ranks [..., limit] f32), best first; surplus positions carry rank +inf.
    """
    lex_order = lex_order.long()
    vals, pos = smallest(rank[..., lex_order], limit)
    return lex_order[pos], vals


def topk_exact(rank: torch.Tensor, lex_rank: torch.Tensor, *, limit: int):
    """Oracle: full multi-key sort by (rank, lex_rank); returns slots [limit]."""
    order = lex_sort(rank, lex_rank)
    return order[:limit], rank[order][:limit]
