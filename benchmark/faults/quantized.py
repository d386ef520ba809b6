"""Faults of ``systems/quantized.py``: each replaces its search call
(``System._search``, the collection's ``quantized_search_batch``)."""

from __future__ import annotations

import dataclasses


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    fn, first = system._search, []

    def frozen(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    system._search = frozen


def half(system):
    """Half of each batch is left out."""
    fn = system._search

    def halved(queries, **kwargs):
        return fn(queries, **kwargs)[:len(queries) // 2]
    system._search = halved


def altered(system):
    """The best hit of every answer names the next row, its score kept."""
    fn, width = system._search, len(system.ids[0])

    def bump(row):
        head = dataclasses.replace(row[0], id=f"{(int(row[0].id) + 1) % len(system.ids):0{width}d}")
        return [head, *row[1:]]

    def bumped(*args, **kwargs):
        return [bump(row) for row in fn(*args, **kwargs)]
    system._search = bumped


def exact(system):
    """The exact cosine top ``limit`` over every row (the flat index's
    search) in place of the Hamming candidates' rescore."""
    col = system.col

    def searched(queries, *, limit, **_kwargs):
        return col.search_batch(queries, limit=limit)
    system._search = searched


def no_rerank(system):
    """The rescore left no choice: the Hamming top ``limit`` alone, each
    with its cosine, in place of the best ``limit`` of the candidates."""
    fn = system._search

    def narrowed(queries, *, limit, **kwargs):
        return fn(queries, limit=limit, **{**kwargs, "candidates": limit})
    system._search = narrowed


FAULTS = {"stale": stale, "half": half, "altered": altered, "exact": exact,
          "no_rerank": no_rerank}
