"""Faults of ``systems/colbert_hybrid.py``: ``stale``, ``half``,
``altered`` and ``no_hnsw`` replace its hybrid call (``System._hybrid``,
the collection's ``hybrid_search_batch``); ``no_mmr`` replaces its MMR
call (``System._mmr``)."""

from __future__ import annotations

import dataclasses


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    fn, first = system._hybrid, []

    def frozen(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    system._hybrid = frozen


def half(system):
    """Half of each batch is left out."""
    fn = system._hybrid

    def halved(queries, **kwargs):
        return fn(queries, **kwargs)[:len(queries) // 2]
    system._hybrid = halved


def altered(system):
    """The best hit of every answer names the next document, its score
    kept."""
    fn, width = system._hybrid, len(system.ids[0])

    def bump(row):
        head = dataclasses.replace(row[0], id=f"{(int(row[0].id) + 1) % len(system.ids):0{width}d}")
        return [head, *row[1:]]

    def bumped(*args, **kwargs):
        return [bump(row) for row in fn(*args, **kwargs)]
    system._hybrid = bumped


def no_hnsw(system):
    """The HNSW generator left out: the union is the quantized candidates
    alone."""
    fn = system._hybrid

    def quantized_only(queries, *, generators, **kwargs):
        return fn(queries, generators=[g for g in generators if g[0] != "hnsw"], **kwargs)
    system._hybrid = quantized_only


def no_mmr(system):
    """MMR left out: the first ``final_k`` hits stay in relevance order."""

    def first(initial_lists, _vecs, *, final_k, **_kwargs):
        return [initial[:final_k] for initial in initial_lists]
    system._mmr = first


FAULTS = {"stale": stale, "half": half, "altered": altered, "no_hnsw": no_hnsw,
          "no_mmr": (no_mmr, {"mmr_gap": 1e-3})}
