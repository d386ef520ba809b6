"""Faults of the toy hybrid system: each wraps its ``_search``, the scoring
and selection under the MMR reorder."""

from __future__ import annotations


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    fn, first = system._search, []

    def frozen(qs):
        if not first:
            first.append(fn(qs))
        return first[0]
    system._search = frozen


def half(system):
    """Half of each batch is left out."""
    fn = system._search

    def halved(qs):
        rows, rel = fn(qs)
        return rows[:len(qs) // 2], rel[:len(qs) // 2]
    system._search = halved


def altered(system):
    """The best hit of every answer names the next document, its relevance
    kept."""
    fn = system._search

    def bumped(qs):
        rows, rel = fn(qs)
        rows = rows.clone()
        rows[:, 0] = (rows[:, 0] + 1) % system.tokens.shape[0]
        return rows, rel
    system._search = bumped


FAULTS = {"stale": stale, "half": half, "altered": altered}
