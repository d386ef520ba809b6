"""Faults of ``systems/collection.py``: each replaces the index's call under
the ``Collection`` (``search`` or ``search_batch``) on the instance that
``Collection.index`` returns."""

from __future__ import annotations


def _index_call(system):
    index = system.col.index
    return index, ("search" if system.single else "search_batch")


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    index, name = _index_call(system)
    fn, first = getattr(index, name), []

    def frozen(qs, limit):
        if not first:
            first.append(fn(qs, limit))
        return first[0]
    setattr(index, name, frozen)


def half(system):
    """Half of each batch is left out (a single query's answer is dropped)."""
    index, name = _index_call(system)
    fn = getattr(index, name)
    if name == "search":
        setattr(index, name, lambda q, limit: fn(q, limit)[:0])
    else:
        setattr(index, name, lambda qs, limit: fn(qs, limit)[:len(qs) // 2])


def altered(system):
    """The best hit of every answer names the next row, its score kept."""
    index, name = _index_call(system)
    fn, width = getattr(index, name), len(system.ids[0])

    def bump(hits):
        (hid, raw), rest = hits[0], hits[1:]
        return [(f"{(int(hid) + 1) % len(system.ids):0{width}d}", raw), *rest]
    if name == "search":
        setattr(index, name, lambda q, limit: bump(fn(q, limit)))
    else:
        setattr(index, name, lambda qs, limit: [bump(h) for h in fn(qs, limit)])


FAULTS = {"stale": stale, "half": half, "altered": altered}
