"""Faults of ``systems/sharded_search.py``: each wraps the system's
``_search`` (``sharded_search``'s signature ``(mesh, x, v, lex, qs)``, its
``(slots, raws)`` tensors) or the mesh's gather between the devices."""

from __future__ import annotations


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    fn, first = system._search, []

    def frozen(*a, **kw):
        if not first:
            first.append(fn(*a, **kw))
        return first[0]
    system._search = frozen


def half(system):
    """Half of each batch is left out."""
    fn = system._search

    def halved(mesh, x, v, lex, qs, **kw):
        slots, raws = fn(mesh, x, v, lex, qs, **kw)
        return slots[:len(qs) // 2], raws[:len(qs) // 2]
    system._search = halved


def altered(system):
    """The best hit of every answer names the next row, its score kept."""
    fn = system._search

    def bumped(*a, **kw):
        slots, raws = fn(*a, **kw)
        slots = slots.clone()
        slots[:, 0] = (slots[:, 0] + 1) % (system.per * len(system.xs))
        return slots, raws
    system._search = bumped


def no_exchange(system):
    """The merge sees its own shard's candidates only: the gather between
    the devices is left out."""
    gather = system.mesh.gather
    system.mesh.gather = lambda per_shard, device: gather(per_shard[:1], device)


FAULTS = {"stale": stale, "half": half, "altered": altered,
          # the merge then misses hits by more than a rounding's worth
          "no_exchange": (no_exchange, {"rank_gap": 1e-3})}
