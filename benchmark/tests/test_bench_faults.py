"""The comparison that decides ``correct`` fails what it has to fail.

The control (the reference in the program's place, in single-pass TF32)
and a run whose timed path is broken underneath each come out not correct,
at a tiny size on the CPU; the same runs unbroken come out correct."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import CELLS, run_tiny

COLLECTION = [c for c in CELLS if not c.startswith("laion")]
MESH = [c for c in CELLS if c.startswith("laion")]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    res = run_tiny(name, control=True)
    assert res["failed"] == 0 and res["info"]["judged"] > 0
    assert not res["correct"], res["checks"]
    assert res["checks"]["score_err"]["value"] > 1e-6


def _index_call(system):
    index = system.col.index
    return index, ("search" if system.single else "search_batch")


def stale(system):
    """Every call answers as the first one did: the state never moves."""
    if hasattr(system, "col"):
        index, name = _index_call(system)
        fn, first = getattr(index, name), []

        def frozen(qs, limit):
            if not first:
                first.append(fn(qs, limit))
            return first[0]
        setattr(index, name, frozen)
    else:
        fn, first = system._search, []

        def frozen(*a, **kw):
            if not first:
                first.append(fn(*a, **kw))
            return first[0]
        system._search = frozen


def half(system):
    """Half of each batch is left out (a single query's answer is dropped)."""
    if hasattr(system, "col"):
        index, name = _index_call(system)
        fn = getattr(index, name)
        if name == "search":
            setattr(index, name, lambda q, limit: fn(q, limit)[:0])
        else:
            setattr(index, name, lambda qs, limit: fn(qs, limit)[:len(qs) // 2])
    else:
        fn = system._search

        def halved(mesh, x, v, lex, qs, **kw):
            slots, raws = fn(mesh, x, v, lex, qs, **kw)
            return slots[:len(qs) // 2], raws[:len(qs) // 2]
        system._search = halved


def altered(system):
    """The best hit of every answer names the next row, its score kept."""
    if hasattr(system, "col"):
        index, name = _index_call(system)
        fn, width = getattr(index, name), len(system.ids[0])

        def bump(hits):
            (hid, raw), rest = hits[0], hits[1:]
            return [(f"{(int(hid) + 1) % len(system.ids):0{width}d}", raw), *rest]
        if name == "search":
            setattr(index, name, lambda q, limit: bump(fn(q, limit)))
        else:
            setattr(index, name, lambda qs, limit: [bump(h) for h in fn(qs, limit)])
    else:
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


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_is_correct(name):
    assert run_tiny(name)["correct"]


@pytest.mark.parametrize("fault", [stale, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(name, fault):
    res = run_tiny(name, fault=fault)
    assert not res["correct"], (fault.__name__, res["checks"])


@pytest.mark.parametrize("name", MESH)
def test_no_exchange_fails(name):
    res = run_tiny(name, fault=no_exchange)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rank_gap"]["value"] > 1e-3
