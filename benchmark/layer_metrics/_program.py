"""What the readers of the program's own spans and counters share: the sums
that ``vettore_tpu_torch.observability.snapshot()`` holds after the traced
window (the registry starts empty with each profiling session, and the
traced window is the run's only one), per call of the program's root span.

A program that keeps no such sums, or recorded no root span, gives None.
"""

from __future__ import annotations


def _snapshot():
    try:
        from vettore_tpu_torch import observability
    except ImportError:
        return None
    read = getattr(observability, "snapshot", None)
    return read() if callable(read) else None


def per_call(root: str, value):
    """``value(spans, counters)`` over the number of ``root`` spans in the
    traced window; None where there is no snapshot, no ``root`` span, or
    ``value`` gives None. ``spans`` maps a span's name to its ``count``,
    ``total_s`` and ``self_s``, ``counters`` a counter's name to its sum."""
    snap = _snapshot()
    if snap is None:
        return None
    calls = snap["spans"].get(root, {}).get("count", 0)
    if not calls:
        return None
    v = value(snap["spans"], snap["counters"])
    return None if v is None else v / calls


def seconds(spans, *names):
    """The summed seconds of spans ``names``; None if one was not recorded."""
    if any(n not in spans for n in names):
        return None
    return sum(spans[n]["total_s"] for n in names)


def ms_per_call(root: str, names, less=()):
    """ms per ``root`` call in spans ``names`` less the ms in spans
    ``less`` (which lie inside them)."""

    def value(spans, _counters):
        inside, out = seconds(spans, *names), seconds(spans, *less)
        return None if inside is None or out is None else 1e3 * (inside - out)

    return per_call(root, value)


def calls_of(root: str, name: str):
    """Spans ``name`` per ``root`` call."""
    return per_call(root, lambda spans, _c: spans[name]["count"] if name in spans else None)


def counter_per_call(root: str, name: str):
    """Counter ``name`` per ``root`` call."""
    return per_call(root, lambda _s, counters: counters.get(name))
