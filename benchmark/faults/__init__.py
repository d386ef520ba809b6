"""Faults planted under a system's timed path, one module per ``system`` of
a configuration, named after it: ``<system>.py`` holds ``FAULTS``, a dict
from a fault's name to ``fn(system) -> None``, or to ``(fn, {check:
least})`` where the fault must also drive each named check's value above
``least``. ``fn`` is called with the system after its ingest (``run_cell``'s
``fault=``) and breaks its timed path underneath the entry point that the
loop calls. Every system gives ``stale``, ``half`` and ``altered``; a system
may add faults of its own.
"""
