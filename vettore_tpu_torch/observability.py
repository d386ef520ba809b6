"""Observability: per-collection operation counters, and spans and counters
inside the search path while a profiler records.

Every public collection operation records a count, error count, and latency
aggregates; ``Collection.stats()`` returns a snapshot. Recording costs two
clock reads and a lock; nothing is logged.

Tracing
-------
The spans and counters named in ``SPANS`` and ``COUNTERS`` exist only while a
``torch.profiler`` session records: ``trace(dir)`` opens one, and so does any
``torch.profiler.profile`` of the caller's. There is no other switch. While
none records, a span or counter site costs one test of the profiler's flag.
(What ``hnsw.nodes`` reads is the one exception: the HNSW beam adds each
query's fresh neighbours to a count on the device at every step, traced or
not, since a captured step cannot test the flag; the counter reads the sum.)
While one records, each span

* adds its count, total seconds and self seconds (its duration less the
  time its child spans cover, on ``time.perf_counter``) to a process-wide
  registry, which starts empty with each profiling session;
* is a CPU range of the profiler's own trace, so that ``trace(dir)``'s
  Chrome trace shows it on the device timeline's clock: an idle gap of the
  card lies under the span in which the host was busy. It is not a user
  annotation, so the profiler mirrors no copy of it onto the device
  timeline.

``snapshot()`` returns the registry's sums: ``{"spans": {name: {"count",
"total_s", "self_s"}}, "counters": {name: n}}``.

>>> import torch
>>> from vettore_tpu_torch import observability as obs
>>> with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
...     with obs.span("index.wait"):
...         pass
>>> obs.snapshot()["spans"]["index.wait"]["count"]
1
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: the public ``Collection`` operations that ``@observed`` records; each is
#: the root span ``collection.<op>``
COLLECTION_OPS = (
    "sync", "put_many", "put_matrix", "put_tokens", "delete",
    "search", "search_batch", "funnel_search", "funnel_search_batch",
    "quantized_search", "quantized_search_batch", "multi_vector_search",
    "multi_vector_search_batch", "hybrid_search", "hybrid_search_batch",
)

#: every span name, with what it covers
SPANS = tuple(f"collection.{op}" for op in COLLECTION_OPS) + (
    "collection.validate",   # a search's query checks and float64 conversion
    "collection.normalize",  # its float64 normalisation
    "collection.hydrate",    # its store lookups and Result objects, once a call
    "collection.validate_tokens",  # the query token sets' checks, normalisation and padding
    "index.search",          # FlatIndex.search, HnswIndex.search
    "index.search_batch",    # FlatIndex.search_batch, HnswIndex.search_batch
    "index.validate",        # the index's own query checks
    "index.wait",            # one host read of a device tensor on the index path
    "index.assemble",        # building the (id, raw) hit lists
    "mesh.search",           # sharded_search, ShardedFlat.search_device
    "mesh.launch",           # one shard's search call, enqueued by the host
    "mesh.wait",             # one read of a fused shard search's ok flag
    "hybrid.hnsw",           # hybrid_search_batch's hnsw generator (the beam, its slot table)
    "hybrid.quantized",      # its quantized generator (the sign scan and group rows)
    "hybrid.funnel",         # its funnel generator
    "hybrid.search",         # its search generator (the index's own device search)
    "hybrid.union",          # the generators' candidate union on the device
    "hybrid.rerank",         # the exact or MaxSim rerank and its reads to the host
    "hybrid.wait",           # one host read of a rerank output or of the generators' ok flags
    "mmr.rerank",            # ops.mmr.mmr_rerank_batch, its read to the host included
    "adaptive.candidates",   # a funnel or quantized pipeline's candidate stage (K5 / K6, K7)
    "adaptive.rerank",       # its exact rerank of the candidates (ops.pipeline.rerank_batch)
    "adaptive.wait",         # one host read of a funnel or quantized pipeline's output
)

#: every counter name, with what it counts
COUNTERS = (
    "hnsw.steps",     # layer-0 beam steps run
    "hnsw.nodes",     # fresh neighbours the beam scored
    "hnsw.replays",   # captured blocks of beam steps replayed (CUDA graphs)
    "hnsw.captures",  # blocks of beam steps captured as CUDA graphs
    "hybrid.candidates",  # live candidates after a hybrid batch's union, summed over its queries
    "hybrid.reruns",      # hybrid batch queries re-run alone (their share of host_routes)
    "mesh.norms",     # sharded_search's squared-norm passes over a shard (its memo's misses)
    "collection.token_fallbacks",  # query token checks that took the per-token loop
    "adaptive.fallbacks",  # funnel or quantized queries whose device answer was flagged
)


def tracing() -> bool:
    """Whether a profiler records, and with it the spans and counters."""
    return _profiler._is_profiler_enabled


class OpStats:
    __slots__ = ("count", "errors", "total_s", "self_s", "last_s", "max_s")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.total_s = 0.0
        self.self_s = 0.0
        self.last_s = 0.0
        self.max_s = 0.0

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "errors": self.errors,
            "total_s": round(self.total_s, 6),
            "mean_ms": round(1e3 * self.total_s / self.count, 3) if self.count else 0.0,
            "last_ms": round(1e3 * self.last_s, 3),
            "max_ms": round(1e3 * self.max_s, 3),
        }


class StatsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._ops: dict[str, OpStats] = {}

    def record(self, op: str, elapsed_s: float, *, error: bool = False,
               self_s: float | None = None):
        with self._lock:
            stats = self._ops.get(op)
            if stats is None:
                stats = self._ops[op] = OpStats()
            stats.count += 1
            if error:
                stats.errors += 1
            stats.total_s += elapsed_s
            stats.self_s += elapsed_s if self_s is None else self_s
            stats.last_s = elapsed_s
            stats.max_s = max(stats.max_s, elapsed_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {op: stats.snapshot() for op, stats in self._ops.items()}

    def sums(self) -> dict:
        """``{op: {"count", "total_s", "self_s"}}``, unrounded."""
        with self._lock:
            return {op: {"count": s.count, "total_s": s.total_s, "self_s": s.self_s}
                    for op, s in self._ops.items()}

    def clear(self) -> None:
        with self._lock:
            self._ops.clear()


# ---------------------------------------------------------------------------
# spans and counters (while a profiler records)
# ---------------------------------------------------------------------------

_SPANS = StatsRegistry()
_lock = threading.Lock()
_counts: dict[str, int] = {}
#: device sums of counters, by (name, device), read by ``snapshot``
_pending: dict = {}
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span while a profiler records: its clock pair, its profiler range
    and its place on the thread's stack of open spans."""

    __slots__ = ("name", "t0", "inner", "record")

    def __init__(self, name: str):
        self.name = name

    def open(self) -> float:
        self.inner = 0.0
        self.record = _RecordFunctionFast(self.name)
        self.record.__enter__()
        _stack().append(self)
        self.t0 = time.perf_counter()
        return self.t0

    def close(self, t1: float) -> None:
        self.record.__exit__(None, None, None)
        stack = _stack()
        stack.pop()
        total = t1 - self.t0
        if stack:
            stack[-1].inner += total
        _SPANS.record(self.name, total, self_s=total - self.inner)

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close(time.perf_counter())
        return False

    def __call__(self, fn):
        return _SITES[self.name](fn)


class _Site:
    """A declared span name while no profiler records: a context manager
    that does nothing, and a decorator whose wrapper opens the span when
    one does."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)

        return wrapper


_SITES = {name: _Site(name) for name in SPANS}


def span(name: str):
    """The span ``name`` (one of ``SPANS``): ``with span(name):`` or
    ``@span(name)``. While no profiler records it is a shared object that
    does nothing."""
    site = _SITES[name]
    return _Span(name) if _profiler._is_profiler_enabled else site


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name`` (one of ``COUNTERS``) while a
    profiler records. ``n`` may be a device tensor: it is summed on its
    device, and read on the host by ``snapshot``, not here."""
    if not _profiler._is_profiler_enabled:
        return
    if name not in COUNTERS:
        raise KeyError(name)
    with _lock:
        if isinstance(n, torch.Tensor):
            key = (name, n.device)
            _pending[key] = _pending.get(key, 0) + n.detach()  # a new tensor, never the caller's
        else:
            _counts[name] = _counts.get(name, 0) + int(n)


def reset() -> None:
    """Empties the registry of spans and counters."""
    _SPANS.clear()
    with _lock:
        _counts.clear()
        _pending.clear()


def snapshot() -> dict:
    """The spans' and counters' sums since the last profiling session began:
    ``{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name:
    n}}``. Reads the counters kept on a device (a wait for it)."""
    with _lock:
        pending = list(_pending.items())
        _pending.clear()
    folded = [(name, int(t.item())) for (name, _dev), t in pending]
    with _lock:
        for name, n in folded:
            _counts[name] = _counts.get(name, 0) + n
        counters = dict(_counts)
    return {"spans": _SPANS.sums(), "counters": counters}


def _reset_on_profiler_start(start=_profiler._run_on_profiler_start):
    start()
    reset()


# A profiling session begins where torch sets the flag the sites test; torch
# offers no callback there, so the registry's reset wraps the function that
# sets it (once, should this module be imported again).
if not getattr(_profiler._run_on_profiler_start, "_resets_observability", False):
    _reset_on_profiler_start._resets_observability = True
    _profiler._run_on_profiler_start = _reset_on_profiler_start


def observed(op: str):
    """Decorator recording count/errors/latency for a collection method into
    ``self._stats``; while a profiler records, the same clock pair is the
    root span ``collection.<op>``."""
    root = f"collection.{op}"
    if root not in _SITES:
        raise KeyError(f"{op!r} is not in COLLECTION_OPS")

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            sp = _Span(root) if _profiler._is_profiler_enabled else None
            t0 = time.perf_counter() if sp is None else sp.open()
            try:
                result = fn(self, *args, **kwargs)
            except Exception:
                t1 = time.perf_counter()
                if sp is not None:
                    sp.close(t1)
                self._stats.record(op, t1 - t0, error=True)
                raise
            t1 = time.perf_counter()
            if sp is not None:
                sp.close(t1)
            self._stats.record(op, t1 - t0)
            return result

        return wrapper

    return decorate


@contextlib.contextmanager
def trace(log_dir: str):
    """Captures a host and device trace into ``log_dir`` (one
    ``*.pt.trace.json`` file); CUDA activity is recorded when a CUDA device
    is present, and the spans of ``SPANS`` lie on its timeline. Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sums time by
    kernel; ``snapshot()`` sums the spans and counters of the session:

    >>> import tempfile
    >>> from vettore_tpu_torch.observability import trace
    >>> with trace(tempfile.mkdtemp()):
    ...     pass  # run searches here; the trace lands in the log dir
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
