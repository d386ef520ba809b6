"""Optional observability: per-collection operation counters and timings.

Every public collection operation records a count, error count, and latency
aggregates; ``Collection.stats()`` returns a snapshot. Recording costs two
clock reads and a lock; nothing is logged.

``trace(path)`` wraps ``torch.profiler`` for on-demand host and device traces
(Chrome-trace JSON, viewable in TensorBoard or Perfetto).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time


class OpStats:
    __slots__ = ("count", "errors", "total_s", "last_s", "max_s")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.total_s = 0.0
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

    def record(self, op: str, elapsed_s: float, *, error: bool = False):
        with self._lock:
            stats = self._ops.get(op)
            if stats is None:
                stats = self._ops[op] = OpStats()
            stats.count += 1
            if error:
                stats.errors += 1
            stats.total_s += elapsed_s
            stats.last_s = elapsed_s
            stats.max_s = max(stats.max_s, elapsed_s)

    def snapshot(self) -> dict:
        with self._lock:
            return {op: stats.snapshot() for op, stats in self._ops.items()}


def observed(op: str):
    """Decorator recording count/errors/latency for a collection method into
    ``self._stats``."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                result = fn(self, *args, **kwargs)
            except Exception:
                self._stats.record(op, time.perf_counter() - t0, error=True)
                raise
            self._stats.record(op, time.perf_counter() - t0)
            return result

        return wrapper

    return decorate


@contextlib.contextmanager
def trace(log_dir: str):
    """Captures a host and device trace into ``log_dir`` (one
    ``*.pt.trace.json`` file); CUDA activity is recorded when a CUDA device
    is present. Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sums time by kernel:

    >>> import tempfile
    >>> from vettore_tpu_torch.observability import trace
    >>> with trace(tempfile.mkdtemp()):
    ...     pass  # run searches here; the trace lands in the log dir
    """
    import torch
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
