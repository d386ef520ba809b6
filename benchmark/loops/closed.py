"""One client in a closed loop: the traffic's calls over the query pool,
in order, each sent when the last has returned.

Traffic keys: ``batch`` (queries a call) and ``limit`` (hits a query).
"""

from __future__ import annotations

import time
import traceback

import numpy as np


class Loop:
    def __init__(self, sut, pool: np.ndarray, traffic: dict, log):
        self.sut = sut
        self.batch = int(traffic["batch"])
        self.limit = int(traffic["limit"])
        n = pool.shape[0] // self.batch
        self.slices = [(i * self.batch, pool[i * self.batch:(i + 1) * self.batch])
                       for i in range(n)]
        self.next = 0
        self.log = log
        self.errors = 0

    def run(self, seconds: float, reservoir=None, min_calls: int = 1):
        lat = []
        answered = failed = calls = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            first, qs = self.slices[self.next]
            self.next = (self.next + 1) % len(self.slices)
            c0 = time.perf_counter()
            try:
                out = self.sut.call(qs)
            except Exception:  # a failed call is counted and reported, the run goes on
                out = None
                self.errors += 1
                if self.errors <= 3:
                    self.log("call failed:\n" + traceback.format_exc())
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            calls += 1
            if out is None:
                failed += len(qs)
            else:
                bad = self.sut.count_bad(out, len(qs), self.limit)
                failed += bad
                answered += len(qs) - bad
                if reservoir is not None:
                    reservoir.offer(first, out)
            if c1 >= end and calls >= min_calls:
                return c1 - t0, calls, answered, failed, np.array(lat)
