"""``vettore_tpu_torch.parallel.sharded_search`` over a row-sharded block,
one shard a device of ``make_mesh(devices)``: each call searches a host
query batch and copies its slots and raws to the host.

The block is made on the devices from the seed, ``chunk_rows`` rows at a
time. Its rows and the queries are unit in float32, as a collection hands
them to its index: the search's cosine is the dot product of unit
vectors. Global row ``s * rows_per_card + i`` is row ``i`` of shard ``s``;
the lex rank of a row is its global row, so ties go to the lower row.

Spans: ``sharded_search`` around the search, ``host_copy`` around the
copy of its outputs to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.data import synth


class Answers:
    """One call's answers: row ``j`` is ``(slots [k], raws [k])``."""

    def __init__(self, slots: np.ndarray, raws: np.ndarray):
        self.slots, self.raws = slots, raws

    def __len__(self):
        return self.slots.shape[0]

    def __getitem__(self, j):
        return self.slots[j], self.raws[j]


class System:
    def __init__(self, config, traffic, devices, spans, log):
        self.config = config
        self.traffic = traffic
        self.devices = list(devices)
        self.spans = spans
        self.log = log
        self.limit = int(traffic["limit"])
        if traffic["call"] != "batch":
            raise ValueError("sharded_search takes query batches only")

    def prepare(self, seed: int) -> None:
        from vettore_tpu_torch.parallel import make_mesh, sharded_search

        c = self.config
        cards, d = int(c["cards"]), int(c["dims"])
        if len(self.devices) != cards:
            raise ValueError(f"{cards} devices wanted, {len(self.devices)} given")
        per = int(c["rows"]) // cards
        chunk = int(c["chunk_rows"])
        t0 = time.perf_counter()
        self.mesh = make_mesh(self.devices)
        xs = []
        for s, dev in enumerate(self.devices):
            x = torch.empty((per, d), dtype=torch.float32, device=dev)
            for i, lo in enumerate(range(0, per, chunk)):
                part = x[lo:min(per, lo + chunk)]
                synth.clustered(part.shape[0], d, c["cluster_rows"], c["radius"],
                                synth.subseed(seed, 1, s, i), dev, out=part)
                part.div_(torch.linalg.vector_norm(part, dim=1, keepdim=True))
            xs.append(x)
        first = self.devices[0]
        pool = int(self.traffic["pool"])
        picks = synth.picks(per * cards, pool, synth.subseed(seed, 2), first)
        base = torch.empty((pool, d), dtype=torch.float32, device=first)
        for s, x in enumerate(xs):
            mine = torch.nonzero(picks // per == s).flatten()
            base[mine] = x[(picks[mine] % per).to(x.device)].to(first)
        q = synth.perturbed(base, float(self.traffic["noise"]), synth.subseed(seed, 3))
        self.queries = q.div_(torch.linalg.vector_norm(q, dim=1, keepdim=True)).cpu().numpy()
        del base, picks
        self.xs, self.per = xs, per
        self.bx = self.mesh.place(xs)
        self.bv = self.mesh.place([torch.ones(per, dtype=torch.bool, device=x.device)
                                   for x in xs])
        self.bl = self.mesh.place([torch.arange(s * per, (s + 1) * per, dtype=torch.int32,
                                                device=x.device) for s, x in enumerate(xs)])
        self._search = self.spans.wrap("sharded_search", sharded_search)
        self._copy = self.spans.wrap("host_copy", lambda t: t.cpu().numpy())
        self.log(f"block {cards} x {per} x {d} and {pool} queries made on the devices in "
                 f"{time.perf_counter() - t0:.1f}s")

    def ingest(self):
        """The block is the input, made in place: no ingest to time."""
        return None

    def call(self, qs: np.ndarray) -> Answers:
        slots, raws = self._search(self.mesh, self.bx, self.bv, self.bl, qs,
                                   metric=self.config["metric"], k=self.limit)
        return Answers(self._copy(slots), self._copy(raws))

    @staticmethod
    def count_bad(out, b: int, limit: int) -> int:
        if out.slots.shape != (b, limit):
            return b
        return int((out.slots < 0).any(axis=1).sum())

    @staticmethod
    def answer_rows(answer):
        slots, raws = answer
        return slots.astype(np.int64), raws.astype(np.float64)

    def reference_blocks(self):
        return [(s * self.per, x) for s, x in enumerate(self.xs)], None

    def counters(self) -> dict:
        return {"reruns": int(self.mesh.reruns), "gathered_bytes": int(self.mesh.gathered_bytes)}

    def shape(self) -> dict:
        c = self.config
        return {"batch": int(self.traffic["batch"]),
                "dims": int(c["dims"]), "k": self.limit, "cards": int(c["cards"]),
                "rows_per_card": self.per, "elem_bytes": 4}

    def close(self) -> None:
        """The blocks are the inputs, and the reference reads them; the
        search keeps no state between calls."""
        self._search = self._copy = None
