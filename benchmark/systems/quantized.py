"""A binary-quantized deployment of ``vettore_tpu_torch.Collection`` on one
device: the corpus ingested by ``put_matrix`` into a flat collection, each
call a batch of queries through ``quantized_search_batch`` (a sign-bit
Hamming pass keeps the configuration's ``candidates`` a query, an exact
rescore keeps ``limit``), the answers hydrated ``Result`` lists.

Spans: ``collection.quantized_search_batch`` around the collection's call.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.data import synth

#: rows of the throwaway collection whose first quantized search loads the
#: kernels: enough for the group cover (K6, K7), which starts at 65,536
_WARM_ROWS = 65536


class System:
    def __init__(self, config, traffic, devices, spans, log):
        self.config = config
        self.traffic = traffic
        self.device = devices[0]
        self.spans = spans
        self.log = log
        self.limit = int(traffic["limit"])
        self.candidates = int(config["candidates"])
        self.col = None

    # -- set-up -------------------------------------------------------------

    def prepare(self, seed: int) -> None:
        """Loads the program and its kernels, makes the corpus and the query
        pool on the device from ``seed``, and keeps both on the host, where
        a caller of ``put_matrix`` and ``quantized_search_batch`` holds
        them."""
        import vettore_tpu_torch as vt

        self.vt = vt
        c = self.config
        n, d = int(c["rows"]), int(c["dims"])
        t0 = time.perf_counter()
        warm_rows = min(_WARM_ROWS, n)
        warm = vt.Collection(name="warm", dimensions=d, metric=c["metric"], index="flat",
                             device=self.device)
        rows = synth.clustered(warm_rows, d, c["cluster_rows"], c["radius"], 1, self.device)
        warm.put_matrix([str(i) for i in range(warm_rows)], rows.cpu().numpy())
        warm.quantized_search_batch(rows[:2].cpu().numpy(), limit=self.limit,
                                    candidates=self.candidates)
        warm.close()
        del warm, rows
        t1 = time.perf_counter()
        corpus = torch.empty((n, d), dtype=torch.float32, device=self.device)
        chunk = int(c["chunk_rows"])
        for i, lo in enumerate(range(0, n, chunk)):
            hi = min(n, lo + chunk)
            synth.clustered(hi - lo, d, c["cluster_rows"], c["radius"],
                            synth.subseed(seed, 1, i), self.device, out=corpus[lo:hi])
        pool = int(self.traffic["pool"])
        base = corpus[synth.picks(n, pool, synth.subseed(seed, 2), self.device)]
        self.queries = synth.perturbed(base, float(self.traffic["noise"]),
                                       synth.subseed(seed, 3)).cpu().numpy()
        self.corpus = corpus.cpu().numpy()
        del corpus, base
        width = len(str(n - 1))
        self.ids = [f"{i:0{width}d}" for i in range(n)]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.log(f"kernels and warm collection {t1 - t0:.1f}s; corpus {n} x {d} and "
                 f"{pool} queries {time.perf_counter() - t1:.1f}s")

    def ingest(self) -> float:
        """Seconds from ``put_matrix`` of the corpus into a new collection
        until its first quantized answer (one batch of the traffic through
        ``quantized_search_batch_device`` and ``results_from_device``: the
        scan cache and its sign block included) has returned, synchronised.
        Raises at once if a query of that batch has no answer on the device,
        which the program would then give by its host oracle alone."""
        c = self.config
        col = self.vt.Collection(name=c["name"], dimensions=int(c["dims"]), metric=c["metric"],
                                 index=c["index"], index_options=c.get("index_options") or None,
                                 device=self.device)
        first = self.queries[:int(self.traffic["batch"])]
        t0 = time.perf_counter()
        col.put_matrix(self.ids, self.corpus)
        prepared = np.stack([col.prepare_query(q) for q in first]).astype(np.float32)
        out = col.results_from_device(col.quantized_search_batch_device(
            torch.from_numpy(prepared).to(self.device), limit=self.limit,
            candidates=self.candidates))
        col.sync()
        ingest_s = time.perf_counter() - t0
        self.col = col
        missing = sum(hits is None for hits in out)
        if missing:
            raise RuntimeError(
                f"{missing} of {len(out)} queries have no answer on the device: the program "
                f"answers {c['rows']} x {c['dims']} quantized search only through its host "
                f"oracle")
        self._search = self.spans.wrap("collection.quantized_search_batch",
                                       col.quantized_search_batch)
        self.log(f"ingest {ingest_s:.2f}s")
        return ingest_s

    # -- the timed path -----------------------------------------------------

    def call(self, qs: np.ndarray) -> list:
        return self._search(qs, limit=self.limit, candidates=self.candidates)

    @staticmethod
    def count_bad(out, b: int, limit: int) -> int:
        return sum(len(a) != limit for a in out) + max(0, b - len(out))

    # -- after the window ---------------------------------------------------

    @staticmethod
    def answer_rows(answer):
        """Rows (ids are zero-padded row numbers) and scores of one answer."""
        return (np.array([int(r.id) for r in answer], dtype=np.int64),
                np.array([r.score for r in answer], dtype=np.float64))

    def reference_blocks(self):
        return [(0, torch.from_numpy(self.corpus))], self.device

    def counters(self) -> dict:
        return {"host_routes": int(self.col.host_routes if self.col is not None else 0)}

    def shape(self) -> dict:
        c = self.config
        return {"batch": int(self.traffic["batch"]), "dims": int(c["dims"]), "k": self.limit,
                "candidates": self.candidates, "cards": 1, "rows_per_card": int(c["rows"]),
                "elem_bytes": 4}

    def close(self) -> None:
        if self.col is not None:
            self.col.close()
            self.col = None
        self._search = None
