"""A ColBERT hybrid deployment of ``vettore_tpu_torch.Collection`` on one
device: documents of token rows ingested by ``put_tokens`` into an HNSW
collection, each call a batch of query token sets through
``hybrid_search_batch`` (the hnsw and quantized generators, the MaxSim
rerank), the hits' primary vectors read back with ``get`` and the first
``mmr_k`` reordered by ``ops.mmr.mmr_rerank_batch``.

Each query of the pool is a ``[1 + Q, d]`` array: the pooled primary row
the generators take, then the ``Q`` query tokens the rerank scores. Each
answer is ``limit`` documents: the MMR picks, then the other hits in the
hybrid's order, each with its MaxSim score.

Spans: ``collection.hybrid_search_batch`` around the hybrid call,
``client.vectors`` around the ``get`` reads, ``mmr.rerank_batch`` around
MMR.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.data import synth

#: rows of the throwaway collection whose first search loads the kernels
_WARM_ROWS = 4096


class Answers:
    """One call's answers: row ``j`` is ``(rows [k], scores [k])``."""

    def __init__(self, rows: list, scores: list):
        self.rows, self.scores = rows, scores

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, j):
        return self.rows[j], self.scores[j]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class System:
    def __init__(self, config, traffic, devices, spans, log):
        self.config = config
        self.traffic = traffic
        self.device = devices[0]
        self.spans = spans
        self.log = log
        self.limit = int(traffic["limit"])
        self.generators = [("hnsw", {"candidates": int(traffic["hnsw_candidates"])}),
                           ("quantized", {"candidates": int(traffic["quantized_candidates"])})]
        self.col = None

    # -- set-up -------------------------------------------------------------

    def prepare(self, seed: int) -> None:
        """Loads the program and its kernels, makes the documents' tokens and
        the query pool on the device from ``seed``, and keeps both on the
        host, where a caller of ``put_tokens`` and ``hybrid_search_batch``
        holds them. A document's tokens are noisy copies of its base row
        (``token_noise``), the bases clustered; a query is one document's
        first ``query_tokens`` tokens, each with noise of ``query_noise``."""
        import vettore_tpu_torch as vt
        from vettore_tpu_torch.ops import mmr

        self.vt, self.mmr = vt, mmr
        c = self.config
        n, t, q, d = (int(c[k]) for k in ("rows", "tokens", "query_tokens", "dims"))
        t0 = time.perf_counter()
        warm = vt.Collection(name="warm", dimensions=d, metric=c["metric"], index="flat",
                             device=self.device)
        rows = synth.clustered(_WARM_ROWS, d, c["cluster_rows"], c["radius"], 1, self.device)
        warm.put_matrix([str(i) for i in range(_WARM_ROWS)], rows.cpu().numpy())
        warm.search_batch(rows[:2].cpu().numpy(), limit=self.limit)
        warm.close()
        del warm, rows
        t1 = time.perf_counter()
        bases = synth.clustered(n, d, c["cluster_rows"], c["radius"], synth.subseed(seed, 1),
                                self.device)
        tokens = synth.perturbed(bases.repeat_interleave(t, dim=0), float(c["token_noise"]),
                                 synth.subseed(seed, 2)).view(n, t, d)
        del bases
        pool = int(self.traffic["pool"])
        picks = synth.picks(n, pool, synth.subseed(seed, 3), self.device)
        qtok = synth.perturbed(tokens[picks, :q].reshape(-1, d), float(c["query_noise"]),
                               synth.subseed(seed, 4)).view(pool, q, d)
        primary = _unit(qtok.mean(dim=1))
        self.queries = torch.cat([primary[:, None], qtok], dim=1).cpu().numpy()
        self.tokens = tokens.cpu().numpy()
        del tokens, picks, qtok, primary
        width = len(str(n - 1))
        self.ids = [f"{i:0{width}d}" for i in range(n)]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.log(f"kernels and warm collection {t1 - t0:.1f}s; {n} documents of {t} x {d} "
                 f"tokens and {pool} query sets {time.perf_counter() - t1:.1f}s")

    def ingest(self) -> float:
        """Seconds from ``put_tokens`` of the documents into a new HNSW
        collection until its first hybrid call (one batch of the traffic)
        has returned, synchronised."""
        c = self.config
        col = self.vt.Collection(name=c["name"], dimensions=int(c["dims"]), metric=c["metric"],
                                 normalize=c["normalize"], index=c["index"],
                                 index_options=c["index_options"], device=self.device)
        first = self.queries[:int(self.traffic["batch"])]
        t0 = time.perf_counter()
        col.put_tokens(self.ids, self.tokens)
        self._ask(col.hybrid_search_batch, first)
        col.sync()
        ingest_s = time.perf_counter() - t0
        self.col = col
        self._hybrid = self.spans.wrap("collection.hybrid_search_batch", col.hybrid_search_batch)
        self._vectors = self.spans.wrap("client.vectors", self.vectors)
        self._mmr = self.spans.wrap("mmr.rerank_batch", self.mmr.mmr_rerank_batch)
        self.log(f"ingest {ingest_s:.2f}s")
        return ingest_s

    # -- the timed path -----------------------------------------------------

    def _ask(self, search, qs: np.ndarray) -> list:
        """``search`` (a ``hybrid_search_batch``) of the primary rows of
        ``qs``, reranked by MaxSim over its token sets, each set a list of
        one-dimensional rows as an encoder hands them over."""
        return search(qs[:, 0], limit=self.limit, generators=self.generators,
                      rerank=("multi_vector", [list(s) for s in qs[:, 1:]]))

    def vectors(self, hits: list) -> np.ndarray:
        """``[B, limit, d]``: each hit's primary vector as ``get`` returns
        it, in hit order (zero rows past a short answer)."""
        out = np.zeros((len(hits), self.limit, int(self.config["dims"])), np.float32)
        for i, row in enumerate(hits):
            for j, r in enumerate(row):
                out[i, j] = self.col.get(r.id).vector
        return out

    def call(self, qs: np.ndarray) -> Answers:
        tr = self.traffic
        hits = self._ask(self._hybrid, qs)
        initial = [[(r.id, r.score) for r in row] for row in hits]
        picks = self._mmr(initial, self._vectors(hits), metric=self.config["metric"],
                          alpha=float(tr["mmr_alpha"]), final_k=int(tr["mmr_k"]),
                          device=self.device)
        rows, scores = [], []
        for first, rest in zip(picks, initial):
            taken = {i for i, _s in first}
            ordered = first + [h for h in rest if h[0] not in taken]
            rows.append(np.array([int(i) for i, _s in ordered], dtype=np.int64))
            scores.append(np.array([s for _i, s in ordered], dtype=np.float64))
        return Answers(rows, scores)

    @staticmethod
    def count_bad(out, b: int, limit: int) -> int:
        return sum(len(r) != limit for r in out.rows) + max(0, b - len(out))

    # -- after the window ---------------------------------------------------

    @staticmethod
    def answer_rows(answer):
        rows, scores = answer
        return rows.astype(np.int64), scores.astype(np.float64)

    def reference_blocks(self):
        return [(0, torch.from_numpy(self.tokens))], self.device

    def counters(self) -> dict:
        index = self.col.index if self.col is not None else None
        return {"host_routes": int(getattr(index, "host_routes", 0) or 0)
                + int(self.col.host_routes if self.col is not None else 0)}

    def shape(self) -> dict:
        c, tr = self.config, self.traffic
        return {"batch": int(tr["batch"]), "dims": int(c["dims"]), "k": self.limit,
                "cards": 1, "rows_per_card": int(c["rows"]), "tokens": int(c["tokens"]),
                "query_tokens": int(c["query_tokens"]),
                "candidates": min(int(tr["hnsw_candidates"]), int(tr["quantized_candidates"])),
                "elem_bytes": 2}

    def close(self) -> None:
        if self.col is not None:
            self.col.close()
            self.col = None
        self._hybrid = self._vectors = self._mmr = None
