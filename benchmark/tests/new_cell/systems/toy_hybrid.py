"""A toy hybrid retrieval system, shaped like a ColBERT hybrid search: each
query is a ``[1 + Q, d]`` array (a primary row and a token set), each
document ``T`` token rows. A call scores every document by relevance, the
primary row's cosine with the document's first token plus the token set's
MaxSim (each query token's best cosine over the document's tokens,
summed), in float32, keeps the ``limit`` best by (relevance desc, row asc) and
reorders the first ``DEPTH`` of them by maximal marginal relevance.

Spans: ``toy.search`` around the scoring and selection, ``toy.rerank``
around the reorder.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.data import synth

#: the hits MMR reorders, and MMR's weight of relevance against similarity
#: to the hits before (the configuration's ``guarantees``)
DEPTH, LAMBDA = 10, 0.5


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class Answers:
    """One call's answers: row ``j`` is ``(rows [k], relevances [k])``."""

    def __init__(self, rows: np.ndarray, rel: np.ndarray):
        self.rows, self.rel = rows, rel

    def __len__(self):
        return self.rows.shape[0]

    def __getitem__(self, j):
        return self.rows[j], self.rel[j]


class System:
    def __init__(self, config, traffic, devices, spans, log):
        self.config = config
        self.traffic = traffic
        self.device = devices[0]
        self.spans = spans
        self.log = log
        self.limit = int(traffic["limit"])

    def prepare(self, seed: int) -> None:
        """The documents' tokens on the device, and a query pool: each set
        a document's first ``1 + Q`` tokens plus noise."""
        c = self.config
        n, t, q, d = (int(c[k]) for k in ("rows", "tokens", "query_tokens", "dims"))
        self.tokens = synth.clustered(n * t, d, c["cluster_rows"], c["radius"],
                                      synth.subseed(seed, 1), self.device).view(n, t, d)
        self.unit = _unit(self.tokens)
        pool = int(self.traffic["pool"])
        picks = synth.picks(n, pool, synth.subseed(seed, 2), self.device)
        base = self.tokens[picks, :1 + q].reshape(-1, d)
        self.queries = synth.perturbed(base, float(self.traffic["noise"]),
                                       synth.subseed(seed, 3)).view(pool, 1 + q, d).cpu().numpy()
        self._search = self.spans.wrap("toy.search", self.search)
        self._rerank = self.spans.wrap("toy.rerank", self.rerank)

    def ingest(self):
        """The documents are the input, made in place: no ingest to time."""
        return None

    def search(self, qs: torch.Tensor):
        """``(rows [b, limit], relevances [b, limit])`` by (relevance desc,
        row asc)."""
        qs = _unit(qs)
        primary = qs[:, 0] @ self.unit[:, 0].T
        maxsim = torch.einsum("bqd,ntd->bqnt", qs[:, 1:], self.unit).amax(-1).sum(1)
        rel, rows = (primary + maxsim).sort(dim=1, descending=True, stable=True)
        return rows[:, :self.limit], rel[:, :self.limit]

    def rerank(self, rows: torch.Tensor, rel: torch.Tensor):
        """The first ``DEPTH`` hits in MMR order: each next the one of most
        ``LAMBDA * relevance - (1 - LAMBDA) * max(0, its largest cosine of
        first tokens with a hit before it)``, the earlier on a tie."""
        m = min(DEPTH, rows.shape[1])
        first = self.unit[rows[:, :m], 0]
        sim = first @ first.transpose(1, 2)
        penalty = torch.zeros_like(rel[:, :m])
        taken = torch.zeros_like(penalty, dtype=torch.bool)
        order = []
        for _ in range(m):
            value = (LAMBDA * rel[:, :m] - (1 - LAMBDA) * penalty).masked_fill(taken, -torch.inf)
            j = value.argmax(dim=1)
            order.append(j)
            taken[torch.arange(len(j)), j] = True
            penalty = torch.maximum(penalty, sim[torch.arange(len(j)), j])
        order = torch.stack(order, 1)
        rows, rel = rows.clone(), rel.clone()
        rows[:, :m] = rows[:, :m].gather(1, order)
        rel[:, :m] = rel[:, :m].gather(1, order)
        return rows, rel

    def call(self, qs: np.ndarray) -> Answers:
        rows, rel = self._search(torch.from_numpy(qs).to(self.device))
        rows, rel = self._rerank(rows, rel)
        return Answers(rows.cpu().numpy(), rel.cpu().numpy())

    @staticmethod
    def count_bad(out, b: int, limit: int) -> int:
        return b if out.rows.shape != (b, limit) else 0

    @staticmethod
    def answer_rows(answer):
        rows, rel = answer
        return rows.astype(np.int64), rel.astype(np.float64)

    def reference_blocks(self):
        return [(0, self.tokens)], self.device

    def counters(self) -> dict:
        return {}

    def shape(self) -> dict:
        c = self.config
        return {"batch": int(self.traffic["batch"]), "dims": int(c["dims"]), "k": self.limit,
                "cards": 1, "rows_per_card": int(c["rows"]), "elem_bytes": 4}

    def close(self) -> None:
        """The tokens are the input, and the reference reads them."""
        self.unit = self._search = self._rerank = None
