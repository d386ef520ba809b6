"""ms per Collection.hybrid_search_batch call in the program's
``hybrid.wait`` spans: the host blocked reading the rerank's outputs and the
generators' ok flags, the part of ``rerank_ms.hybrid`` spent waiting for
the card."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("hybrid.wait",))
