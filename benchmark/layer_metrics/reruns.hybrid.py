"""The program's counter ``hybrid.reruns`` per Collection.hybrid_search_batch
call: the batch's queries that a generator or the rerank flagged and that
re-ran alone on the host path (the hybrid's share of ``host_routes``)."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    return counter_per_call("collection.hybrid_search_batch", "hybrid.reruns")
