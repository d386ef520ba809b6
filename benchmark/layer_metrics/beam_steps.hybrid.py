"""The program's counter ``hnsw.steps`` per Collection.hybrid_search_batch
call: the HNSW beam's layer-0 steps."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    return counter_per_call("collection.hybrid_search_batch", "hnsw.steps")
