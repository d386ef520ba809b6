"""The program's counter ``hnsw.nodes`` per query of a
Collection.hybrid_search_batch call: the fresh neighbours the hnsw
generator's beam scored."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    per_call = counter_per_call("collection.hybrid_search_batch", "hnsw.nodes")
    return None if per_call is None else per_call / run.shape["batch"]
