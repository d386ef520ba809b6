"""The program's counter ``hnsw.nodes`` per query: the fresh neighbours
the HNSW beam scored, over the calls' queries."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    per_call = counter_per_call("collection.search_batch", "hnsw.nodes")
    return None if per_call is None else per_call / run.shape["batch"]
