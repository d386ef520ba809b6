"""The program's counter ``hnsw.steps`` per Collection.search call: the
HNSW beam's layer-0 steps for one query."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    return counter_per_call("collection.search", "hnsw.steps")
