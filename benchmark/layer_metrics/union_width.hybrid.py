"""The program's counter ``hybrid.candidates`` per query: the live
candidates after the generators' union, which the MaxSim rerank scores."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    per_call = counter_per_call("collection.hybrid_search_batch", "hybrid.candidates")
    return None if per_call is None else per_call / run.shape["batch"]
