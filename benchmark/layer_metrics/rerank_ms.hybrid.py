"""ms per Collection.hybrid_search_batch call in the program's span
``hybrid.rerank``: the MaxSim rerank of the union and its reads to the
host."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("hybrid.rerank",))
