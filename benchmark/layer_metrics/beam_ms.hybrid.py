"""ms per Collection.hybrid_search_batch call in the program's span
``hybrid.hnsw``: the hnsw generator, the HNSW beam and its waits on the
card included."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("hybrid.hnsw",))
