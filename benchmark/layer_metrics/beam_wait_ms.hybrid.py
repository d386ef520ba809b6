"""ms per Collection.hybrid_search_batch call in the program's
``index.wait`` spans: the hnsw generator's beam blocked reading its device
results (the only index reads of this cell's hybrid call; the rerank's
reads are ``hybrid.wait``)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("index.wait",))
