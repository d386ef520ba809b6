"""``index.wait`` spans per Collection.hybrid_search_batch call: the hnsw
generator's beam's host reads of device tensors, each a wait for the
card."""

from benchmark.layer_metrics._program import calls_of


def read(run):
    return calls_of("collection.hybrid_search_batch", "index.wait")
