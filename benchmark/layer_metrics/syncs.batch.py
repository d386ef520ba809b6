"""``index.wait`` spans per Collection.search_batch call: the index's
host reads of device tensors, each a wait for the card."""

from benchmark.layer_metrics._program import calls_of


def read(run):
    return calls_of("collection.search_batch", "index.wait")
