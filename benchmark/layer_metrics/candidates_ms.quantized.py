"""ms per Collection.quantized_search_batch call in the program's span
``adaptive.candidates``: the Hamming candidates (the query signs, K6's sign
scan, the group selection, K7's group rows, the element selection), as the
host enqueues them."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.quantized_search_batch", ("adaptive.candidates",))
