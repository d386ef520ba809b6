"""ms per Collection.quantized_search_batch call in the program's span
``collection.hydrate``: the records and ``Result`` objects of the
answers."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.quantized_search_batch", ("collection.hydrate",))
