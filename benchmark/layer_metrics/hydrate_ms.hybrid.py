"""ms per Collection.hybrid_search_batch call in the program's span
``collection.hydrate``: the hits' ``Result`` objects."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("collection.hydrate",))
