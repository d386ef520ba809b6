"""ms per Collection.search_batch call in the program's span
``collection.hydrate``: store lookups and ``Result`` objects."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.search_batch", ("collection.hydrate",))
