"""ms per Collection.hybrid_search_batch call in the program's span
``hybrid.union``: the host's part of the generators' candidate union (its
sort and dedup run on the card)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("hybrid.union",))
