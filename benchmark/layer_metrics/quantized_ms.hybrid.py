"""ms per Collection.hybrid_search_batch call in the program's span
``hybrid.quantized``: the host's part of the quantized generator (the
query signs, the launches of the sign scan and the group rows, the slot
sort)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("hybrid.quantized",))
