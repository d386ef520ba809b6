"""ms per Collection.hybrid_search_batch call in the program's span
``mmr.rerank``: ``ops.mmr.mmr_rerank_batch`` of the call's hits, its read
to the host included."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("mmr.rerank",))
