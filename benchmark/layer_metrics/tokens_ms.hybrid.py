"""ms per Collection.hybrid_search_batch call in the program's span
``collection.validate_tokens``: the query token sets' checks,
normalisation and padding."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.hybrid_search_batch", ("collection.validate_tokens",))
