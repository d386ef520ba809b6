"""ms per Collection.quantized_search_batch call in the program's spans
``collection.validate`` (the queries' checks and float64 conversion) and
``collection.normalize`` (their float64 normalisation)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.quantized_search_batch",
                       ("collection.validate", "collection.normalize"))
