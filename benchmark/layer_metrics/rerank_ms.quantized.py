"""ms per Collection.quantized_search_batch call in the program's span
``adaptive.rerank``: the exact rescore of the candidates
(``ops.pipeline.rerank_batch``), as the host enqueues it."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.quantized_search_batch", ("adaptive.rerank",))
