"""ms per Collection.quantized_search_batch call in the program's
``adaptive.wait`` spans: the host blocked reading the pipeline's four
outputs, the card's work behind them included."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.quantized_search_batch", ("adaptive.wait",))
