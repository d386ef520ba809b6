"""The program's counter ``adaptive.fallbacks`` per
Collection.quantized_search_batch call: queries whose device answer was
flagged and that the host oracle answered instead."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    return counter_per_call("collection.quantized_search_batch", "adaptive.fallbacks")
