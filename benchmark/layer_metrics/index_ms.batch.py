"""ms per index search_batch call (it ends in its copy to the host)."""

from benchmark.layer_metrics._read import span_ms


def read(run):
    return span_ms(run, "index.search_batch")
