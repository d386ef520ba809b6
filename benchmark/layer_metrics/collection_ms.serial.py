"""ms per Collection.search call outside the index's search."""

from benchmark.layer_metrics._read import outside_ms


def read(run):
    return outside_ms(run, "collection.search", "index.search")
