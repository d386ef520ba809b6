"""ms per Collection.search_batch call outside the index's search_batch:
validation, normalisation, hydration."""

from benchmark.layer_metrics._read import outside_ms


def read(run):
    return outside_ms(run, "collection.search_batch", "index.search_batch")
