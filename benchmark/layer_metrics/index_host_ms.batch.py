"""ms per Collection.search_batch call in the program's span
``index.search_batch`` outside its ``index.wait`` spans: the index's own
host work (its query checks, launches, hit lists)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.search_batch", ("index.search_batch",), ("index.wait",))
