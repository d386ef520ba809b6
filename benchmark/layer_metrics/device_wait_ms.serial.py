"""ms per Collection.search call in the program's ``index.wait`` spans:
the host blocked reading the index's device results."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.search", ("index.wait",))
