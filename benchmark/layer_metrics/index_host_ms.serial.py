"""ms per Collection.search call in the program's span ``index.search``
outside its ``index.wait`` spans: the index's own host work."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.search", ("index.search",), ("index.wait",))
