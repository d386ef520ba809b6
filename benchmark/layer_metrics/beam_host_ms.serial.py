"""ms per Collection.search call in the program's span ``index.search``
outside its ``index.wait`` spans: the HNSW index's own host work for one
query (the beam's launches and replays, its checks, the hit list)."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("collection.search", ("index.search",), ("index.wait",))
