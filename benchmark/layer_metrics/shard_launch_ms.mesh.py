"""ms per sharded search (the program's root span ``mesh.search``) in its
``mesh.launch`` spans: the one host thread enqueueing each shard's search."""

from benchmark.layer_metrics._program import ms_per_call


def read(run):
    return ms_per_call("mesh.search", ("mesh.launch",))
