"""The program's counter ``mesh.norms`` per sharded search (root span
``mesh.search``): the squared-norm passes over a shard that the calls ran.
A program that keeps no such counter gives None."""

from benchmark.layer_metrics._program import counter_per_call


def read(run):
    return counter_per_call("mesh.search", "mesh.norms")
