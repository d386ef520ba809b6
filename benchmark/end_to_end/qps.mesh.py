"""Queries answered in the window per second of the window, on a mesh of
cards: a metric apart from ``qps``, since the cards set its pace and its
runs spread far less than the host-bound one-card cells', under a bound of
its own."""


def read(run):
    return run.answered / run.window_s
