"""Queries answered in the window per second of the window."""


def read(run):
    return run.answered / run.window_s
