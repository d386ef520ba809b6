"""Seconds from the start of the run until the measured window opens."""


def read(run):
    return run.setup_s
