"""Seconds from the corpus's ingest into a new collection until its first
search returned (measured in set-up)."""


def read(run):
    return run.ingest_s
