"""Seconds from put_matrix of the corpus into a new collection until its
first quantized answer returned, measured in set-up: the whole ingest path
(the Collection's records, the flat index and its upload, the scan cache
that shares its block, the sign block, the first search), unbounded as on
the flat cells."""


def read(run):
    return run.ingest_s
