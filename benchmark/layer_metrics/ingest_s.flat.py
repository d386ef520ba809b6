"""Seconds from put_matrix of the corpus into a new collection until its
first search returned, measured in set-up: the whole ingest path
(the Collection's records, the index, the upload to the card, the first
search) on the flat cells, where it spreads too widely between processes
to carry a bound."""


def read(run):
    return run.ingest_s
