"""Seconds from put_tokens of the corpus into a new HNSW collection until
its first hybrid call returned, measured in set-up: the whole ingest path
(the token block's checks and normalisation, the records, the kNN build,
the first call's token block and sign block on the card) of the ColBERT
cell, where it spreads too widely between processes to carry a bound."""


def read(run):
    return run.ingest_s
