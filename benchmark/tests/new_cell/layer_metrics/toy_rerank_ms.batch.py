"""ms per call in the toy system's MMR reorder (its span ``toy.rerank``)."""

from benchmark.layer_metrics._read import span_ms


def read(run):
    return span_ms(run, "toy.rerank")
