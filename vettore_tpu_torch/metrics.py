"""Metric registry: names, codes, aliases, and score/rank/similarity semantics.

Mirrors the reference's metric semantics exactly:

* metric codes 0..8 — reference native/vettore/src/distances.rs:25-38
* rank conversion (ascending = better) — distances.rs:113-119
* similarity conversion (higher = better) — distances.rs:122-128
* result (score, distance) semantics — reference lib/vettore_distance.ex:525-547
* aliases euclidean/dot/dot_product — reference lib/vettore/collection.ex:1300-1304
"""

from __future__ import annotations

from .errors import UnknownMetric

METRICS = (
    "l2",
    "l2_squared",
    "cosine",
    "inner_product",
    "negative_inner_product",
    "manhattan",
    "chebyshev",
    "hamming",
    "jaccard",
)

SIMILARITY_METRICS = frozenset({"cosine", "inner_product"})
DISTANCE_METRICS = frozenset(
    {"l2", "l2_squared", "negative_inner_product", "manhattan", "chebyshev", "hamming", "jaccard"}
)

_ALIASES = {
    "euclidean": "l2",
    "dot": "inner_product",
    "dot_product": "inner_product",
}

_CODES = {name: code for code, name in enumerate(METRICS)}

#: Largest finite float32, as a Python float. Inputs outside this range are
#: rejected exactly like the reference's f32 boundary checks
#: (reference lib/vettore/collection.ex:61,1264-1270).
F32_MAX = 3.4028234663852886e38

#: usize cap at the NIF boundary (reference lib/vettore/collection.ex:60).
MAX_USIZE = 4_294_967_295


def normalize_metric(metric):
    """Resolves aliases to canonical metric names; passes everything else through.

    >>> normalize_metric("euclidean")
    'l2'
    >>> normalize_metric("dot")
    'inner_product'
    >>> normalize_metric("cosine")
    'cosine'
    """
    return _ALIASES.get(metric, metric)


def is_metric(metric) -> bool:
    return metric in _CODES


def validate_metric(metric) -> str:
    """Returns the canonical metric name or raises :class:`UnknownMetric`."""
    metric = normalize_metric(metric)
    if metric not in _CODES:
        raise UnknownMetric(metric)
    return metric


def metric_code(metric) -> int:
    """Wire code 0..8 of a metric (distances.rs:25-38 schema).

    >>> metric_code("l2")
    0
    >>> metric_code("jaccard")
    8
    >>> metric_code("euclidean")  # aliases resolve first
    0
    """
    return _CODES[validate_metric(metric)]


def metric_from_code(code: int) -> str:
    if not isinstance(code, int) or not 0 <= code < len(METRICS):
        raise UnknownMetric(code)
    return METRICS[code]


def rank_value(metric: str, raw: float) -> float:
    """Converts a raw metric value into ascending rank order (lower = better).

    >>> rank_value("cosine", 0.75)
    0.25
    >>> rank_value("inner_product", 3.0)
    -3.0
    >>> rank_value("l2", 2.0)
    2.0
    """
    if metric == "cosine":
        return 1.0 - raw
    if metric == "inner_product":
        return -raw
    return raw


def similarity_value(metric: str, raw: float) -> float:
    """Converts a raw metric value into a higher-is-better similarity.

    >>> similarity_value("cosine", 0.75)
    0.75
    >>> similarity_value("negative_inner_product", -3.0)
    3.0
    >>> similarity_value("l2", 1.0)
    0.5
    """
    if metric in ("cosine", "inner_product"):
        return raw
    if metric == "negative_inner_product":
        return -raw
    return 1.0 / (1.0 + raw)


def result_values(metric, raw: float, score_mode: str = "raw"):
    """Converts a raw metric value into the explicit (score, distance) pair.

    Semantics match ``Vettore.Distance.result_values/3``
    (reference lib/vettore_distance.ex:525-547):

    * ``negative_inner_product`` (either mode): ``(-raw, raw)``
    * similarity metric, raw mode: ``(raw, sim_distance)``
    * distance metric, raw mode: ``(-raw, raw)``
    * similarity metric, similarity mode: cosine ``((raw+1)/2, 1-raw)``,
      inner_product ``(raw, -raw)``
    * distance metric, similarity mode: ``(1/(1+raw), raw)``
    * unknown metric: ``(raw, None)``

    >>> result_values("cosine", 0.5)
    (0.5, 0.5)
    >>> result_values("cosine", 0.5, "similarity")
    (0.75, 0.5)
    >>> result_values("l2", 3.0)
    (-3.0, 3.0)
    >>> result_values("l2", 3.0, "similarity")
    (0.25, 3.0)
    >>> result_values("negative_inner_product", -2.0)
    (2.0, -2.0)
    """
    raw = float(raw)
    if metric == "negative_inner_product" and score_mode in ("raw", "similarity"):
        return (-raw, raw)
    if metric in SIMILARITY_METRICS:
        distance = 1.0 - raw if metric == "cosine" else -raw
        if score_mode == "raw":
            return (raw, distance)
        if score_mode == "similarity":
            score = (raw + 1.0) / 2.0 if metric == "cosine" else raw
            return (score, distance)
    if metric in DISTANCE_METRICS:
        if score_mode == "raw":
            return (-raw, raw)
        if score_mode == "similarity":
            return (1.0 / (1.0 + raw), raw)
    return (raw, None)


def default_normalize(metric: str) -> str:
    """Cosine collections default to l2 normalization; everything else to none
    (reference lib/vettore/collection.ex:1317-1319).

    >>> default_normalize("cosine")
    'l2'
    >>> default_normalize("l2")
    'none'
    """
    return "l2" if metric == "cosine" else "none"
