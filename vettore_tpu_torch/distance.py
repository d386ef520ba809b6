"""Public distance/similarity/normalization/rerank helpers.

The facade equivalent of ``Vettore.Distance``
(the reference's lib/vettore_distance.ex): named metric helpers return raw
values (distance metrics lower-is-better, similarity metrics
higher-is-better); plus normalization, sign packing, packed Hamming/Jaccard,
MMR reranking, and the score/distance conversion used in Results.
"""

from .metrics import rank_value, result_values, similarity_value
from .ops.distance import (
    chebyshev,
    compute,
    cosine,
    dot_product,
    euclidean,
    hamming,
    inner_product,
    jaccard,
    l2,
    l2_squared,
    manhattan,
    negative_inner_product,
    true_cosine,
)
from .ops.distance import normalize_vector as normalize
from .ops.mmr import mmr_rerank
from .ops.packing import compress_sign_bits as compress_f32_vector
from .ops.packing import packed_hamming, packed_jaccard

__all__ = [
    "l2",
    "l2_squared",
    "cosine",
    "true_cosine",
    "inner_product",
    "negative_inner_product",
    "manhattan",
    "chebyshev",
    "hamming",
    "jaccard",
    "euclidean",
    "dot_product",
    "compute",
    "normalize",
    "compress_f32_vector",
    "packed_hamming",
    "packed_jaccard",
    "mmr_rerank",
    "result_values",
    "rank_value",
    "similarity_value",
]
