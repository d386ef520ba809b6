"""Public MUVERA fixed-dimensional encoding API.

Facade equivalent of ``Vettore.Encoding.Muvera``
(the reference's lib/vettore/encoding/muvera.ex). The intended retrieval flow:
encode query and document multi-vectors to fixed-dimensional vectors, search
them with inner product, then rerank candidates with exact MaxSim.
"""

from .ops.muvera import (
    CONFIG_KEYS,
    MAX_OUTPUT_DIMENSIONS,
    encode_document,
    encode_documents,
    encode_queries,
    encode_query,
)

__all__ = [
    "encode_query",
    "encode_document",
    "encode_queries",
    "encode_documents",
    "CONFIG_KEYS",
    "MAX_OUTPUT_DIMENSIONS",
]
