"""Public multi-vector (ColBERT / Chamfer) scoring helpers.

Facade equivalent of ``Vettore.MultiVector``
(the reference's lib/vettore/multi_vector.ex): ``chamfer`` is the MaxSim-style
operation under its general name, ``colbert_score`` is the alias.
"""

from .ops.maxsim import score as _score
from .ops.maxsim import top_k


def chamfer(query_vectors, document_vectors, metric="cosine") -> float:
    """Sum over query vectors of the best document-vector similarity.

    >>> chamfer([[1.0, 0.0]], [[1.0, 0.0], [0.0, 1.0]])
    1.0
    >>> chamfer([[1.0, 0.0], [0.0, 1.0]], [[1.0, 0.0]], metric="inner_product")
    1.0
    >>> chamfer([], [[1.0, 0.0]])  # empty side scores 0.0
    0.0
    """
    return _score(query_vectors, document_vectors, metric)


def colbert_score(query_vectors, document_vectors, metric="cosine") -> float:
    """ColBERT late-interaction score (alias of :func:`chamfer`).

    >>> colbert_score([[0.0, 2.0]], [[0.0, 1.0]])
    1.0
    """
    return chamfer(query_vectors, document_vectors, metric)


__all__ = ["chamfer", "colbert_score", "top_k"]
