"""Maximal Marginal Relevance reranking.

The port of ``vettore_tpu/ops/mmr.py``. Mirrors the reference's
``Vettore.Distance.mmr_rerank/5`` (lib/vettore_distance.ex:325-519): greedy
selection of ``final_k`` items maximizing ``alpha * query_score - (1 - alpha)
* max_similarity_to_selected``; ties pick the earliest remaining candidate.
Pair similarity per metric: cosine = true cosine; inner_product = dot;
negative_inner_product = -raw; distance metrics = 1 / (1 + distance).

Two tiers, as in the JAX package: :func:`mmr_rerank` is the float64 host
loop (copied), :func:`mmr_rerank_batch` the batched device path — the
``[B, k, k]`` pair similarities as one full-f32 product (``no_tf32``, the
counterpart of ``Precision.HIGHEST``) and the greedy selection as a loop of
``final_k`` steps on ``[B, k]`` tensors. Plain PyTorch: the JAX package runs
this on XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import math
from numbers import Real

import numpy as np
import torch

from ..errors import InvalidMmrArgs, UnknownMetric
from ..index.flat import resolve_device
from ..metrics import DISTANCE_METRICS, SIMILARITY_METRICS
from ..observability import span
from .distance import _check_f32, _finite_f32, _raw_f64, no_tf32


def _pair_similarity(metric: str, a: np.ndarray, b: np.ndarray) -> float:
    if metric == "cosine":
        na = math.sqrt(float(np.dot(a, a)))
        nb = math.sqrt(float(np.dot(b, b)))
        if na == 0.0 or nb == 0.0:
            return 0.0
        sim = float(np.dot(a, b)) / (na * nb)
        return float(np.float32(min(1.0, max(-1.0, sim))))
    raw = _raw_f64(metric, a, b)
    if metric not in ("hamming", "jaccard"):
        raw = _check_f32(raw)
    else:
        raw = float(np.float32(raw))
    if metric == "inner_product":
        return raw
    if metric == "negative_inner_product":
        return -raw
    return 1.0 / (1.0 + raw)


def mmr_rerank(initial, embeddings, metric, alpha, final_k) -> list:
    """Returns the reranked ``[(id, query_score)]`` prefix of length ≤ final_k.

    ``alpha=1.0`` is pure relevance (input order preserved); lower alpha
    trades relevance for diversity against already-selected items.

    >>> pool = [("a", [1.0, 0.0]), ("b", [0.99, 0.01]), ("c", [0.0, 1.0])]
    >>> mmr_rerank([("a", 0.9), ("b", 0.89), ("c", 0.3)], pool,
    ...            "cosine", 1.0, 2)
    [('a', 0.9), ('b', 0.89)]
    >>> mmr_rerank([("a", 0.9), ("b", 0.89), ("c", 0.3)], pool,
    ...            "cosine", 0.3, 2)  # diversity pulls in the orthogonal c
    [('a', 0.9), ('c', 0.3)]
    """
    if (
        not isinstance(initial, list)
        or not isinstance(embeddings, list)
        or isinstance(alpha, bool)
        or not isinstance(alpha, Real)
        or not 0 <= float(alpha) <= 1
        or isinstance(final_k, bool)
        or not isinstance(final_k, int)
        or final_k <= 0
    ):
        raise InvalidMmrArgs("invalid mmr args")
    if metric not in SIMILARITY_METRICS and metric not in DISTANCE_METRICS:
        raise UnknownMetric(metric)
    alpha = float(alpha)

    vectors: dict[str, np.ndarray] = {}
    expected = None
    for item in embeddings:
        if not (isinstance(item, tuple) and len(item) == 2):
            raise InvalidMmrArgs("invalid mmr embedding")
        id, vector = item
        if not isinstance(id, str) or id == "" or not isinstance(vector, (list, tuple)) or not vector:
            raise InvalidMmrArgs("invalid mmr embedding")
        if id in vectors:
            raise InvalidMmrArgs("duplicate mmr embedding id")
        if expected is not None and len(vector) != expected:
            raise InvalidMmrArgs("mmr dimension mismatch")
        if not all(_finite_f32(v) for v in vector):
            raise InvalidMmrArgs("non-finite mmr vector")
        vectors[id] = np.asarray(vector, dtype=np.float64)
        expected = expected or len(vector)

    seen = set()
    for item in initial:
        if not (isinstance(item, tuple) and len(item) == 2):
            raise InvalidMmrArgs("invalid mmr initial entry")
        id, query_score = item
        if (
            not isinstance(id, str)
            or id == ""
            or not _finite_f32(query_score)
            or id not in vectors
            or id in seen
        ):
            raise InvalidMmrArgs("invalid mmr initial entry")
        seen.add(id)

    remaining = list(initial)
    selected: list = []
    while remaining and len(selected) < final_k:
        best_idx, best_score = None, None
        for idx, (id, query_score) in enumerate(remaining):
            if selected:
                redundancy = max(
                    _pair_similarity(metric, vectors[id], vectors[sel_id])
                    for sel_id, _ in selected
                )
            else:
                redundancy = 0.0
            mmr_score = alpha * float(query_score) - (1.0 - alpha) * redundancy
            if best_score is None or mmr_score > best_score:
                best_idx, best_score = idx, mmr_score
        selected.append(remaining.pop(best_idx))
    return selected


# ---------------------------------------------------------------------------
# batched device MMR (the serving path)
# ---------------------------------------------------------------------------


def pairwise_similarity_batch(vecs: torch.Tensor, *, metric: str) -> torch.Tensor:
    """Pair similarities ``[B, k, k]`` f32 for candidate vector blocks
    ``vecs`` ``[B, k, d]``, with the host loop's per-metric formulas."""
    v = vecs.float()
    if metric in ("cosine", "inner_product", "negative_inner_product", "l2", "l2_squared"):
        no_tf32(v)
        dots = torch.einsum("bkd,bjd->bkj", v, v)
        if metric == "cosine":
            norms = (v * v).sum(dim=2).sqrt()
            denom = norms[:, :, None] * norms[:, None, :]
            sim = torch.where(denom > 0.0, dots / denom, torch.zeros_like(dots))
            return sim.clamp(-1.0, 1.0)
        if metric == "inner_product":
            return dots
        if metric == "negative_inner_product":
            return -dots
        # the norms from the product's own diagonal: a row's distance to
        # itself is then exactly 0 (the host loop's value), not the square
        # root of a rounding residual
        sq = torch.diagonal(dots, dim1=1, dim2=2)
        d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * dots).clamp_min(0.0)
        return 1.0 / (1.0 + (d2.sqrt() if metric == "l2" else d2))
    a = v[:, :, None, :]
    b = v[:, None, :, :]
    if metric == "manhattan":
        dist = (a - b).abs().sum(dim=3)
    elif metric == "chebyshev":
        dist = (a - b).abs().amax(dim=3)
    elif metric == "hamming":
        dist = ((a != 0.0) != (b != 0.0)).sum(dim=3).float()
    elif metric == "jaccard":
        lt, rt = a != 0.0, b != 0.0
        union = (lt | rt).sum(dim=3).float()
        inter = (lt & rt).sum(dim=3).float()
        dist = torch.where(union > 0.0, 1.0 - inter / union.clamp_min(1.0),
                           torch.zeros_like(union))
    else:
        raise ValueError(f"unknown metric {metric}")
    return 1.0 / (1.0 + dist)


def mmr_select_batch(scores, sims, valid, alpha: float, *, final_k: int) -> torch.Tensor:
    """Greedy MMR order over precomputed pair similarities.

    ``scores`` [B, k] query scores, ``sims`` [B, k, k], ``valid`` [B, k].
    Returns ``order`` [B, min(final_k, k)] int64 candidate indices (-1 pads
    once a query runs out of candidates). Each step maximizes ``alpha *
    score - (1 - alpha) * max_sim_to_selected``; ``torch.argmax`` returns
    the first maximum, so ties go to the earliest remaining candidate
    (vettore_distance.ex:416-436)."""
    b, k = scores.shape
    steps = min(final_k, k)
    dev = scores.device
    order = torch.full((b, steps), -1, dtype=torch.int64, device=dev)
    chosen = torch.zeros((b, k), dtype=torch.bool, device=dev)
    # -inf until the first pick: redundancy may legitimately be NEGATIVE
    # (max cosine to the selected items < 0); a zero floor would mask it
    max_sim = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    rows = torch.arange(b, device=dev)
    for t in range(steps):
        redundancy = torch.where(torch.isfinite(max_sim), max_sim, torch.zeros_like(max_sim))
        mmr = alpha * scores - (1.0 - alpha) * redundancy
        mmr = mmr.masked_fill(~valid | chosen, float("-inf"))
        pick = mmr.argmax(dim=1)
        alive = mmr[rows, pick] > float("-inf")
        order[:, t] = torch.where(alive, pick, -1)
        chosen[rows, pick] |= alive
        max_sim = torch.where(alive[:, None], torch.maximum(max_sim, sims[rows, pick]), max_sim)
    return order


@span("mmr.rerank")
def mmr_rerank_batch(initial_lists, vecs, *, metric, alpha, final_k, device="cuda") -> list:
    """Batched MMR on ``device``: ``initial_lists`` is a list of per-query
    ``[(id, query_score)]`` candidate lists (ragged ok), ``vecs`` a
    ``[B, k, d]`` array or tensor of the candidate vectors in list order
    (pad rows arbitrary). Returns one reranked ``[(id, query_score)]`` list
    per query."""
    if metric not in SIMILARITY_METRICS and metric not in DISTANCE_METRICS:
        raise UnknownMetric(metric)
    if isinstance(alpha, bool) or not isinstance(alpha, Real) or not 0 <= float(alpha) <= 1:
        raise InvalidMmrArgs("invalid mmr args")
    if isinstance(final_k, bool) or not isinstance(final_k, int) or final_k <= 0:
        raise InvalidMmrArgs("invalid mmr args")
    b = len(initial_lists)
    if b == 0:
        return []
    dev = resolve_device(device)
    vecs = torch.as_tensor(vecs).to(dev)
    k = vecs.shape[1]
    scores = np.full((b, k), -np.inf, np.float32)
    valid = np.zeros((b, k), bool)
    for i, initial in enumerate(initial_lists):
        for j, (_id, s) in enumerate(initial[:k]):
            scores[i, j] = s
            valid[i, j] = True
    sims = pairwise_similarity_batch(vecs, metric=metric)
    order = mmr_select_batch(torch.from_numpy(scores).to(dev), sims,
                             torch.from_numpy(valid).to(dev), float(alpha),
                             final_k=final_k).cpu().numpy()
    return [[initial[int(j)] for j in order[i] if j >= 0]
            for i, initial in enumerate(initial_lists)]
