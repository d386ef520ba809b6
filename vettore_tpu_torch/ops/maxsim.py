"""ColBERT MaxSim (Chamfer) late-interaction scoring.

The port of ``vettore_tpu/ops/maxsim.py``. The host pairwise path mirrors
the reference's multi_vector.rs: each query vector takes its best
document-vector similarity; the score is the sum. An empty query or
document side scores 0.0, but the non-empty side is still validated
(multi_vector.rs:44-60,101-111).

The device paths score a padded ``[N, T, d]`` token block (f32, or bf16
when that is lossless: ``put_token_block``) against query token sets:

* ``batched_maxsim_scores`` — one query set, every doc (plain torch; the
  JAX package's single-set scan, which the port's ``multi_vector_search``
  replaces by a batch of one);
* ``maxsim_full_topk_batch`` — a batch of query sets over doc chunks, for
  every metric (plain torch; the JAX package leaves it to XLA);
* ``fused_maxsim_topk_batch`` — the dot-family full scan: the hand-written
  CUDA kernel ``maxsim_rank_scan`` (``csrc/maxsim.cu``, on the tensor-core
  scan skeleton ``csrc/wgmma_scan.cuh``: bf16 products for bf16 blocks,
  3xTF32 for f32 blocks) writes the ``[B, N]`` rank matrix in one pass over
  the block, the group cover selects candidates (K7 gathers their group
  rows), and ``maxsim_subset_topk_batch`` re-scores the winners in full f32.

The kernel wrapper launches its CUDA kernel for CUDA tensors and runs its
plain version for CPU tensors; any other device raises. Its launches are
counted in ``LAUNCHES``, and by operand route in ``ROUTES``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import DimensionMismatch, InvalidVector, ScoreOverflow
from ..metrics import similarity_value, validate_metric
from . import select
from .distance import _check_f32, _raw_f64, no_tf32, validate_vector
from .flat_scan import GROUP, _group_rows, _tma_rows, extract_group_rows, tf32_split
from .topk import lex_sort, smallest

#: kernel launch counts, by kernel name
LAUNCHES = {"maxsim_rank_scan": 0}

#: launches of the MaxSim scan by operand route: "direct" when TMA reads the
#: token block and the query tokens in place, "padded" when the wrapper
#: first copied the block (tokens per doc off the kernel's counts, see
#: ``kernel_tokens``) or gave a block or the queries a row stride TMA can
#: address (``flat_scan._tma_rows``). Padding the query sets to a power of
#: two copies only the small query and is not counted.
ROUTES = {"maxsim_rank_scan": {"direct": 0, "padded": 0}}

FUSED_MV_METRICS = ("cosine", "inner_product", "negative_inner_product")

#: most query tokens per set the kernel takes: a set wider than the kernel's
#: query tile writes one [B, N] part of its totals per tile, summed after
MAX_QUERY_TOKENS = 8192

_BIG32 = 2**31 - 1
_SQ_CHUNK = 65_536


def _row_sq_sums(x2):
    """Per-row squared norms in f32, chunk by chunk, so a bf16 block never
    gets a full-width f32 copy (16.4 GB at 1M x 32 x 128 token rows)."""
    out = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    for s in range(0, x2.shape[0], _SQ_CHUNK):
        c = x2[s:s + _SQ_CHUNK].float()
        out[s:s + _SQ_CHUNK] = (c * c).sum(dim=1)
    return out


def token_norms(tokens):
    """``(tsq, tinv)`` of a token block ``[N, T, d]``: for every token row
    ``[N * T]`` f32, its squared norm and its inverse norm ``1 / sqrt(tsq)``
    (0 for a zero row). The scan cache keeps them beside its block: the
    MaxSim scan takes ``tinv`` for cosine, and ``tsq`` bounds the dot
    metrics' totals."""
    tsq = _row_sq_sums(tokens.reshape(-1, tokens.shape[-1]))
    return tsq, torch.where(tsq > 0.0, 1.0 / tsq.sqrt(), torch.zeros_like(tsq))


def is_bf16_exact(mat: np.ndarray) -> bool:
    """True when every f32 value is exactly representable in bfloat16 (low
    16 mantissa bits all zero)."""
    if mat.dtype != np.float32:
        return False
    return bool((mat.view(np.uint32) & np.uint32(0xFFFF) == 0).all())


def put_token_block(block: np.ndarray, device) -> torch.Tensor:
    """A multi-vector token block on ``device``, **bfloat16-resident** when
    that is lossless (a bf16 value's bits are the high half of its f32
    bits, so the block converts on the host and half the bytes move), else
    f32. The storage dtype is part of the semantics: it decides the MaxSim
    kernel's input type, and bf16 blocks select candidates with bf16 dots
    (the flat bf16 posture) before the full-f32 rerank."""
    block = np.ascontiguousarray(block, dtype=np.float32)
    if block.size and is_bf16_exact(block):
        halves = (block.view(np.uint32) >> np.uint32(16)).astype(np.uint16).view(np.int16)
        return torch.from_numpy(halves).view(torch.bfloat16).to(device)
    return torch.from_numpy(block).to(device)


# ---------------------------------------------------------------------------
# host pairwise path
# ---------------------------------------------------------------------------


def _validate_matrix(vectors, dimension=None):
    """Validates a list of equal-length finite vectors; returns the dimension
    (or None for an empty list)."""
    if not isinstance(vectors, (list, tuple)):
        raise InvalidVector("vectors must be a list")
    if not vectors:
        return dimension
    first_len = len(vectors[0])
    if first_len == 0:
        raise InvalidVector("vectors must not be empty")
    expected = dimension if dimension is not None else first_len
    for v in vectors:
        if len(v) != expected:
            raise DimensionMismatch("dimension mismatch")
        validate_vector(list(v))
    return expected


def _pair_similarity(metric: str, q: np.ndarray, t: np.ndarray) -> float:
    if metric == "cosine":
        nq = math.sqrt(float(np.dot(q, q)))
        nt = math.sqrt(float(np.dot(t, t)))
        raw = 0.0 if nq == 0.0 or nt == 0.0 else float(
            np.float32(min(1.0, max(-1.0, float(np.dot(q, t)) / (nq * nt))))
        )
    else:
        raw = _raw_f64(metric, q, t)
        if metric not in ("hamming", "jaccard"):
            raw = _check_f32(raw)
        else:
            raw = float(np.float32(raw))
    return similarity_value(metric, raw)


def score(query_vectors, document_vectors, metric="cosine") -> float:
    """One MaxSim score (``MultiVector.chamfer/colbert_score``,
    multi_vector.rs:40-87)."""
    metric = validate_metric(metric)
    if not query_vectors:
        _validate_matrix(document_vectors)
        return 0.0
    dimension = _validate_matrix(query_vectors)
    if not document_vectors:
        return 0.0
    _validate_matrix(document_vectors, dimension)

    total = 0.0
    for q in query_vectors:
        qa = np.asarray(q, dtype=np.float64)
        best = -math.inf
        for t in document_vectors:
            best = max(best, _pair_similarity(metric, qa, np.asarray(t, dtype=np.float64)))
        # the reference accumulates the running total in f32
        # (multi_vector.rs:70-86); overflow past f32 range is an error
        with np.errstate(over="ignore"):
            total = float(np.float32(total + best))
        if not math.isfinite(total):
            raise ScoreOverflow("score overflow")
    return total


def top_k(documents, query_vectors, metric="cosine", limit: int = 10) -> list:
    """Batched MaxSim over ``[(id, [vectors])]``; highest score first, ties by
    lexicographically smaller id (multi_vector.rs:90-132)."""
    metric = validate_metric(metric)
    _validate_matrix(query_vectors)
    query_dim = len(query_vectors[0]) if query_vectors else None

    hits = []
    for id, vectors in documents:
        if query_dim is None:
            _validate_matrix(vectors)
            doc_score = 0.0
        elif not vectors:
            doc_score = 0.0
        else:
            _validate_matrix(vectors, query_dim)
            doc_score = score(query_vectors, vectors, metric)
        hits.append((doc_score, str(id)))
    hits.sort(key=lambda h: (-h[0], h[1]))
    return [(id, s) for s, id in hits[:limit]]


# ---------------------------------------------------------------------------
# plain torch device paths (every metric)
# ---------------------------------------------------------------------------


def _elementwise_dist(t_src, q_src, metric, axis):
    """Distances of the elementwise metrics over ``axis`` (f32 operands)."""
    if metric == "manhattan":
        return (t_src - q_src).abs().sum(dim=axis)
    if metric == "chebyshev":
        return (t_src - q_src).abs().amax(dim=axis)
    lt = t_src != 0.0
    rt = q_src != 0.0
    if metric == "hamming":
        return (lt != rt).sum(dim=axis).float()
    if metric == "jaccard":
        union = (lt | rt).sum(dim=axis).float()
        inter = (lt & rt).sum(dim=axis).float()
        return torch.where(union > 0.0, 1.0 - inter / union, torch.zeros_like(union))
    raise ValueError(f"unknown metric {metric}")


def batched_maxsim_scores(tokens, token_counts, queries, *, metric: str):
    """MaxSim totals for a padded doc-token block.

    ``tokens`` [D, T, d] f32 or bf16 (zero-padded), ``token_counts`` [D]
    int32, ``queries`` [Q, d] f32 → ``(totals [D] f32, pair_finite [D]
    bool)``. Docs with zero tokens score 0.0; pad token positions are
    masked out of the max. ``pair_finite`` flags docs whose pair scores
    stayed finite (f32 overflow sends the search to the host float64
    path)."""
    n, t, _d = tokens.shape
    nq = queries.shape[0]
    q = queries.float()
    tok = tokens.float()
    no_tf32(tok)
    if metric in FUSED_MV_METRICS:
        sim = torch.einsum("qd,ntd->nqt", q, tok)
        if metric == "cosine":
            qn = (q * q).sum(dim=1).sqrt()
            tn = (tok * tok).sum(dim=2).sqrt()
            denom = qn[None, :, None] * tn[:, None, :]
            sim = torch.where(denom > 0.0, sim / denom, torch.zeros_like(sim)).clamp(-1.0, 1.0)
        # negative_inner_product: raw = -dot, similarity = -raw = dot
    elif metric in ("l2", "l2_squared"):
        dots = torch.einsum("qd,ntd->nqt", q, tok)
        qsq = (q * q).sum(dim=1)[None, :, None]
        tsq = (tok * tok).sum(dim=2)[:, None, :]
        dist_sq = (qsq + tsq - 2.0 * dots).clamp_min(0.0)
        sim = 1.0 / (1.0 + (dist_sq.sqrt() if metric == "l2" else dist_sq))
    else:
        # elementwise metrics: a [D, Q, T, d] broadcast (candidate-set sizes)
        sim = 1.0 / (1.0 + _elementwise_dist(tok[:, None, :, :], q[None, :, None, :],
                                             metric, 3))
    token_mask = torch.arange(t, device=tokens.device)[None, :] < token_counts[:, None]
    live = token_mask[:, None, :].expand(n, nq, t)
    pair_finite = (torch.isfinite(sim) | ~live).reshape(n, -1).all(dim=1)
    masked = torch.where(live, sim, torch.full_like(sim, float("-inf")))
    totals = masked.amax(dim=2).sum(dim=1)
    totals = torch.where(token_counts > 0, totals, torch.zeros_like(totals))
    if nq == 0:
        totals = torch.zeros(n, dtype=torch.float32, device=tokens.device)
    return totals, pair_finite


def _sim_bcqt(doc_tokens, qtok, *, metric: str, shared_docs: bool):
    """Pair similarities [B, C, Q, T] (f32).

    ``doc_tokens``: [C, T, d] when ``shared_docs`` (full-corpus chunk) else
    [B, C, T, d] (per-query candidate gather); ``qtok``: [B, Q, d] f32.
    Semantics per metric match ``_pair_similarity`` (multi_vector.rs:44-87).
    """
    vec_axis = 2 if shared_docs else 3
    q = qtok.float()
    doc = doc_tokens.float()
    no_tf32(doc)

    def mm():
        return torch.einsum("bqd,ctd->bcqt" if shared_docs else "bqd,bctd->bcqt", q, doc)

    def per_doc(v):  # [C, T] or [B, C, T] -> broadcastable to [B, C, Q, T]
        return v[None, :, None, :] if shared_docs else v[:, :, None, :]

    if metric in FUSED_MV_METRICS:
        sim = mm()
        if metric == "cosine":
            qn = (q * q).sum(dim=2).sqrt()
            tn = (doc * doc).sum(dim=vec_axis).sqrt()
            denom = qn[:, None, :, None] * per_doc(tn)
            sim = torch.where(denom > 0.0, sim / denom, torch.zeros_like(sim)).clamp(-1.0, 1.0)
        return sim
    if metric in ("l2", "l2_squared"):
        dots = mm()
        qsq = (q * q).sum(dim=2)
        tsq = (doc * doc).sum(dim=vec_axis)
        dist_sq = (qsq[:, None, :, None] + per_doc(tsq) - 2.0 * dots).clamp_min(0.0)
        return 1.0 / (1.0 + (dist_sq.sqrt() if metric == "l2" else dist_sq))
    # elementwise metrics: a [B, C, Q, T, d] broadcast (candidate sets only)
    t_src = doc[None, :, None, :, :] if shared_docs else doc[:, :, None, :, :]
    return 1.0 / (1.0 + _elementwise_dist(t_src, q[:, None, :, None, :], metric, 4))


def _totals_bc(sim, token_counts, qmask, *, shared_docs: bool):
    """MaxSim totals [B, C] + per-query finiteness [B] from sim [B, C, Q, T].

    ``token_counts``: [C] (shared) or [B, C]; ``qmask``: [B, Q] marks real
    query token rows (pads contribute nothing). Zero-token docs and empty
    query sets score 0.0 (multi_vector.rs:44-60,101-111).
    """
    t = sim.shape[3]
    counts_bc = token_counts[None, :] if shared_docs else token_counts  # [1 or B, C]
    token_mask = torch.arange(t, device=sim.device) < counts_bc[..., None]  # [., C, T]
    tm = token_mask[:, :, None, :].expand(sim.shape)
    live = tm & qmask[:, None, :, None]
    finite = (torch.isfinite(sim) | ~live).reshape(sim.shape[0], -1).all(dim=1)
    masked = torch.where(tm, sim, torch.full_like(sim, float("-inf")))
    best = masked.amax(dim=3)  # [B, C, Q]
    best = torch.where(qmask[:, None, :], best, torch.zeros_like(best))
    totals = best.sum(dim=2)  # [B, C]
    totals = torch.where(counts_bc > 0, totals, torch.zeros_like(totals))
    # a finite-pair sum can still overflow f32 — the host oracle raises there
    return totals, finite & torch.isfinite(totals).all(dim=1)


def _top_desc(scores, slots, k):
    """The ``k`` best of ``scores`` [B, M] (descending, ties to the lowest
    position) with their ``slots``."""
    vals, pos = smallest(-scores, k)
    return -vals, slots.gather(1, pos)


def _merge_desc(scores_a, slots_a, scores_b, slots_b, limit):
    """Merges two (score desc, slot asc)-ordered candidate sets."""
    s = torch.cat([scores_a, scores_b], dim=1)
    sl = torch.cat([slots_a, slots_b], dim=1)
    key_slot = torch.where(s > float("-inf"), sl, torch.full_like(sl, _BIG32))
    order = lex_sort(-s, key_slot)[:, :limit]
    return s.gather(1, order), sl.gather(1, order)


def maxsim_full_topk_batch(tokens, token_counts, valid, qtok, qmask, *,
                           metric: str, limit: int, chunk: int):
    """Full-corpus MaxSim top-k for a batch of query token sets.

    ``tokens`` [N, T, d] (f32 or bf16 storage), ``token_counts`` [N] int32,
    ``valid`` [N] bool, ``qtok`` [B, Qt, d] f32, ``qmask`` [B, Qt] bool.
    Scores doc chunks of ``chunk`` rows (the [B, chunk, Qt, T] similarity
    block is the only large intermediate) and keeps a running (score desc,
    slot asc) top-k merge. Returns ``(slots [B, L] int64 (-1 pads), scores
    [B, L], ok [B])``; ``ok`` False = a non-finite pair or total for that
    query → host fallback. Slot order is the caller's lex id order, so the
    slot tie-break equals the reference's id tie-break
    (multi_vector.rs:118-124)."""
    n = tokens.shape[0]
    b = qtok.shape[0]
    limit = min(limit, n)
    chunk = min(chunk, n)

    def score_chunk(start):
        sim = _sim_bcqt(tokens[start:start + chunk], qtok, metric=metric, shared_docs=True)
        totals, fin = _totals_bc(sim, token_counts[start:start + chunk], qmask,
                                 shared_docs=True)
        slots = (start + torch.arange(chunk, device=tokens.device)).expand(b, chunk)
        scores = torch.where(valid[None, start:start + chunk], totals,
                             torch.full_like(totals, float("-inf")))
        return scores, slots, fin

    k_scores = torch.full((b, limit), float("-inf"), device=tokens.device)
    k_slots = torch.full((b, limit), _BIG32, dtype=torch.int64, device=tokens.device)
    ok = torch.ones(b, dtype=torch.bool, device=tokens.device)
    for i in range(-(-n // chunk)):
        # the final chunk clamps to [N - chunk, N); rows already covered by
        # the previous chunk are masked out (no duplicate slots)
        start = min(i * chunk, n - chunk)
        scores, slots, fin = score_chunk(start)
        scores = torch.where(slots >= i * chunk, scores, torch.full_like(scores, float("-inf")))
        t_scores, t_slots = _top_desc(scores, slots, min(limit, chunk))
        k_scores, k_slots = _merge_desc(k_scores, k_slots, t_scores, t_slots, limit)
        ok = ok & fin
    k_slots = torch.where(k_scores > float("-inf"), k_slots, torch.full_like(k_slots, -1))
    return k_slots, k_scores, ok


def maxsim_subset_topk_batch(tokens, token_counts, slots, slot_ok, qtok, qmask, *,
                             metric: str, limit: int):
    """Per-query candidate-subset MaxSim rerank (full f32 arithmetic on the
    storage values).

    ``slots`` [B, C] cache slots (pads where ``slot_ok`` is False),
    ``qtok`` [B, Qt, d] f32 per-query token sets with ``qmask`` [B, Qt].
    Returns ``(top_slots [B, k] (-1 pads), scores [B, k], ok [B])`` ordered
    by (score desc, slot asc). Callers bound the [B, C, T, d] gather by
    chunking the query batch."""
    safe = slots.clamp_min(0).long()
    sub = tokens[safe]  # [B, C, T, d] in the storage dtype
    subc = torch.where(slot_ok, token_counts[safe], 0)
    sim = _sim_bcqt(sub, qtok, metric=metric, shared_docs=False)
    totals, ok = _totals_bc(sim, subc, qmask, shared_docs=False)
    scores = torch.where(slot_ok, totals, torch.full_like(totals, float("-inf")))
    k = min(limit, slots.shape[1])
    key_slot = torch.where(scores > float("-inf"), safe, torch.full_like(safe, _BIG32))
    order = lex_sort(-scores, key_slot)[:, :k]
    score_s = scores.gather(1, order)
    slot_s = slots.long().gather(1, order)
    top_slots = torch.where(score_s > float("-inf"), slot_s, torch.full_like(slot_s, -1))
    return top_slots, score_s, ok


# ---------------------------------------------------------------------------
# the fused full scan: maxsim_rank_scan (replaces K8 and K9) + group cover
# ---------------------------------------------------------------------------


def supports_fused(metric: str, cap: int, qmax: int) -> bool:
    """Whether the fused MaxSim scan serves this configuration. Its real
    limits: a dot-family metric (the kernel computes dots; the other metrics
    take ``maxsim_full_topk_batch``); ``cap`` a multiple of 64 and at least
    64 (the group cover selects 64-doc groups); at most ``MAX_QUERY_TOKENS``
    tokens per query set. Any d, T and query count run."""
    return (metric in FUSED_MV_METRICS and cap >= GROUP and cap % GROUP == 0
            and 0 < qmax <= MAX_QUERY_TOKENS)


def kernel_tokens(t: int) -> int:
    """The tokens per doc the MaxSim kernel takes for a block of ``t``: the
    next power of two up to 128 (a 128-row tile then holds whole docs),
    else the next multiple of 128 (a doc spans whole tiles). The scan
    cache's blocks already have such a ``t``."""
    return 1 << (t - 1).bit_length() if t <= 128 else -(-t // 128) * 128


def query_tile(cols: int, bf16: bool) -> int:
    """The MaxSim kernel's query tile for ``cols`` query tokens: 64, 128, or
    256 (bf16 blocks only: the 3xTF32 stages carry two query buffers). A
    set of Q tokens (a power of two) lies whole in one tile when Q is at
    most the tile, else across Q / tile tiles."""
    if cols <= 64:
        return 64
    return 128 if cols <= 128 or not bf16 else 256


def _kernel_operands(tokens, tinv, qt, qinv, *, b):
    """The MaxSim operands as the kernel takes them: T tokens per doc grown
    to ``kernel_tokens(T)`` with zero token rows (``tinv`` 0), and Q query
    tokens per set to the next power of two with zero rows (``qinv`` 0):
    each adds exactly 0 to a live doc's total. Returns ``(tokens [N, Tk,
    d], tinv [N * Tk] or None, qt [B * Qk, d], qinv [B * Qk], copied)``,
    ``copied`` True when the token block was."""
    n, t, d = tokens.shape
    nq = qt.shape[0] // b
    tk, qk = kernel_tokens(t), 1 << (nq - 1).bit_length()
    if tk != t:
        grown = tokens.new_zeros((n, tk, d))
        grown[:, :t] = tokens
        tokens = grown
        if tinv is not None:
            tinv = torch.nn.functional.pad(tinv.reshape(n, t), (0, tk - t)).reshape(-1)
    if qk != nq:
        qt = torch.nn.functional.pad(qt.reshape(b, nq, d), (0, 0, 0, qk - nq)).reshape(-1, d)
        qinv = torch.nn.functional.pad(qinv.reshape(b, nq), (0, qk - nq)).reshape(-1)
    return tokens, tinv, qt.contiguous(), qinv.contiguous(), tk != t


def _maxsim_rank_scan_ref(tokens, counts, dbias, qt, qinv, *, b, metric, tinv=None):
    """Plain PyTorch version of ``maxsim_rank_scan``: the same [B, N] ranks
    from a full [N*T, B*Q] similarity matrix (cosine: ``(dot * tinv) *
    qinv`` clipped to [-1, 1], ``tinv`` of ``token_norms`` unless given)."""
    n, t, d = tokens.shape
    nq = qt.shape[0] // b
    x2 = tokens.reshape(n * t, d)
    no_tf32(qt)
    sim = x2.float() @ qt.T  # [N*T, B*Q]
    if metric == "cosine":
        if tinv is None:
            tinv = token_norms(tokens)[1]
        sim = (sim * tinv[:, None] * qinv[None, :]).clamp(-1.0, 1.0)
    sim = sim.reshape(n, t, b, nq)
    live = torch.arange(t, device=tokens.device)[None, :] < counts[:, None]
    sim = torch.where(live[:, :, None, None], sim, torch.full_like(sim, float("-inf")))
    rank = -sim.amax(dim=1).sum(dim=2)  # [N, B]
    rank = torch.where(counts[:, None] <= 0, torch.zeros_like(rank), rank)
    return (rank + dbias[:, None]).T.contiguous()


def maxsim_rank_scan(tokens, counts, dbias, qt, qinv, *, b, metric, tinv=None):
    """The ``[B, N]`` MaxSim rank matrix: ``rank[b, n] = -sum over the set's
    Q query tokens of the max over doc n's live tokens of sim``, exactly 0
    for a zero-token doc, plus ``dbias`` (+inf on dead docs).

    ``tokens`` [N, T, d] f32 or bf16 (pad token rows zero), ``counts`` [N]
    int32 live tokens per doc (T for every doc of a uniform block),
    ``dbias`` [N] f32, ``qt`` [B*Q, d] f32 query
    tokens, set-major (pad query tokens are zero rows), ``qinv`` [B*Q] f32
    inverse query-token norms (cosine; ignored otherwise), ``tinv`` [N*T]
    f32 inverse token norms (cosine; ``token_norms`` computes them when not
    given). Under bf16 storage the queries are rounded to bf16 for the dots
    (bf16 x bf16 products, exact in f32), as the JAX kernel casts them to
    the storage dtype. On the card f32 blocks take 3xTF32 products, within
    ``MV_RTOL`` of the plain f32 version."""
    if metric not in FUSED_MV_METRICS:
        raise ValueError(f"maxsim_rank_scan has no metric {metric!r}")
    if tokens.dim() != 3 or tokens.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("tokens must be a float32 or bfloat16 [N, T, d] block")
    n, t, d = tokens.shape
    if qt.dim() != 2 or qt.shape[1] != d or qt.shape[0] % b or not qt.shape[0]:
        raise ValueError(f"qt {tuple(qt.shape)} is not [{b} * Q, {d}]")
    nq = qt.shape[0] // b
    if nq > MAX_QUERY_TOKENS:
        raise ValueError(f"{nq} query tokens per set exceed {MAX_QUERY_TOKENS}")
    for name, tensor, shape in (("dbias", dbias, (n,)), ("qt", qt, (b * nq, d)),
                                ("qinv", qinv, (b * nq,))):
        if tensor.dtype != torch.float32 or tuple(tensor.shape) != shape:
            raise TypeError(f"{name} must be float32 of shape {shape}")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (n,):
        raise TypeError(f"counts must be int32 of shape {(n,)}")
    cosine = metric == "cosine"
    if cosine and tinv is None:
        tinv = token_norms(tokens)[1]
    if tinv is not None and (tinv.dtype != torch.float32 or tuple(tinv.shape) != (n * t,)):
        raise TypeError(f"tinv must be float32 of shape {(n * t,)}")
    for tensor in (counts, dbias, qt, qinv) + ((tinv,) if tinv is not None else ()):
        if tensor.device != tokens.device:
            raise ValueError(f"operands on {tensor.device} and {tokens.device}")
    bf16 = tokens.dtype == torch.bfloat16
    if tokens.device.type == "cpu":
        qs = qt.to(torch.bfloat16).float() if bf16 else qt
        return _maxsim_rank_scan_ref(tokens, counts, dbias, qs, qinv, b=b, metric=metric,
                                     tinv=tinv)
    if not tokens.is_cuda:
        raise ValueError(f"maxsim_rank_scan runs on cuda or cpu tensors, not {tokens.device}")
    from .. import _build

    if not all(tensor.is_contiguous() for tensor in (tokens, counts, dbias, qinv)):
        raise ValueError("kernel operands must be contiguous")
    tokens, tinv, qt, qinv, copied = _kernel_operands(
        tokens, tinv.contiguous() if tinv is not None else None, qt, qinv, b=b)
    tk, nq = tokens.shape[1], qt.shape[0] // b
    parts = (qt.to(torch.bfloat16),) if bf16 else tf32_split(qt)
    xt, ldx, x_copied = _tma_rows(tokens.view(n * tk, d))
    qts = [_tma_rows(part) for part in parts]
    qn = query_tile(b * nq, bf16)
    out = torch.empty((max(1, nq // qn), b, n), dtype=torch.float32, device=tokens.device)
    _build.launch("maxsim_rank_scan", tokens.device, xt, ldx, int(bf16), counts, dbias,
                  tinv if cosine else None, qts[0][0], qts[-1][0], qts[0][1], qinv, out, n, tk,
                  d, b, nq, qn, int(cosine))
    LAUNCHES["maxsim_rank_scan"] += 1
    copied = copied or x_copied or any(c for _t, _ld, c in qts)
    ROUTES["maxsim_rank_scan"]["padded" if copied else "direct"] += 1
    # a set wider than the query tile: its parts' totals, summed in order
    return out[0] if out.shape[0] == 1 else out.sum(dim=0)


def fused_maxsim_topk_batch(tokens, token_counts, valid, qtok, qmask, *,
                            metric: str, limit: int, norms=None):
    """Fused full-corpus MaxSim top-k: the rank scan kernel, group-cover
    candidate selection, and a full-f32 subset rerank of the winners.

    Same contract as :func:`maxsim_full_topk_batch` (slots in cache-lex
    order, (score desc, slot asc) ties, ``ok`` per query). ``norms`` is
    ``token_norms(tokens)`` (the scan cache's), computed here when None.
    Candidate selection ranks with the storage dtype (bf16 blocks select
    with bf16 dots — the flat bf16 posture); the returned scores come from
    ``maxsim_subset_topk_batch``, so they match the plain path's values."""
    cap, t, d = tokens.shape
    b, qmax = qtok.shape[0], qtok.shape[1]
    tsq, tinv = token_norms(tokens) if norms is None else norms
    qf = qtok.float()
    qsq = (qf * qf).sum(dim=2)  # [B, Q]
    if metric == "cosine":
        qn = qsq.sqrt()
        qinv = torch.where(qn > 0.0, 1.0 / qn.clamp_min(1e-38), torch.zeros_like(qn))
        bound_ok = torch.ones((), dtype=torch.bool, device=tokens.device)  # |cos| <= 1
    else:
        qinv = torch.ones_like(qsq)
        # overflow posture (flat_scan.gmin_scan): prove every |dot| and every
        # total finite via norm products, else route to the host oracle
        bound_ok = (tsq.max().sqrt() * qsq.max().sqrt() * qmax) < 3.0e37
    dbias = torch.where(valid, 0.0, float("inf")).float()
    rank = maxsim_rank_scan(tokens, token_counts, dbias, qf.reshape(b * qmax, d),
                            qinv.reshape(-1), b=b, metric=metric, tinv=tinv)

    # group-cover selection (flat_scan discipline): C candidates for the
    # full-f32 rerank, then the exact top-limit comes from re-scored values
    c = min(max(2 * limit, 64), cap)
    ng = cap // GROUP
    gmin = rank.view(b, ng, GROUP).amin(dim=2)
    gsel = min(c + select.SLACK, ng)
    _gv, gidx, g_ok = select.group_topk(gmin, gsel, check_c=c)
    gidx = gidx.clamp_max(ng - 1)
    cand = extract_group_rows(rank.view(b, ng, GROUP), gidx.int()).reshape(b, gsel * GROUP)
    cand_slots = _group_rows(gidx).reshape(b, gsel * GROUP)
    slots, ranks, sel_ok = select.exact_top_c_slots(cand, cand_slots, c=c)
    slot_ok = torch.isfinite(ranks) & (slots >= 0)
    top_slots, scores, sub_ok = maxsim_subset_topk_batch(
        tokens, token_counts, slots.clamp_min(0), slot_ok, qtok, qmask,
        metric=metric, limit=limit)
    return top_slots, scores, sel_ok & g_ok & sub_ok & bound_ok
