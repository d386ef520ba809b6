"""Device-side MUVERA FDE block: the candidate generator for fast
multi-vector (ColBERT MaxSim) search.

The port of ``vettore_tpu/ops/muvera_fde.py``. MUVERA (the reference's
muvera.rs:26-74) compresses every token set to ONE fixed-dimensional vector
whose inner product approximates the chamfer similarity, so candidate
generation becomes a single ``[B, fde] x [fde, N]`` product plus a top-C
selection, followed by an exact MaxSim rerank of the C winners
(``ops/maxsim.maxsim_subset_topk_batch``).

The document encoder here is the device counterpart of
``ops/muvera.encode_documents``: the same hash-derived SimHash weights and
Rademacher signs (``ops/muvera._random_weights`` / ``_random_signs``), the
same query-sum / document-average semantics, but the per-partition average
is an f32 segment mean in one einsum instead of the host's sequential
running average — equal up to f32 rounding order, which the bf16 block's
rounding hides but for a last-ulp tie. Public ``encode_document`` /
``encode_query`` keep the bit-exact host path; the query FDEs of the
candidate generator come from it too.

The selection runs on the hand-written K5 kernel
(``flat_scan.fused_stage_candidates`` with ``metric="inner_product"`` over
all of the block's columns) whenever the block qualifies; other blocks take
the plain selection (one product and an exact top-C). ``ROUTES`` counts
which way each call went.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..index.flat import _ROW_TILE
from . import flat_scan
from . import muvera as host_muvera
from .distance import no_tf32
from .select import exact_top_c

#: candidate-selection metric family: FDE inner products approximate the
#: MaxSim similarity, which is the (clipped) dot for all three dot-family
#: metrics (multi_vector.rs:44-87)
FDE_METRICS = ("cosine", "inner_product", "negative_inner_product")

#: document chunk for the encoding sweep (bounds the [chunk, T, P] one-hot
#: and [chunk, T, pd] projection intermediates to a few hundred MB)
_ENC_CHUNK = 65_536

#: row-tile divisor of every cache capacity above one tile
#: (``collection._cap_at_least``, the flat index's tile); the K5 route asks
#: for it as the JAX package does, so both take the same route for the same
#: block
_CAP_TILE = _ROW_TILE

#: calls of :func:`fde_candidates` by selection route: "fused" (K5) and
#: "plain"
ROUTES = {"fused": 0, "plain": 0}


def default_config(dims: int) -> dict:
    """Internal-generator default: 16 SimHash partitions x 8 repetitions,
    projection to min(16, dims) — ~2048 FDE dims at d >= 16."""
    return {
        "dimension": dims,
        "num_repetitions": 8,
        "num_simhash_projections": 4,
        "projection_dimension": min(16, dims),
        "seed": 20_260_721,
    }


def normalize_config(config: dict | None, dims: int) -> dict:
    """Full MUVERA config validation (the host encoder's whitelist) for the
    candidate-generator path."""
    return host_muvera._normalize_config(dict(config or {}), dims)


def config_key(cfg: dict) -> tuple:
    return tuple(cfg[k] for k in host_muvera.CONFIG_KEYS)


def fde_width(cfg: dict) -> int:
    full = (cfg["num_repetitions"] * (1 << cfg["num_simhash_projections"])
            * cfg["projection_dimension"])
    return cfg["final_projection_dimension"] or full


def padded_width(cfg: dict) -> int:
    """FDE width padded to a multiple of 128 — zero columns leave inner
    products unchanged; the block's width is the JAX package's."""
    w = fde_width(cfg)
    return -(-w // 128) * 128


def _rep_constants(cfg: dict):
    """Host-derived per-repetition hash constants (bit-identical to the
    host encoder's): SimHash weight rows [reps, simhash, d] and Rademacher
    sign rows [reps, pd, d] (None in identity mode)."""
    dims = cfg["dimension"]
    reps = cfg["num_repetitions"]
    simhash = cfg["num_simhash_projections"]
    pd = cfg["projection_dimension"]
    seed = cfg["seed"]
    w = None
    if simhash:
        w = np.stack([
            np.stack([host_muvera._random_weights(seed, rep, p, dims)
                      for p in range(simhash)])
            for rep in range(reps)
        ]).astype(np.float32)
    s = None
    if pd != dims:
        sign_seed = (seed + 17) & host_muvera.U64_MAX
        s = np.stack([
            np.stack([host_muvera._random_signs(sign_seed, rep, p, dims)
                      for p in range(pd)])
            for rep in range(reps)
        ]).astype(np.float32)
    return w, s


def _sketch_constants(cfg: dict):
    """Count-sketch slot/sign tables (muvera.rs:180-200 hashes)."""
    final = cfg["final_projection_dimension"]
    if final is None:
        return None, None
    full = (cfg["num_repetitions"] * (1 << cfg["num_simhash_projections"])
            * cfg["projection_dimension"])
    idx = np.arange(full, dtype=np.uint64)
    seed = cfg["seed"]
    slots = (host_muvera._hash4(np.uint64(seed), host_muvera._GOLDEN, idx,
                                np.uint64(0)) % np.uint64(final)).astype(np.int64)
    sign_hash = host_muvera._hash4(np.uint64(seed), host_muvera._SKETCH_SIGN,
                                   idx, slots.astype(np.uint64))
    signs = np.where((sign_hash & np.uint64(1)) == 0, np.float32(1.0),
                     np.float32(-1.0))
    return slots, signs


def _encode_chunk(tokens, counts, w, s, sk_slots, sk_signs, *, cfg, out_pad, out_dtype):
    """One document chunk -> [chunk, out_pad] FDEs in ``out_dtype``
    (document mode: per-partition MEAN in f32; empty partitions stay zero;
    zero-token docs encode to the zero vector, whose inner product is 0 —
    exactly their MaxSim score, multi_vector.rs:44-60). Every product runs
    in full f32 (``no_tf32``)."""
    n, t, _d = tokens.shape
    simhash = cfg["num_simhash_projections"]
    parts_count = 1 << simhash
    tok = tokens.float()
    no_tf32(tok)
    mask = torch.arange(t, device=tok.device)[None, :] < counts[:, None]  # [n, t]
    powers = 1 << torch.arange(simhash - 1, -1, -1, device=tok.device)  # msb first, as host
    partitions = torch.arange(parts_count, device=tok.device)
    outs = []
    for rep in range(cfg["num_repetitions"]):
        if simhash:
            bits = (torch.einsum("ntd,sd->nts", tok, w[rep]) >= 0.0).long()
            parts = (bits * powers).sum(dim=2)
        else:
            parts = torch.zeros((n, t), dtype=torch.int64, device=tok.device)
        onehot = ((parts[:, :, None] == partitions) & mask[:, :, None]).float()  # [n, t, P]
        vals = tok if s is None else torch.einsum("ntd,vd->ntv", tok, s[rep])
        sums = torch.einsum("ntp,ntv->npv", onehot, vals)
        cnts = onehot.sum(dim=1)  # [n, P]
        mean = sums / cnts.clamp_min(1.0)[:, :, None]
        outs.append(mean.reshape(n, -1))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if sk_slots is not None:
        # count-sketch compression: signed scatter-add by hashed slot
        sketch = torch.zeros((n, cfg["final_projection_dimension"]), device=tok.device)
        out = sketch.index_add_(1, sk_slots, out * sk_signs[None, :])
    if out_pad > out.shape[1]:
        out = F.pad(out, (0, out_pad - out.shape[1]))
    return out.to(out_dtype)


def encode_documents_device(tokens, counts, cfg: dict, out_dtype=torch.float32):
    """Document FDEs of a resident ``[cap, T, d]`` token block (``counts``
    [cap] live tokens per doc): a ``[cap, padded_width]`` tensor in
    ``out_dtype`` on the block's device, encoded ``_ENC_CHUNK`` docs at a
    time so the intermediates stay bounded (each chunk is cast to the
    storage dtype as it is placed). Pad slots (count 0) encode to zero
    rows."""
    dev = tokens.device
    cap = int(tokens.shape[0])
    w, s = _rep_constants(cfg)
    sk_slots, sk_signs = _sketch_constants(cfg)

    def put(a):
        return None if a is None else torch.from_numpy(a).to(dev)

    consts = (put(w), put(s), put(sk_slots), put(sk_signs))
    out_pad = padded_width(cfg)
    out = torch.empty((cap, out_pad), dtype=out_dtype, device=dev)
    for i in range(0, cap, _ENC_CHUNK):
        out[i:i + _ENC_CHUNK] = _encode_chunk(
            tokens[i:i + _ENC_CHUNK], counts[i:i + _ENC_CHUNK], *consts, cfg=cfg,
            out_pad=out_pad, out_dtype=out_dtype)
    return out


def encode_query_sets_host(query_token_sets, cfg: dict) -> np.ndarray:
    """Query FDEs (sum mode) via the BIT-EXACT host encoder
    (``ops/muvera.encode_queries``), padded to the device block's width, as
    f32. Query batches are small, so the host cost is small, and
    bit-exactness keeps the public encoder on the serving path."""
    out = host_muvera.encode_queries(
        [np.asarray(ts, dtype=np.float64) for ts in query_token_sets], cfg)
    pad = padded_width(cfg)
    if out.shape[1] < pad:
        out = np.pad(out, ((0, 0), (0, pad - out.shape[1])))
    return out.astype(np.float32)


def block_sq_norms(x):
    """Row squared norms of a resident block as f32, ``_ENC_CHUNK`` rows at
    a time (a whole-block f32 copy of a bf16 block would double its
    memory)."""
    return torch.cat([(x[i:i + _ENC_CHUNK].float() ** 2).sum(dim=1)
                      for i in range(0, int(x.shape[0]), _ENC_CHUNK)])


def _plain_fde_candidates(fde, bias, qfde, *, count):
    """Plain selection for blocks K5 does not take: one full-f32 product
    and the exact top-C by (rank, slot)."""
    no_tf32(qfde)
    dots = qfde @ fde.float().T
    rank = -dots + bias[None, :]
    rank = torch.where(torch.isfinite(rank), rank, torch.full_like(rank, float("inf")))
    return exact_top_c(rank, None, c=count)


def fde_candidates(fde, fde_xsq, bias, qfde, *, count: int):
    """Top-``count`` candidate slots per query by FDE inner product
    (descending dot, (rank, slot) ties — slot order is lex id order).
    ``fde`` [N, W] (the cache's bf16 block), ``fde_xsq`` and ``bias`` [N]
    f32, ``qfde`` [B, W] f32. Returns ``(slots [B, count] int64, ok [B]
    bool)``; ok False = a tie spill or an overflow (the caller's host
    route)."""
    n, width = int(fde.shape[0]), int(fde.shape[1])
    count = min(count, n)
    if (
        n >= flat_scan.GROUP
        and n % _CAP_TILE == 0
        and flat_scan.supports_candidates("inner_product", n, width, count)
    ):
        ROUTES["fused"] += 1
        slots, _ranks, ok = flat_scan.fused_stage_candidates(
            fde, fde_xsq, bias, qfde, metric="inner_product", count=count, dims=width)
        return slots, ok
    ROUTES["plain"] += 1
    slots, _keys, ok = _plain_fde_candidates(fde, bias, qfde, count=count)
    return slots, ok
