"""Carries the JAX package's search state across to this package.

Every function here takes plain numpy arrays (``np.asarray`` of a JAX array
gives one), so this module needs neither JAX nor ``ml_dtypes``: a bfloat16
array is recognised by its dtype's name and widened bit for bit.

* :func:`flat_device_state` — the operands of ``fused_flat_search`` (the
  JAX ``FlatIndex``'s ``_device`` block and ``_device_scan`` tuple) as this
  package's tensors;
* :func:`flat_index_from_numpy` — a :class:`FlatIndex` rebuilt from a JAX
  ``FlatIndex``'s host mirror with its slot layout unchanged;
* :func:`scan_cache_state` — a JAX ``_VectorCache``'s device arrays (the
  operands of the funnel and quantized pipelines) as this package's tensors;
* :func:`int8_device_state` — a JAX int8 ``storage_view``'s quantized block
  and scales (the operands of ``fused_int8_search``);
* :func:`token_block_state` — a JAX ``_VectorCache``'s multi-vector token
  block (the operands of the MaxSim search, ``ops/maxsim.py``);
* :func:`hnsw_graph_state` — a JAX HNSW device graph (a bulk build's
  ``BulkGraph`` or a host graph's ``DeviceGraph`` snapshot) as this
  package's, so both packages' beam searches run on one graph;
* :func:`ivf_state` — a built JAX ``IvfIndex``'s routing structure and
  pending tail installed in this package's ``IvfIndex``, so both packages
  probe the same blocks;
* :func:`sharded_hnsw_state` / :func:`sharded_ivf_state` — a JAX
  ``ShardedHnsw`` / ``ShardedIvf``'s stacked shard arrays as this
  package's per-shard state on a mesh, so both packages search the same
  shard graphs and blocks.

Snapshots need no conversion: both packages write and read the same file
format (``store/snapshot.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .errors import DimensionMismatch, InvalidVector
from .index.flat import FlatIndex, resolve_device, round_bf16
from .index.hnsw_build import BulkGraph, _MutState
from .index.hnsw_device import DeviceGraph


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _as_f32(a) -> np.ndarray:
    """float32 copy of ``a``; bfloat16 input widens exactly (its 16 bits are
    the high half of the float32)."""
    a = np.asarray(a)
    if _is_bf16(a):
        bits = a.view(np.uint16).astype(np.uint32) << np.uint32(16)
        return bits.view(np.float32)
    return np.array(a, dtype=np.float32)


def _block(x) -> torch.Tensor:
    """An f32 or bf16 array as a tensor of the same dtype."""
    x = np.asarray(x)
    if _is_bf16(x):
        return torch.from_numpy(np.array(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(x, dtype=np.float32))


def flat_device_state(x, xsq, bias, lex_rank, *, device):
    """``(x, xsq, bias, lex_rank)`` tensors on ``device`` for
    ``ops.flat_scan.fused_flat_search``, from the JAX operands: ``x``
    ``[N, d]`` f32 or bf16 (kept in its dtype), ``xsq`` and ``bias``
    ``[N]`` or ``[N, 1]`` f32 (flattened), ``lex_rank`` ``[N]`` int32."""
    dev = resolve_device(device)
    x_t = _block(x)
    n = x_t.shape[0]
    xsq_t = torch.from_numpy(_as_f32(xsq).reshape(-1))
    bias_t = torch.from_numpy(_as_f32(bias).reshape(-1))
    lex_t = torch.from_numpy(np.array(lex_rank, dtype=np.int32).reshape(-1))
    for name, t in (("xsq", xsq_t), ("bias", bias_t), ("lex_rank", lex_t)):
        if t.shape[0] != n:
            raise DimensionMismatch(f"{name} has {t.shape[0]} rows, x has {n}")
    return tuple(t.to(dev) for t in (x_t, xsq_t, bias_t, lex_t))  # fresh copies already


def flat_index_from_numpy(metric, ids, host_x, valid, *, storage="f32", device="cuda"):
    """A :class:`FlatIndex` holding a JAX ``FlatIndex``'s records in the same
    slots: ``ids`` is its ``_ids`` list (``None`` for a free slot),
    ``host_x`` its ``[cap, d]`` host mirror (f32 or bf16) and ``valid`` its
    ``[cap]`` validity mask. Slot ``s`` of the result holds slot ``s`` of the
    source, so slot numbers from either index mean the same record. Free
    slots are refilled lowest first by later inserts."""
    host = _as_f32(host_x)
    valid = np.array(valid, dtype=bool).reshape(-1)
    ids = list(ids)
    if host.ndim != 2 or host.shape[0] != valid.shape[0] or len(ids) != valid.shape[0]:
        raise InvalidVector("ids, host_x and valid must describe the same slots")
    if any((id is not None) != bool(v) for id, v in zip(ids, valid)):
        raise InvalidVector("ids and valid disagree on which slots are live")
    index = FlatIndex(metric, storage=storage, device=device)
    if not valid.any():
        return index
    host[~valid] = 0.0  # dead slots must rank exactly at their +inf bias
    index._cap = host.shape[0]
    index._dim = host.shape[1]
    index._host_x = round_bf16(host) if storage == "bf16" else host
    index._valid = valid
    index._ids = ids
    index._slot_of = {id: s for s, id in enumerate(ids) if id is not None}
    if len(index._slot_of) != int(valid.sum()):
        raise InvalidVector("duplicate ids in the slot table")
    index._free = [int(s) for s in np.flatnonzero(~valid)[::-1]]
    return index


def scan_cache_state(x, valid, bits, signs, stage_xsq, *, device):
    """``(x, valid, bits, signs, stage_xsq)`` tensors on ``device`` for the
    ``ops.pipeline`` functions, from a JAX ``_VectorCache``'s device arrays:
    ``x`` ``[cap, d]`` f32 or bf16 (kept in its dtype), ``valid`` ``[cap]``
    bool, ``bits`` ``[cap, W]`` uint32 packed sign words (returned as int64,
    since torch has no shifts for uint32), ``signs`` ``[cap, d]`` ±1 int8 and
    ``stage_xsq`` ``[cap]`` f32 prefix squared norms or None (each of
    ``bits``, ``signs`` may be None too)."""
    dev = resolve_device(device)
    x_t = _block(x)
    n = x_t.shape[0]
    valid_t = torch.from_numpy(np.array(valid, dtype=bool).reshape(-1))
    bits_t = None if bits is None else torch.from_numpy(
        np.array(bits, dtype=np.uint32).astype(np.int64))
    signs_t = None if signs is None else torch.from_numpy(np.array(signs, dtype=np.int8))
    xsq_t = None if stage_xsq is None else torch.from_numpy(_as_f32(stage_xsq).reshape(-1))
    for name, t in (("valid", valid_t), ("bits", bits_t), ("signs", signs_t),
                    ("stage_xsq", xsq_t)):
        if t is not None and t.shape[0] != n:
            raise DimensionMismatch(f"{name} has {t.shape[0]} rows, x has {n}")
    if signs_t is not None and signs_t.shape[1] != x_t.shape[1]:
        raise DimensionMismatch(f"signs have {signs_t.shape[1]} columns, x has {x_t.shape[1]}")
    return tuple(None if t is None else t.to(dev)
                 for t in (x_t, valid_t, bits_t, signs_t, xsq_t))


def int8_device_state(x8, scale, *, device):
    """``(x8, scale)`` tensors on ``device`` from a JAX int8 view (its
    ``_device[0]`` block and ``_int8_scale``): ``x8`` ``[N, d]`` int8 and
    ``scale`` ``[N]`` (or ``[N, 1]``) f32 dequant factors, bit for bit."""
    dev = resolve_device(device)
    x8_t = torch.from_numpy(np.array(x8, dtype=np.int8))
    scale_t = torch.from_numpy(_as_f32(scale).reshape(-1))
    if x8_t.ndim != 2 or scale_t.shape[0] != x8_t.shape[0]:
        raise DimensionMismatch(f"scale has {scale_t.shape[0]} rows, x8 has {x8_t.shape[0]}")
    return x8_t.to(dev), scale_t.to(dev)


def token_block_state(tokens, counts, *, device):
    """``(tokens, counts)`` on ``device`` from a JAX ``_VectorCache``'s
    ``multi_vectors()``: ``tokens`` ``[cap, T, d]`` f32 or bf16 (kept in its
    dtype: the storage dtype decides the MaxSim kernel's input and selection
    precision), ``counts`` ``[cap]`` int32 live tokens per doc, each in
    ``[0, T]``."""
    dev = resolve_device(device)
    tok_t = _block(tokens)
    counts_t = torch.from_numpy(np.array(counts, dtype=np.int32).reshape(-1))
    if tok_t.ndim != 3 or counts_t.shape[0] != tok_t.shape[0]:
        raise DimensionMismatch(f"counts has {counts_t.shape[0]} rows, tokens {tuple(tok_t.shape)}")
    if ((counts_t < 0) | (counts_t > tok_t.shape[1])).any():
        raise InvalidVector(f"token counts must lie in [0, {tok_t.shape[1]}]")
    return tok_t.to(dev), counts_t.to(dev)


def hnsw_graph_state(graph, *, device):
    """This package's device graph for a JAX HNSW graph, on ``device``.

    ``graph`` is a JAX ``hnsw_build.BulkGraph`` (it has ``levels``) or a
    JAX ``hnsw_device.DeviceGraph`` (it has the hub slots of its host
    graph); its fields are read through ``np.asarray``: ``x`` (f32), ``a0``,
    ``up_index``, ``up_adj``, ``lex_rank``, ``valid`` (or None),
    ``entry_slot``, ``entry_level``, ``ids``, ``n``, ``m``, ``m0``,
    ``lmax`` and ``metric``, and for a bulk graph ``levels``,
    ``lex_spacing`` and ``_mut``. Slots, adjacency and tie-break ranks are
    kept as they are, so slot numbers mean the same node in both.

    A mutated bulk graph (``_mut`` set) comes across whole: its arrays at
    their capacity, trash rows included, its ``valid`` mask and its host
    bookkeeping, so the same writes afterwards give the same graph in both
    packages (the capacity sizes an incremental put's hub set). Other graphs
    are cut to their ``n`` slots."""
    dev = resolve_device(device)
    n = int(graph.n)
    st = getattr(graph, "_mut", None)

    def tensor(a, dtype, cut=True):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a[:n] if cut and st is None else a, dtype=dtype)).to(dev)

    fields = dict(
        ids=[str(i) for i in graph.ids][:n], n=n, m=int(graph.m), m0=int(graph.m0),
        lmax=int(graph.lmax), metric=str(graph.metric),
        x=tensor(_as_f32(graph.x), np.float32),
        a0=tensor(graph.a0, np.int32), up_index=tensor(graph.up_index, np.int32),
        up_adj=tensor(graph.up_adj, np.int32, cut=False), lex_rank=tensor(graph.lex_rank, np.int32),
        entry_slot=int(np.asarray(graph.entry_slot)),
        entry_level=int(np.asarray(graph.entry_level)),
        valid=None if graph.valid is None else tensor(graph.valid, bool),
    )
    if not hasattr(graph, "levels"):
        return DeviceGraph(**fields, hub_slots=np.array(graph._hub_slots_np, dtype=np.int32))
    out = BulkGraph(**fields, levels=np.array(graph.levels, dtype=np.int32)[:n],
                    lex_spacing=int(getattr(graph, "lex_spacing", 1)))
    if st is not None:
        mut = _MutState()
        mut.slot_of = dict(st.slot_of)
        mut.levels_np = np.array(st.levels_np, dtype=np.int32)
        mut.valid_np = np.array(st.valid_np, dtype=bool)
        mut.lex_np = np.array(st.lex_np, dtype=np.int64)
        mut.dead = int(st.dead)
        mut.sorted_ids = np.array(st.sorted_ids)
        mut.sorted_ranks = np.array(st.sorted_ranks, dtype=np.int64)
        mut.up_used = int(st.up_used)
        mut.levels_d = torch.from_numpy(mut.levels_np.copy()).to(dev)
        out.levels = mut.levels_np
        out._mut = mut
    return out


def ivf_state(index, *, xb, xsq, bias, lex, bcb, csq, bbias, block_ids, tuned=None,
              tail=None, tombstoned=0):
    """Installs a built JAX ``IvfIndex``'s state in ``index``, this
    package's ``IvfIndex`` whose mirror holds the same records, and returns
    it. The arrays are the JAX index's ``_xb`` (``[capb, d]`` f32 or bf16,
    kept in its dtype), ``_xsq``, ``_bias`` and ``_lex`` (``[capb]``),
    ``_bcb`` (``[capb/64, d]`` bf16), ``_csq`` and ``_bbias``
    (``[capb/64]``); ``block_ids`` its ``_block_ids`` (``None`` for a pad or
    tombstoned slot), ``tuned`` its ``tuned``, ``tombstoned`` its
    ``_tombstoned`` and ``tail`` its pending tail as ``(ids, host_x,
    valid)`` (see :func:`flat_index_from_numpy`) or None. The build is
    current afterwards: the next search probes these blocks."""
    dev = index.device
    xb_t, bcb_t = _block(xb), _block(bcb)
    capb, ngb = xb_t.shape[0], bcb_t.shape[0]
    if capb != 64 * ngb or bcb_t.dtype != torch.bfloat16:
        raise DimensionMismatch(f"xb has {capb} rows for {ngb} bf16 routing centroids")
    rows = {name: torch.from_numpy(_as_f32(a).reshape(-1))
            for name, a in (("xsq", xsq), ("bias", bias), ("csq", csq), ("bbias", bbias))}
    lex_t = torch.from_numpy(np.array(lex, dtype=np.int32).reshape(-1))
    block_ids = [None if i is None else str(i) for i in block_ids]
    for name, t, want in (("xsq", rows["xsq"], capb), ("bias", rows["bias"], capb),
                          ("lex", lex_t, capb), ("csq", rows["csq"], ngb),
                          ("bbias", rows["bbias"], ngb), ("block_ids", block_ids, capb)):
        if len(t) != want:
            raise DimensionMismatch(f"{name} has {len(t)} rows, not {want}")
    slot_of = {id: s for s, id in enumerate(block_ids) if id is not None}
    if any(id not in index._mirror._slot_of for id in slot_of):
        raise InvalidVector("the block ids must be records of the index's mirror")
    index._xb, index._bcb, index._lex = xb_t.to(dev), bcb_t.to(dev), lex_t.to(dev)
    index._xsq, index._bias = rows["xsq"].to(dev), rows["bias"].to(dev)
    index._csq, index._bbias = rows["csq"].to(dev), rows["bbias"].to(dev)
    index._block_ids, index._block_slot_of = block_ids, slot_of
    index._tombstoned = int(tombstoned)
    index._tail = None if tail is None else flat_index_from_numpy(index.metric, *tail,
                                                                   device=dev)
    index.tuned = None if tuned is None else dict(tuned)
    index._built_version = index._version
    index._builds += 1
    return index


def sharded_hnsw_state(mesh, metric, params, ids, *, x, a0, upi, upa, lex, rows, entries,
                       row_of):
    """This package's ``ShardedHnsw`` over a JAX ``ShardedHnsw``'s stacked
    arrays (``_x`` ``[S, cap, d]`` f32, ``_a0`` ``[S, cap, m0]``, ``_upi``
    ``[S, cap]``, ``_upa`` ``[S, U, L, m]``, ``_lex`` and ``_rows``
    ``[S, cap]`` int32, ``_entries`` ``[S, 2]``), its ``ids`` and
    ``_row_of`` (per shard, local slot → global row). Shard ``s`` goes to
    ``mesh.devices[0][s]`` at JAX's stacked shape, so both packages search
    the same graphs; the result only searches (its writes need the shard
    graphs, which the stacked arrays are not)."""
    from .parallel.hnsw_mesh import ShardedHnsw

    arrays = [np.asarray(a) for a in (x, a0, upi, upa, lex, rows, entries)]
    if any(a.shape[0] != mesh.shape["shard"] for a in arrays):
        raise DimensionMismatch(f"the arrays hold other than {mesh.shape['shard']} shards")
    x_np, a0_np, upi_np, upa_np, lex_np, rows_np, entries_np = arrays
    shards = []
    for s in range(mesh.shape["shard"]):
        dev = mesh.devices[0][s]

        def put(a, dtype):
            return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

        shards.append((put(_as_f32(x_np[s]), np.float32), put(a0_np[s], np.int32),
                       put(upi_np[s], np.int32), put(upa_np[s], np.int32),
                       put(lex_np[s], np.int32), put(rows_np[s], np.int32),
                       int(entries_np[s, 0]), int(entries_np[s, 1]), int(upa_np.shape[2])))
    index = ShardedHnsw.from_state(metric, mesh, params, ids, shards)
    index._row_of = [np.array(r, dtype=np.int32) for r in row_of]
    return index


def sharded_ivf_state(mesh, metric, ids, *, x, xsq, bias, lex, rows, bcb, csq, bbias,
                      options=None, tuned=None):
    """This package's ``ShardedIvf`` over a JAX ``ShardedIvf``'s stacked
    arrays: ``_x`` ``[S, capb, d]`` f32 or bf16 (kept in its dtype),
    ``_xsq``, ``_bias``, ``_lex`` and ``_rows`` ``[S, capb]``, ``_bcb``
    ``[S, capb/64, d]`` bf16, ``_csq`` and ``_bbias`` ``[S, capb/64]``, with
    its ``ids``, ``params`` (``options``) and ``tuned``. Shard ``s`` goes to
    ``mesh.devices[0][s]``, so both packages probe the same blocks."""
    from .parallel.ivf_mesh import ShardedIvf

    arrays = {"x": x, "xsq": xsq, "bias": bias, "lex": lex, "rows": rows, "bcb": bcb,
              "csq": csq, "bbias": bbias}
    shards = []
    for s in range(mesh.shape["shard"]):
        dev = mesh.devices[0][s]
        st = {}
        for name, a in arrays.items():
            a = np.asarray(a)
            if a.shape[0] != mesh.shape["shard"]:
                raise DimensionMismatch(f"{name} holds other than {mesh.shape['shard']} shards")
            if name in ("x", "bcb"):
                st[name] = _block(a[s])
            elif name in ("lex", "rows"):
                st[name] = torch.from_numpy(np.array(a[s], dtype=np.int32))
            else:
                st[name] = torch.from_numpy(_as_f32(a[s]))
            st[name] = st[name].to(dev)
        if st["bcb"].dtype != torch.bfloat16 or st["x"].shape[0] != 64 * st["bcb"].shape[0]:
            raise DimensionMismatch("x and the bf16 routing centroids disagree on the blocks")
        shards.append(st)
    return ShardedIvf.from_state(metric, mesh, ids, shards, options=options, tuned=tuned)
