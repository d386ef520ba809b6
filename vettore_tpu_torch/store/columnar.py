"""Compact columnar record store.

The host analog of the reference's ``:compressed`` ETS tables
(reference lib/vettore/store/ets.ex:273-282): canonical records live
in contiguous column blocks — one [cap, d] vector matrix, one [cap, words]
packed sign matrix — instead of one Python object per record, so a
1M x 768 collection's canonical state costs the vector block (2.86 GiB
f32, 1.43 GiB bf16) plus megabytes, not gigabytes, of bookkeeping.
The port of ``vettore_tpu/store/columnar.py``: host code only, unchanged.

Concurrency follows the same ETS-shaped discipline as ``MemoryStore``
(store/memory.py): writes serialize through one lock, reads are lock-free
against an immutable state snapshot — every mutation builds fresh maps,
writes fresh block rows, and swaps ONE state object, so a reader holding
the previous state sees a consistent store forever. Deleted and replaced
rows are never overwritten in place (hydrated views stay valid); their
slots are tombstoned and the blocks compact once dead slots outnumber
live ones.

``dtype="bf16"`` stores vector halves (u16) and hydrates by widening —
exactly the rounding the compressed collections' bf16 device block scores
with, so host oracle and device agree on what the stored vector is.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

import numpy as np

from ..embedding import Embedding
from ..errors import Closed, DuplicateId, InvalidSnapshot, NotFound
from .base import Store
from .snapshot import load_snapshot as _load_file
from .snapshot import save_snapshot as _save_file

CONFIG_KEY = "__config__"

_GROW = 4096


class _State:
    """One immutable snapshot of the store (readers hold it lock-free)."""

    __slots__ = ("slot_of", "block", "packed", "has_packed", "values",
                 "meta", "mv", "odd", "d", "words", "used", "dead")

    def __init__(self, slot_of, block, packed, has_packed, values, meta, mv,
                 odd, d, words, used, dead):
        self.slot_of = slot_of      # id -> slot (immutable dict)
        self.block = block          # [cap, d] f32 or u16 halves
        self.packed = packed        # [cap, words] u64
        self.has_packed = has_packed  # [cap] bool
        self.values = values        # slot -> value (only when value != id)
        self.meta = meta            # slot -> metadata (only when not None)
        self.mv = mv                # slot -> multi-vector list
        self.odd = odd              # slot -> whole Embedding (shape misfits)
        self.d = d
        self.words = words
        self.used = used            # high-water slot mark
        self.dead = dead            # tombstoned slot count


def _empty_state():
    return _State({}, None, None, None, {}, {}, {}, {}, None, None, 0, 0)


class ColumnarStore(Store):
    """Store behaviour over column blocks; see module docstring."""

    def __init__(self, config: dict | None = None, *, dtype: str = "f32"):
        if dtype not in ("f32", "bf16"):
            raise ValueError(f"columnar dtype must be f32|bf16: {dtype!r}")
        self._dtype = dtype
        self._config: dict = dict(config or {})
        self._lock = threading.RLock()
        self._closed = False
        self._state = _empty_state()

    # -- lifecycle ----------------------------------------------------------

    def alive(self) -> bool:
        return not self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._state = _empty_state()

    def _ensure_open(self):
        if self._closed:
            raise Closed("store is closed")

    # -- hydration ----------------------------------------------------------

    def _narrow(self, rows: np.ndarray) -> np.ndarray:
        if self._dtype == "f32":
            return np.ascontiguousarray(rows, dtype=np.float32)
        from ..ops.transport import round_to_bf16

        f32 = round_to_bf16(np.ascontiguousarray(rows, dtype=np.float32))
        return (f32.view(np.uint32) >> 16).astype(np.uint16)

    def _widen(self, row: np.ndarray) -> np.ndarray:
        if self._dtype == "f32":
            return row
        return (row.astype(np.uint32) << 16).view(np.float32)

    def _hydrate(self, st: _State, id: str, slot: int) -> Embedding:
        if slot in st.odd:
            return st.odd[slot]
        return Embedding(
            id=id,
            value=st.values.get(slot, id),
            vector=self._widen(st.block[slot]),
            vectors=st.mv.get(slot),
            binary_vector=st.packed[slot] if st.has_packed[slot] else None,
            metadata=st.meta.get(slot),
        )

    # -- reads (lock-free against one state snapshot) ------------------------

    def get(self, id: str) -> Embedding:
        self._ensure_open()
        st = self._state
        slot = st.slot_of.get(id)
        if slot is None:
            raise NotFound(f"id not found: {id!r}")
        return self._hydrate(st, id, slot)

    def all(self) -> list:
        self._ensure_open()
        st = self._state
        return [self._hydrate(st, id, slot) for id, slot in st.slot_of.items()]

    def fold(self, fn: Callable, acc: Any) -> Any:
        self._ensure_open()
        st = self._state
        for id, slot in st.slot_of.items():
            acc = fn(self._hydrate(st, id, slot), acc)
        return acc

    def count(self) -> int:
        self._ensure_open()
        return len(self._state.slot_of)

    def config(self) -> dict:
        self._ensure_open()
        return dict(self._config)

    # -- writes (serialized) --------------------------------------------------

    def put(self, embedding: Embedding) -> None:
        self.put_many([embedding])

    def put_many(self, embeddings: Iterable[Embedding]) -> None:
        """Atomic batch insert: duplicate ids (existing or intra-batch)
        reject the whole batch before any mutation (store/ets.ex:100-111)."""
        batch = list(embeddings)
        with self._lock:
            self._ensure_open()
            st = self._state
            seen = set()
            for e in batch:
                if e.id in st.slot_of or e.id in seen:
                    raise DuplicateId(f"duplicate id: {e.id!r}")
                seen.add(e.id)
            self._state = self._write(st, batch, replace=False)

    def replace(self, embedding: Embedding) -> None:
        """Insert-or-replace (index-restore rollback paths)."""
        with self._lock:
            self._ensure_open()
            st = self._state
            dead = st.dead + (1 if embedding.id in st.slot_of else 0)
            nxt = self._write(st, [embedding], replace=True)
            nxt.dead = dead
            self._state = self._maybe_compact(nxt)

    def delete(self, id: str) -> None:
        with self._lock:
            self._ensure_open()
            st = self._state
            slot = st.slot_of.get(id)
            if slot is None:
                return
            slot_of = dict(st.slot_of)
            del slot_of[id]
            nxt = _State(slot_of, st.block, st.packed, st.has_packed,
                         st.values, st.meta, st.mv, st.odd, st.d, st.words,
                         st.used, st.dead + 1)
            self._state = self._maybe_compact(nxt)

    def configure(self, config: dict) -> None:
        with self._lock:
            self._ensure_open()
            self._config = dict(config)

    # -- internals ------------------------------------------------------------

    def _write(self, st: _State, batch: list, *, replace: bool) -> _State:
        """Appends ``batch`` into fresh tail slots and returns the new state.
        Existing block rows are NEVER overwritten (hydrated views stay
        valid); replaced ids just point at their new slot."""
        need = st.used + len(batch)
        d, words = st.d, st.words
        for e in batch:
            if d is None and e.vector is not None:
                v = np.asarray(e.vector)
                if v.ndim == 1 and v.size:
                    d = int(v.size)
        if d is not None and words is None:
            words = (d + 63) // 64

        block, packed, has_packed = st.block, st.packed, st.has_packed
        cap = 0 if block is None else block.shape[0]
        if d is not None and (block is None or need > cap or
                              block.shape[1] != d):
            new_cap = max(_GROW, ((need + _GROW - 1) // _GROW) * _GROW)
            bdt = np.float32 if self._dtype == "f32" else np.uint16
            nb = np.zeros((new_cap, d), dtype=bdt)
            npk = np.zeros((new_cap, words), dtype=np.uint64)
            nhp = np.zeros(new_cap, dtype=bool)
            if block is not None and block.shape[1] == d:
                nb[:st.used] = block[:st.used]
                npk[:st.used, :packed.shape[1]] = packed[:st.used]
                nhp[:st.used] = has_packed[:st.used]
            block, packed, has_packed = nb, npk, nhp

        slot_of = dict(st.slot_of)
        values = dict(st.values)
        meta = dict(st.meta)
        mv = dict(st.mv)
        odd = dict(st.odd)
        used, dead = st.used, st.dead

        for e in batch:
            slot = used
            used += 1
            old = slot_of.get(e.id) if replace else None
            if old is not None:
                for m in (values, meta, mv, odd):
                    m.pop(old, None)
            v = None if e.vector is None else np.asarray(e.vector)
            fits = (
                v is not None and v.ndim == 1 and d is not None
                and v.size == d and block is not None
            )
            if fits:
                block[slot] = self._narrow(v[None, :])[0]
                if e.binary_vector is not None:
                    w = np.asarray(e.binary_vector, dtype=np.uint64)
                    if w.ndim == 1 and w.size == words:
                        packed[slot] = w
                        has_packed[slot] = True
                    else:  # nonstandard word count: keep the record whole
                        odd[slot] = e
                        block[slot] = 0
                        has_packed[slot] = False
            else:
                odd[slot] = e
            if slot not in odd:
                if e.value is not None and e.value != e.id:
                    values[slot] = e.value
                if e.metadata is not None:
                    meta[slot] = e.metadata
                if e.vectors is not None:
                    mv[slot] = e.vectors
            slot_of[e.id] = slot

        return _State(slot_of, block, packed, has_packed, values, meta, mv,
                      odd, d, words, used, dead)

    def _maybe_compact(self, st: _State) -> _State:
        if st.block is None or st.dead <= max(_GROW, len(st.slot_of)):
            return st
        live = sorted(st.slot_of.items(), key=lambda kv: kv[1])
        cap = max(_GROW, ((len(live) + _GROW - 1) // _GROW) * _GROW)
        block = np.zeros((cap, st.d), dtype=st.block.dtype)
        packed = np.zeros((cap, st.words), dtype=np.uint64)
        has_packed = np.zeros(cap, dtype=bool)
        slot_of, values, meta, mv, odd = {}, {}, {}, {}, {}
        for new, (id, old) in enumerate(live):
            slot_of[id] = new
            if old in st.odd:
                odd[new] = st.odd[old]
                continue
            block[new] = st.block[old]
            packed[new] = st.packed[old]
            has_packed[new] = st.has_packed[old]
            if old in st.values:
                values[new] = st.values[old]
            if old in st.meta:
                meta[new] = st.meta[old]
            if old in st.mv:
                mv[new] = st.mv[old]
        return _State(slot_of, block, packed, has_packed, values, meta, mv,
                      odd, st.d, st.words, len(live), 0)

    # -- snapshot --------------------------------------------------------------

    def snapshot(self, path: str) -> None:
        self._ensure_open()
        _save_file(path, dict(self._config), self.all())

    @classmethod
    def load_snapshot(cls, path: str, *, dtype: str | None = None):
        """Returns ``(store, config)`` like ``MemoryStore.load_snapshot``;
        ``dtype`` defaults to bf16 exactly when the snapshot's collection is
        compressed (the same coupling ``Collection`` applies at creation)."""
        config, records = _load_file(path)
        if not isinstance(config, dict):
            raise InvalidSnapshot("snapshot config must be a map")
        if dtype is None:
            dtype = "bf16" if config.get("compressed") else "f32"
        store = cls(config, dtype=dtype)
        store.put_many(records)
        return store, config
