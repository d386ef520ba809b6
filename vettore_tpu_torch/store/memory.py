"""In-memory canonical record store.

The equivalent of the ETS store + owner process
(reference lib/vettore/store/ets.ex, lib/vettore/ets_owner.ex): writes
are serialized through a single lock (the owner-GenServer role), reads are
lock-free against immutable snapshots (the protected-table,
``read_concurrency`` role — readers never wait on a writer), a batch insert is
atomic (all ids checked before any mutation, ets_owner.ex:91-92), and a closed
store answers every call with ``Closed`` (ets_owner.ex:177-186).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable

from ..embedding import Embedding
from ..errors import Closed, DuplicateId, NotFound
from .base import Store
from .snapshot import load_snapshot as _load_file
from .snapshot import save_snapshot as _save_file

CONFIG_KEY = "__config__"


class MemoryStore(Store):
    def __init__(self, config: dict | None = None):
        # _records is replaced wholesale on every mutation (copy-on-write), so
        # concurrent readers always see a consistent dict without locking —
        # the same guarantee ETS protected tables give concurrent readers.
        self._records: dict[str, Embedding] = {}
        self._config: dict = dict(config or {})
        self._lock = threading.RLock()
        self._closed = False

    # -- lifecycle ----------------------------------------------------------

    def alive(self) -> bool:
        return not self._closed

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._records = {}

    def _ensure_open(self):
        if self._closed:
            raise Closed("store is closed")

    # -- reads (lock-free) --------------------------------------------------

    def get(self, id: str) -> Embedding:
        self._ensure_open()
        record = self._records.get(id)
        if record is None:
            raise NotFound(f"id not found: {id!r}")
        return record

    def all(self) -> list:
        self._ensure_open()
        return list(self._records.values())

    def fold(self, fn: Callable, acc: Any) -> Any:
        self._ensure_open()
        for record in self._records.values():
            acc = fn(record, acc)
        return acc

    def count(self) -> int:
        self._ensure_open()
        return len(self._records)

    def config(self) -> dict:
        self._ensure_open()
        return dict(self._config)

    # -- writes (serialized) ------------------------------------------------

    def put(self, embedding: Embedding) -> None:
        self.put_many([embedding])

    def put_many(self, embeddings: Iterable[Embedding]) -> None:
        """Atomic batch insert: duplicate ids (existing or within the batch)
        reject the whole batch before any mutation — the `insert_new`
        semantics of reference lib/vettore/store/ets.ex:100-111."""
        batch = list(embeddings)
        with self._lock:
            self._ensure_open()
            current = self._records
            seen = set()
            for e in batch:
                if e.id in current or e.id in seen:
                    raise DuplicateId(f"duplicate id: {e.id!r}")
                seen.add(e.id)
            updated = dict(current)
            for e in batch:
                updated[e.id] = e
            self._records = updated

    def replace(self, embedding: Embedding) -> None:
        """Insert-or-replace (used by index-restore rollback paths)."""
        with self._lock:
            self._ensure_open()
            updated = dict(self._records)
            updated[embedding.id] = embedding
            self._records = updated

    def delete(self, id: str) -> None:
        with self._lock:
            self._ensure_open()
            if id in self._records:
                updated = dict(self._records)
                del updated[id]
                self._records = updated

    def configure(self, config: dict) -> None:
        with self._lock:
            self._ensure_open()
            self._config = dict(config)

    # -- persistence --------------------------------------------------------

    def snapshot(self, path: str) -> None:
        self._ensure_open()
        # Capture one consistent view; writers may proceed concurrently.
        records = list(self._records.values())
        _save_file(path, self._config, records)

    @classmethod
    def load_snapshot(cls, path: str):
        """Returns ``(store, config)``; the caller validates config/records and
        rebuilds indexes (collection.ex:146-164,426-433)."""
        config, records = _load_file(path)
        store = cls(config)
        store._records = {r.id: r for r in records}
        return store, config
