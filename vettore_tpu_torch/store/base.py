"""Store contract.

Mirrors the ``Vettore.Store`` behaviour callbacks
(reference lib/vettore/store.ex:15-29): new, put, put_many, get, delete,
all, fold, count, snapshot, load_snapshot, configure, close, alive.
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Iterable

from ..embedding import Embedding

REQUIRED_STORE_METHODS = (
    "put",
    "put_many",
    "get",
    "delete",
    "all",
    "snapshot",
)


class Store(abc.ABC):
    """Canonical record store. A custom store only needs the methods in
    ``REQUIRED_STORE_METHODS`` plus a ``load_snapshot`` classmethod (mirroring
    the reference's behaviour-callback check,
    reference lib/vettore/collection.ex:62-71,1272-1298)."""

    @abc.abstractmethod
    def put(self, embedding: Embedding) -> None: ...

    @abc.abstractmethod
    def put_many(self, embeddings: Iterable[Embedding]) -> None: ...

    @abc.abstractmethod
    def get(self, id: str) -> Embedding: ...

    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    @abc.abstractmethod
    def all(self) -> list: ...

    def fold(self, fn: Callable, acc: Any) -> Any:
        for embedding in self.all():
            acc = fn(embedding, acc)
        return acc

    def count(self) -> int:
        return len(self.all())

    @abc.abstractmethod
    def snapshot(self, path: str) -> None: ...

    @classmethod
    def load_snapshot(cls, path: str):
        raise NotImplementedError

    def configure(self, config: dict) -> None:
        return None

    def close(self) -> None:
        return None

    def alive(self) -> bool:
        return True


def valid_store(obj) -> bool:
    return all(callable(getattr(obj, name, None)) for name in REQUIRED_STORE_METHODS)
