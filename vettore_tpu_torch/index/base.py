"""Index contract.

Mirrors the ``Vettore.Index`` behaviour (reference lib/vettore/index.ex:
12-17): ``new/put/put_many/delete/search``. Indexes hold only ids and vectors
(acceleration state); the canonical store owns records. ``search`` returns
``[(external_id, raw_metric_value)]`` — hydration into Results happens at the
collection layer.
"""

from __future__ import annotations

import abc
from typing import Iterable, Tuple

REQUIRED_INDEX_METHODS = ("put", "put_many", "delete", "search")


class Index(abc.ABC):
    metric: str

    @abc.abstractmethod
    def put(self, id: str, vector) -> None: ...

    @abc.abstractmethod
    def put_many(self, pairs: Iterable[Tuple[str, list]]) -> None: ...

    @abc.abstractmethod
    def delete(self, id: str) -> None: ...

    @abc.abstractmethod
    def search(self, query, limit: int) -> list: ...


def valid_index(obj) -> bool:
    return all(callable(getattr(obj, name, None)) for name in REQUIRED_INDEX_METHODS)
