"""Legacy database-style compatibility API.

Mirrors the reference's compat layer (reference lib/vettore.ex:317-684):
a ``DB`` handle owns named collections; helpers wrap the collection API with
the older tuple-flavored results. Compat collections default to
``score="similarity"`` (vettore.ex:358) and accept the extra metric aliases
``binary``→hamming and ``hnsw``→(l2 metric, hnsw index) (vettore.ex:675-680).

The port of ``vettore_tpu/compat.py``. A ``DB``'s collections live on its
``device`` (default ``"cuda"``, which needs a CUDA device; pass
``device="cpu"`` to run on the CPU).
"""

from __future__ import annotations

import threading

from . import errors as E
from .collection import Collection
from .embedding import Embedding
from .index.flat import resolve_device
from .metrics import default_normalize, normalize_metric
from .ops.mmr import mmr_rerank


def _compat_metric(metric):
    if metric == "binary":
        return "hamming"
    return normalize_metric(metric)


class DB:
    """A registry of named compat collections (the ``Vettore.new/0`` handle)."""

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self._collections: dict[str, Collection] = {}
        self._lock = threading.RLock()
        self._closed = False

    def _ensure_open(self):
        if self._closed:
            raise E.Closed("db is closed")

    def create_collection(self, name: str, dimensions: int, metric="cosine", *,
                          index=None, store="memory", normalize=None, score="similarity",
                          index_options=None, compressed=False) -> str:
        if not isinstance(name, str):
            raise E.VettoreError("invalid arguments", reason="invalid_arguments")
        metric = _compat_metric(metric)
        if index is None:
            index = "hnsw" if metric == "hnsw" else "flat"
        if metric == "hnsw":
            metric = "l2"
        with self._lock:
            self._ensure_open()
            if name in self._collections:
                raise E.VettoreError(
                    f"collection already exists: {name!r}", reason="collection_already_exists"
                )
            collection = Collection(
                name=name,
                dimensions=dimensions,
                metric=metric,
                normalize=normalize if normalize is not None else default_normalize(metric),
                store=store,
                index=index,
                index_options=index_options,
                score=score,
                compressed=compressed,
                device=self.device,
            )
            self._collections[name] = collection
        return name

    def delete_collection(self, name: str) -> str:
        with self._lock:
            self._ensure_open()
            collection = self._collections.pop(name, None)
        if collection is None:
            raise E.VettoreError(
                f"collection not found: {name!r}", reason="collection_not_found"
            )
        collection.close()
        return name

    def _fetch(self, name: str) -> Collection:
        self._ensure_open()
        collection = self._collections.get(name)
        if collection is None:
            raise E.VettoreError(
                f"collection not found: {name!r}", reason="collection_not_found"
            )
        return collection

    def collection(self, name: str) -> Collection:
        return self._fetch(name)

    def insert(self, collection_name: str, embedding) -> str:
        collection = self._fetch(collection_name)
        emb = Embedding.from_input(embedding)
        collection.put(emb)
        return emb.id or emb.value

    def batch(self, collection_name: str, embeddings) -> list:
        collection = self._fetch(collection_name)
        prepared = [Embedding.from_input(e) for e in embeddings]
        collection.put_many(prepared)
        return [e.id or e.value for e in prepared]

    def get_by_value(self, collection_name: str, id: str) -> Embedding:
        return self._fetch(collection_name).get(id)

    def get_by_vector(self, collection_name: str, vector) -> Embedding:
        """Finds the first record whose stored (normalized) vector equals the
        prepared query vector (vettore.ex:508-524)."""
        import numpy as np

        collection = self._fetch(collection_name)
        prepared = collection.prepare_query(vector)
        for embedding in collection.all():
            if np.array_equal(np.asarray(embedding.vector, np.float32), prepared):
                return embedding
        raise E.NotFound("no embedding matches the vector")

    def delete(self, collection_name: str, id: str) -> str:
        self._fetch(collection_name).delete(id)
        return id

    def get_all(self, collection_name: str) -> list:
        """Returns legacy ``(id, vector, metadata)`` tuples."""
        return [
            (e.id, [float(v) for v in e.vector], e.metadata)
            for e in self._fetch(collection_name).all()
        ]

    def similarity_search(self, collection_name: str, query, *, limit=10) -> list:
        """Returns legacy ``(id, score)`` tuples."""
        results = self._fetch(collection_name).search(query, limit=limit)
        return [(r.id, r.score) for r in results]

    def rerank(self, collection_name: str, initial, *, limit=10, alpha=0.5) -> list:
        """MMR rerank over the full stored collection (vettore.ex:622-642)."""
        collection = self._fetch(collection_name)
        pairs = [(e.id, [float(v) for v in e.vector]) for e in collection.all()]
        return mmr_rerank(list(initial), pairs, collection.metric, alpha, limit)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            collections = list(self._collections.values())
            self._collections = {}
        for collection in collections:
            collection.close()
