"""Snapshot file format: atomic, checksummed, schema-validated.

Equivalent of the reference's ETS snapshot subsystem
(reference lib/vettore/store/ets.ex:29-56,181-229): writes go to a
same-directory temporary file followed by an atomic rename, the payload
carries an integrity checksum that is verified on load, and every stored
record is re-validated before an index is rebuilt from it.

Layout: ``b"VETTORE-TPU-SNAP1\\n"`` magic, 16-byte MD5 of the remainder, then
an ``.npz`` archive holding config JSON, ids, values/metadata JSON, the dense
vector matrix, flattened multi-vectors, and packed binary vectors.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile

import numpy as np

from ..embedding import Embedding
from ..errors import InvalidSnapshot

MAGIC = b"VETTORE-TPU-SNAP1\n"


def _records_payload(records: list[Embedding]):
    n = len(records)
    ids = np.array([r.id for r in records], dtype=object)
    try:
        values_json = json.dumps([r.value for r in records])
        metadata_json = json.dumps([r.metadata for r in records])
    except (TypeError, ValueError) as exc:
        raise InvalidSnapshot(f"value/metadata not serializable: {exc}") from exc

    dims = len(records[0].vector) if n else 0
    vectors = np.zeros((n, dims), dtype=np.float32)
    mv_counts = np.zeros(n, dtype=np.int64)
    mv_chunks = []
    # per-record presence mask: a file-level "has binary" flag would
    # rehydrate None rows as all-zero vectors and change quantized-search
    # candidates after a round-trip
    binary_mask = np.zeros(n, dtype=np.uint8)
    binary_words = None

    # vectorized fast path for bulk-ingested corpora (ndarray rows, no
    # multi-vectors, uniform uint64 word rows): one concatenate + one stack
    # instead of a million-iteration assignment loop
    if n and all(
        isinstance(r.vector, np.ndarray)
        and r.vector.shape == (dims,)
        and r.vectors is None
        and (r.binary_vector is None or (
            isinstance(r.binary_vector, np.ndarray)
            and r.binary_vector.dtype == np.uint64
            and r.binary_vector.ndim == 1))
        for r in records
    ):
        widths = {r.binary_vector.shape[0] for r in records
                  if r.binary_vector is not None}
        if len(widths) <= 1:
            vectors = np.concatenate(
                [r.vector for r in records], dtype=np.float32
            ).reshape(n, dims)
            w = widths.pop() if widths else 0
            binary_words = np.zeros((n, w), dtype=np.uint64)
            with_bv = [i for i, r in enumerate(records)
                       if r.binary_vector is not None]
            if with_bv and w:
                binary_words[with_bv] = np.stack(
                    [records[i].binary_vector for i in with_bv])
                binary_mask[with_bv] = 1
            mv_flat = np.zeros((0, dims), dtype=np.float32)
            return (ids, values_json, metadata_json, vectors, mv_counts,
                    mv_flat, binary_words, binary_mask)

    for i, r in enumerate(records):
        vectors[i] = np.asarray(r.vector, dtype=np.float32)
        if r.vectors is not None:
            mv_counts[i] = len(r.vectors)
            mv_chunks.append(np.asarray(r.vectors, dtype=np.float32).reshape(len(r.vectors), -1))
        if r.binary_vector is not None:
            if binary_words is None:
                binary_words = np.zeros((n, len(r.binary_vector)), dtype=np.uint64)
            elif len(r.binary_vector) != binary_words.shape[1]:
                raise InvalidSnapshot(
                    f"record {r.id!r} binary_vector has {len(r.binary_vector)} "
                    f"words, expected {binary_words.shape[1]}"
                )
            binary_words[i] = np.array([np.uint64(w) for w in r.binary_vector], dtype=np.uint64)
            binary_mask[i] = 1
    mv_flat = (
        np.concatenate(mv_chunks, axis=0) if mv_chunks else np.zeros((0, dims), dtype=np.float32)
    )
    if binary_words is None:
        binary_words = np.zeros((n, 0), dtype=np.uint64)
    return ids, values_json, metadata_json, vectors, mv_counts, mv_flat, binary_words, binary_mask


def save_snapshot(path: str, config: dict, records: list[Embedding]) -> None:
    (ids, values_json, metadata_json, vectors, mv_counts, mv_flat,
     binary_words, binary_mask) = _records_payload(records)
    try:
        config_json = json.dumps(config)
    except (TypeError, ValueError) as exc:
        raise InvalidSnapshot(f"config not serializable: {exc}") from exc

    buf = io.BytesIO()
    np.savez(
        buf,
        config=np.frombuffer(config_json.encode(), dtype=np.uint8),
        ids=ids.astype(str),
        values=np.frombuffer(values_json.encode(), dtype=np.uint8),
        metadata=np.frombuffer(metadata_json.encode(), dtype=np.uint8),
        vectors=vectors,
        mv_counts=mv_counts,
        mv_flat=mv_flat,
        binary_words=binary_words,
        binary_mask=binary_mask,
        object_count=np.int64(len(records)),
    )
    payload = buf.getvalue()
    digest = hashlib.md5(payload).digest()

    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".vettore-snap-", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(MAGIC)
            f.write(digest)
            f.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_snapshot(path: str):
    """Returns ``(config_dict, records)`` after checksum + schema verification."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as exc:
        raise InvalidSnapshot(f"cannot read snapshot: {exc}") from exc

    if not blob.startswith(MAGIC):
        raise InvalidSnapshot("bad snapshot magic")
    digest, payload = blob[len(MAGIC) : len(MAGIC) + 16], blob[len(MAGIC) + 16 :]
    if hashlib.md5(payload).digest() != digest:
        raise InvalidSnapshot("snapshot checksum mismatch")

    try:
        archive = np.load(io.BytesIO(payload), allow_pickle=False)
        config = json.loads(bytes(archive["config"]).decode())
        ids = [str(x) for x in archive["ids"]]
        values = json.loads(bytes(archive["values"]).decode())
        metadata = json.loads(bytes(archive["metadata"]).decode())
        vectors = archive["vectors"]
        mv_counts = archive["mv_counts"]
        mv_flat = archive["mv_flat"]
        binary_words = archive["binary_words"]
        if "binary_mask" in archive.files:
            binary_mask = archive["binary_mask"]
        else:  # legacy snapshot without per-record mask: presence is per-file
            binary_mask = np.full(
                binary_words.shape[0],
                1 if binary_words.shape[1] > 0 else 0,
                dtype=np.uint8,
            )
        count = int(archive["object_count"])
    except (KeyError, ValueError, json.JSONDecodeError) as exc:
        raise InvalidSnapshot(f"corrupt snapshot payload: {exc}") from exc

    n = len(ids)
    if not (
        count == n
        and len(values) == n
        and len(metadata) == n
        and vectors.shape[0] == n
        and mv_counts.shape[0] == n
        and int(mv_counts.sum()) == mv_flat.shape[0]
        and binary_words.shape[0] == n
        and binary_mask.shape[0] == n
    ):
        raise InvalidSnapshot("snapshot object count mismatch")
    if not isinstance(config, dict):
        raise InvalidSnapshot("snapshot config must be a map")

    records = []
    offset = 0
    for i in range(n):
        t = int(mv_counts[i])
        mv = None
        if t:
            # [t, d] f32 ndarray — the put_tokens storage form, accepted by
            # every consumer
            mv = mv_flat[offset : offset + t]
            offset += t
        records.append(
            Embedding(
                id=ids[i],
                value=values[i],
                # ndarray row views (zero copies): converting a million rows
                # to Python float lists costs minutes and ~25 GB of floats;
                # the insert pipeline stores ndarray rows anyway
                vector=vectors[i],
                vectors=mv,
                binary_vector=(binary_words[i] if binary_mask[i] else None),
                metadata=metadata[i],
            )
        )
    return config, records
