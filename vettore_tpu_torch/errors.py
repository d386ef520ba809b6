"""Typed errors for vettore-tpu.

The reference library (elchemista/vettore) returns tagged error tuples such as
``{:error, :invalid_vector}`` at every boundary (see
reference lib/vettore/collection.ex:1077-1262). The idiomatic Python
equivalent is a typed exception hierarchy; every exception carries a stable
machine-readable ``reason`` string that mirrors the reference's atom so tests
and callers can match on it.
"""

from __future__ import annotations


class VettoreError(Exception):
    """Base class for all vettore-tpu errors."""

    reason: str = "error"

    def __init__(self, *args, reason: str | None = None):
        if reason is not None:
            self.reason = reason
        super().__init__(*(args or (self.reason,)))


class InvalidVector(VettoreError):
    reason = "invalid_vector"


class DimensionMismatch(VettoreError):
    reason = "dimension_mismatch"


class MetricOverflow(VettoreError):
    reason = "metric_overflow"


class ScoreOverflow(VettoreError):
    reason = "score_overflow"


class EncodingOverflow(VettoreError):
    reason = "encoding_overflow"


class UnknownMetric(VettoreError):
    reason = "unknown_metric"

    def __init__(self, metric):
        self.metric = metric
        super().__init__(f"unknown metric: {metric!r}")


class UnknownNormalization(VettoreError):
    reason = "unknown_normalization"

    def __init__(self, method):
        self.method = method
        super().__init__(f"unknown normalization: {method!r}")


class InvalidOptions(VettoreError):
    reason = "invalid_options"

    def __init__(self, message="invalid options", *, reason: str | None = None, key=None):
        self.key = key
        super().__init__(message, reason=reason)


class UnsupportedOption(InvalidOptions):
    reason = "unsupported_option"

    def __init__(self, key):
        super().__init__(f"unsupported option: {key!r}", key=key)


class DuplicateOption(InvalidOptions):
    reason = "duplicate_option"

    def __init__(self, key):
        super().__init__(f"duplicate option: {key!r}", key=key)


class InvalidDimensions(VettoreError):
    reason = "invalid_dimensions"


class InvalidMetric(VettoreError):
    reason = "invalid_metric"


class InvalidNormalization(VettoreError):
    reason = "invalid_normalization"


class InvalidScoreMode(VettoreError):
    reason = "invalid_score_mode"


class InvalidIndexOptions(VettoreError):
    reason = "invalid_index_options"


class InvalidHnswOptions(VettoreError):
    reason = "invalid_hnsw_options"


class InvalidFlatOptions(VettoreError):
    reason = "invalid_flat_options"


class UnsupportedFlatMetric(VettoreError):
    reason = "unsupported_flat_metric"

    def __init__(self, metric):
        self.metric = metric
        super().__init__(f"unsupported flat metric: {metric!r}")


class InvalidSearchOptions(VettoreError):
    reason = "invalid_search_options"


class UnsupportedHnswMetric(VettoreError):
    reason = "unsupported_hnsw_metric"

    def __init__(self, metric):
        self.metric = metric
        super().__init__(f"unsupported hnsw metric: {metric!r}")


class InvalidIvfOptions(VettoreError):
    reason = "invalid_ivf_options"


class UnsupportedIvfMetric(VettoreError):
    reason = "unsupported_ivf_metric"

    def __init__(self, metric):
        self.metric = metric
        super().__init__(f"unsupported ivf metric: {metric!r}")


class InvalidStore(VettoreError):
    reason = "invalid_store"


class InvalidIndex(VettoreError):
    reason = "invalid_index"


class InvalidEmbedding(VettoreError):
    reason = "invalid_embedding"


class InvalidMultiVector(VettoreError):
    reason = "invalid_multi_vector"


class InvalidBinaryVector(VettoreError):
    reason = "invalid_binary_vector"


class MissingId(VettoreError):
    reason = "missing_id"


class DuplicateId(VettoreError):
    reason = "duplicate_id"


class NotFound(VettoreError):
    reason = "not_found"


class Closed(VettoreError):
    reason = "closed"


class InvalidLimit(VettoreError):
    reason = "invalid_limit"


class InvalidCandidates(VettoreError):
    reason = "invalid_candidates"


class InvalidStages(VettoreError):
    reason = "invalid_stages"


class InvalidGenerator(VettoreError):
    reason = "invalid_generator"

    def __init__(self, generator):
        self.generator = generator
        super().__init__(f"invalid generator: {generator!r}")


class UnknownGenerator(VettoreError):
    reason = "unknown_generator"

    def __init__(self, generator):
        self.generator = generator
        super().__init__(f"unknown generator: {generator!r}")


class InvalidRerank(VettoreError):
    reason = "invalid_rerank"

    def __init__(self, rerank):
        self.rerank = rerank
        super().__init__(f"invalid rerank: {rerank!r}")


class HnswIndexRequired(VettoreError):
    reason = "hnsw_index_required"


class InvalidSnapshot(VettoreError):
    reason = "invalid_snapshot"


class InvalidSnapshotRecord(VettoreError):
    reason = "invalid_snapshot_record"

    def __init__(self, inner_reason):
        self.inner_reason = inner_reason
        super().__init__(f"invalid snapshot record: {inner_reason}")


class UnsupportedSnapshotVersion(VettoreError):
    reason = "unsupported_snapshot_version"


class UnsupportedSnapshotOverride(VettoreError):
    reason = "unsupported_snapshot_override"

    def __init__(self, key):
        self.key = key
        super().__init__(f"unsupported snapshot override: {key!r}")


class InvalidMmrArgs(VettoreError):
    reason = "invalid_mmr_args"


class InvalidMuveraConfig(VettoreError):
    reason = "invalid_muvera_config"

    def __init__(self, message="invalid muvera config"):
        super().__init__(message)


class IndexRestoreFailed(VettoreError):
    """Raised when a store delete failed AND restoring the index entry failed.

    Mirrors ``{:error, {:index_restore_failed, store_reason, index_reason}}``
    (reference lib/vettore/collection.ex:496-502).
    """

    reason = "index_restore_failed"

    def __init__(self, store_reason, index_reason):
        self.store_reason = store_reason
        self.index_reason = index_reason
        super().__init__(f"index restore failed: store={store_reason}, index={index_reason}")
