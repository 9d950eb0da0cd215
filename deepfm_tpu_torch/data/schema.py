"""Declarative feature schema: the cross-layer contract.

The port's own copy of ``deepfm_tpu/data/schema.py`` (the port imports
nothing of the JAX package); the text below is the original's.

Models and the embedding engine are constructed purely from a
``DatasetSchema`` — no hard-coded feature names anywhere (reference
contract: deepfm/data/schema.py:7-59). Adapters are the only components
that know dataset-specific columns.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum


class FeatureType(Enum):
    """SPARSE: one categorical id per row. DENSE: one float per row.
    SEQUENCE: a padded list of categorical ids per row (multi-hot)."""

    SPARSE = "sparse"
    DENSE = "dense"
    SEQUENCE = "sequence"


@dataclass(frozen=True)
class FieldSchema:
    """One feature field (reference: deepfm/data/schema.py:13-21).

    ``vocabulary_size`` includes the reserved index 0 (OOV/padding).
    ``max_length``/``combiner`` apply to SEQUENCE fields only.
    """

    name: str
    feature_type: FeatureType
    vocabulary_size: int = 0
    embedding_dim: int = 8
    group: str = ""
    max_length: int = 1
    combiner: str = "mean"


@dataclass(frozen=True)
class DatasetSchema:
    """Ordered collection of fields; iteration order == insertion order
    (reference: deepfm/data/schema.py:24-59)."""

    fields: dict[str, FieldSchema] = field(default_factory=dict)
    label_field: str = "label"

    @property
    def field_names(self) -> list[str]:
        return list(self.fields)

    @property
    def sparse_fields(self) -> list[FieldSchema]:
        return [
            f
            for f in self.fields.values()
            if f.feature_type == FeatureType.SPARSE
        ]

    @property
    def dense_fields(self) -> list[FieldSchema]:
        return [
            f
            for f in self.fields.values()
            if f.feature_type == FeatureType.DENSE
        ]

    @property
    def sequence_fields(self) -> list[FieldSchema]:
        return [
            f
            for f in self.fields.values()
            if f.feature_type == FeatureType.SEQUENCE
        ]

    @property
    def lookup_fields(self) -> list[FieldSchema]:
        """Table-backed fields (SPARSE + SEQUENCE) in schema order."""
        return [
            f
            for f in self.fields.values()
            if f.feature_type != FeatureType.DENSE
        ]

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    @property
    def total_embedding_dim(self) -> int:
        return sum(f.embedding_dim for f in self.fields.values())

    @property
    def total_vocabulary_size(self) -> int:
        return sum(f.vocabulary_size for f in self.lookup_fields)
