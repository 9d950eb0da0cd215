"""Packed TPU batch layout: width-grouped fused tables, one 2-D id matrix.

The port's own copy of ``deepfm_tpu/data/packing.py`` (the port imports
nothing of the JAX package); the text below is the original's.

The reference feeds models a dict of per-field tensors and loops over
fields inside the embedding layer (reference:
deepfm/models/layers/embedding.py:83-115 — 16 gathers + projections per
batch). That layout is hostile to TPUs: many small gathers, dynamic dict
structure, no fusion. Here the schema is compiled ONCE into a static
``PackedSchema``:

  * every table-backed field (SPARSE/SEQUENCE) of the same embedding width
    shares one fused table; per-field row offsets turn all lookups of that
    width into a single wide gather;
  * the batch is two arrays — ``ids (B, num_slots) int32`` and
    ``dense (B, num_dense) float32`` — with a fixed slot->field mapping
    (a SEQUENCE field owns ``max_length`` consecutive slots);
  * each field's first-order scalar weight rides as the LAST COLUMN of
    its width group's fused table (see ops/embedding.py), so one gather
    serves both views. ``fo_rows``/``fo_offsets`` describe the flat
    group-ordered vocab index space (used by tests and diagnostics).

Everything downstream (models, optimizer, sharding) keys off this object,
so the hot path never touches Python dicts or per-field loops.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType


@dataclass(frozen=True)
class LookupGroup:
    """All table-backed fields sharing one embedding width.

    Slots are the columns of the packed id matrix owned by this group:
    ``slot_start:slot_end``. A SPARSE member owns one slot; a SEQUENCE
    member owns ``max_length`` consecutive slots.
    """

    width: int
    field_names: list[str]
    slot_start: int
    slot_end: int
    # (num_slots_in_group,) row offset of each slot's field inside the
    # fused (total_rows, width) table.
    local_offsets: np.ndarray
    total_rows: int
    # (num_slots_in_group,) index of each slot's field within field_names.
    slot_field: np.ndarray
    # per-field flags/sizes, aligned with field_names
    is_sequence: list[bool]
    combiners: list[str]
    field_num_slots: list[int]


@dataclass(frozen=True)
class DenseGroup:
    """Dense fields sharing one embedding width; they own columns
    ``col_start:col_end`` of the packed dense matrix."""

    width: int
    field_names: list[str]
    col_start: int
    col_end: int


@dataclass(frozen=True)
class PackedSchema:
    schema: DatasetSchema
    lookup_groups: list[LookupGroup]
    dense_groups: list[DenseGroup]
    num_slots: int
    num_dense: int
    # fused first-order table: one row per vocab entry of every lookup
    # field, regions laid out in GROUP order.
    fo_rows: int
    # (num_slots,) offset of each slot's field region in the fo table.
    fo_offsets: np.ndarray
    # schema field order, for assembling the (B, F, d) / flat views.
    field_order: list[str]

    @property
    def num_fields(self) -> int:
        return len(self.field_order)


@dataclass
class PackedArrays:
    """Device-ready batch/epoch arrays (host NumPy until staged)."""

    ids: np.ndarray  # (N, num_slots) int32
    dense: np.ndarray  # (N, num_dense) float32
    labels: np.ndarray  # (N,) float32
    weights: np.ndarray  # (N,) float32; 0 marks padded rows
    user_ids: np.ndarray | None = None  # (N,) int64, for ranking groups

    def __len__(self) -> int:
        return self.ids.shape[0]


def pack_schema(schema: DatasetSchema) -> PackedSchema:
    """Compile a DatasetSchema into the static packed layout.

    Groups are ordered by ascending width (deterministic for any field
    ordering); fields keep schema insertion order within a group.
    """
    # ---- lookup groups ------------------------------------------------
    by_width: dict[int, list] = {}
    for f in schema.lookup_fields:
        by_width.setdefault(f.embedding_dim, []).append(f)

    lookup_groups: list[LookupGroup] = []
    slot_cursor = 0
    fo_cursor = 0
    fo_offsets_parts: list[np.ndarray] = []
    for width in sorted(by_width):
        members = by_width[width]
        local_offsets: list[int] = []
        slot_field: list[int] = []
        fo_offs: list[int] = []
        field_num_slots: list[int] = []
        row_cursor = 0
        slot_start = slot_cursor
        for fi, f in enumerate(members):
            n_slots = f.max_length if f.feature_type == FeatureType.SEQUENCE else 1
            local_offsets.extend([row_cursor] * n_slots)
            slot_field.extend([fi] * n_slots)
            fo_offs.extend([fo_cursor] * n_slots)
            field_num_slots.append(n_slots)
            row_cursor += f.vocabulary_size
            fo_cursor += f.vocabulary_size
            slot_cursor += n_slots
        lookup_groups.append(
            LookupGroup(
                width=width,
                field_names=[f.name for f in members],
                slot_start=slot_start,
                slot_end=slot_cursor,
                local_offsets=np.asarray(local_offsets, np.int32),
                total_rows=row_cursor,
                slot_field=np.asarray(slot_field, np.int32),
                is_sequence=[
                    f.feature_type == FeatureType.SEQUENCE for f in members
                ],
                combiners=[f.combiner for f in members],
                field_num_slots=field_num_slots,
            )
        )
        fo_offsets_parts.append(np.asarray(fo_offs, np.int32))

    fo_offsets = (
        np.concatenate(fo_offsets_parts)
        if fo_offsets_parts
        else np.zeros((0,), np.int32)
    )

    # ---- dense groups ---------------------------------------------------
    dense_by_width: dict[int, list] = {}
    for f in schema.dense_fields:
        dense_by_width.setdefault(f.embedding_dim, []).append(f)
    dense_groups: list[DenseGroup] = []
    col_cursor = 0
    for width in sorted(dense_by_width):
        members = dense_by_width[width]
        dense_groups.append(
            DenseGroup(
                width=width,
                field_names=[f.name for f in members],
                col_start=col_cursor,
                col_end=col_cursor + len(members),
            )
        )
        col_cursor += len(members)

    return PackedSchema(
        schema=schema,
        lookup_groups=lookup_groups,
        dense_groups=dense_groups,
        num_slots=slot_cursor,
        num_dense=col_cursor,
        fo_rows=fo_cursor,
        fo_offsets=fo_offsets,
        field_order=schema.field_names,
    )


def pack_features(
    packed: PackedSchema,
    features: dict[str, np.ndarray],
    labels: np.ndarray,
) -> PackedArrays:
    """Pack a reference-layout feature dict into the TPU batch layout.

    ``features`` maps field name -> (N,) codes / (N, max_length) sequence
    codes / (N,) floats. Extra keys are ignored; a ``user_id`` key (alias
    or schema field) populates ``user_ids`` for per-user ranking metrics.
    """
    labels = np.asarray(labels, np.float32)
    n = labels.shape[0]

    ids = np.zeros((n, packed.num_slots), np.int32)
    for group in packed.lookup_groups:
        col = group.slot_start
        for name, is_seq in zip(group.field_names, group.is_sequence):
            arr = np.asarray(features[name])
            if is_seq:
                w = arr.shape[1]
                ids[:, col : col + w] = arr
                col += w
            else:
                ids[:, col] = arr
                col += 1

    dense = np.zeros((n, packed.num_dense), np.float32)
    for group in packed.dense_groups:
        for off, name in enumerate(group.field_names):
            dense[:, group.col_start + off] = np.asarray(
                features[name], np.float32
            )

    user_ids = None
    if "user_id" in features:
        user_ids = np.asarray(features["user_id"], np.int64)

    return PackedArrays(
        ids=ids,
        dense=dense,
        labels=labels,
        weights=np.ones(n, np.float32),
        user_ids=user_ids,
    )
