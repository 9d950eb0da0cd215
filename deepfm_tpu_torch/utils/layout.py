"""Embedding-table layout conversion: packed (phys, 128) <-> logical (V, d+1).

Port of ``deepfm_tpu/utils/layout.py``. The packed storage layout keeps
``pack = 128 // dcol`` logical rows per 128-lane physical row: logical row
``r`` lives in physical row ``r // pack``, lanes
``[(r % pack) * dcol, (r % pack + 1) * dcol)``; lanes >= pack*dcol are dead
(zero). Checkpoints record which layout their tables use (``table_layout``
in the checkpoint metadata), and a restore converts between layouts with
these functions, so a packed checkpoint serves under a logical config and
the reverse.

Conversion happens once at checkpoint load/save or when a JAX tree is
carried over, never in the hot path. ``pack_table`` / ``unpack_table``
take a numpy array or a torch tensor and return the same kind. The tree
functions take a parameter mapping in either of two forms: the JAX
package's nested tree (tables under ``params["embedding"][name]``) or the
port's flat ``state_dict`` (tables under ``"embedding.<name>"``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from deepfm_tpu_torch.data.packing import PackedSchema

LANES = 128


def _pad_rows(rows: int, multiple: int = LANES) -> int:
    return -(-rows // multiple) * multiple


def table_specs(packed_schema: PackedSchema) -> dict[str, dict]:
    """Per-table layout geometry, keyed by the table's parameter name.

    Returns name -> {dcol, pack, total_rows, logical_shape, packed_shape}.
    Width groups whose rows are too wide to pack (dcol > 64 -> pack == 1)
    have identical layouts and need no conversion.
    """
    specs: dict[str, dict] = {}
    for group in packed_schema.lookup_groups:
        dcol = group.width + 1
        pack = LANES // dcol
        specs[f"table_w{group.width}"] = {
            "dcol": dcol,
            "pack": pack,
            "total_rows": group.total_rows,
            "logical_shape": (_pad_rows(group.total_rows), dcol),
            "packed_shape": (_pad_rows(-(-group.total_rows // pack)), LANES),
        }
    return specs


def _zeros(like: Any, shape: tuple[int, ...]):
    if isinstance(like, torch.Tensor):
        return torch.zeros(shape, dtype=like.dtype, device=like.device)
    return np.zeros(shape, like.dtype)


def pack_table(logical, dcol: int, pack: int, phys_rows: int):
    """(rows, dcol) logical table -> (phys_rows, 128) packed storage."""
    if not isinstance(logical, torch.Tensor):
        logical = np.asarray(logical)
    n = min(logical.shape[0], phys_rows * pack)
    lines = _zeros(logical, (phys_rows * pack, dcol))
    lines[:n] = logical[:n]
    out = _zeros(logical, (phys_rows, LANES))
    out[:, : pack * dcol] = lines.reshape(phys_rows, pack * dcol)
    return out


def unpack_table(packed, dcol: int, pack: int, logical_rows: int):
    """(phys, 128) packed storage -> (logical_rows, dcol) logical table."""
    if not isinstance(packed, torch.Tensor):
        packed = np.asarray(packed)
    n = min(logical_rows, packed.shape[0] * pack)
    out = _zeros(packed, (logical_rows, dcol))
    out[:n] = packed[:, : pack * dcol].reshape(-1, dcol)[:n]
    return out


def _embedding_leaves(params: Mapping) -> tuple[dict, bool]:
    """(a copy of the mapping that holds the table leaves, nested?)."""
    nested = isinstance(params.get("embedding"), Mapping)
    return dict(params["embedding"] if nested else params), nested


def _key(name: str, nested: bool) -> str:
    return name if nested else f"embedding.{name}"


def convert_table_tree(
    params: Mapping, packed_schema: PackedSchema, to_packed: bool
) -> dict:
    """Convert every embedding-table leaf of a parameter mapping to the
    target layout (no-op for leaves already there). Other leaves pass
    through untouched; the mapping is shallow-copied."""
    specs = table_specs(packed_schema)
    emb, nested = _embedding_leaves(params)
    for name, spec in specs.items():
        key = _key(name, nested)
        if key not in emb or spec["pack"] <= 1:
            continue
        leaf = emb[key]
        shape = tuple(leaf.shape)
        if to_packed and shape == spec["logical_shape"]:
            emb[key] = pack_table(
                leaf, spec["dcol"], spec["pack"], spec["packed_shape"][0]
            )
        elif not to_packed and shape == spec["packed_shape"]:
            emb[key] = unpack_table(
                leaf, spec["dcol"], spec["pack"], spec["logical_shape"][0]
            )
    if not nested:
        return emb
    out = dict(params)
    out["embedding"] = emb
    return out


def tree_layout(params: Mapping, packed_schema: PackedSchema) -> str:
    """Detect the table layout of a parameter mapping: "packed" |
    "logical". Mappings with no packable tables report "logical" (the
    layouts are identical there)."""
    emb, nested = _embedding_leaves(params)
    for name, spec in table_specs(packed_schema).items():
        key = _key(name, nested)
        if key in emb and spec["pack"] > 1:
            shape = tuple(emb[key].shape)
            if shape == spec["packed_shape"]:
                return "packed"
            if shape == spec["logical_shape"]:
                return "logical"
            raise ValueError(
                f"{name}: shape {shape} matches neither packed "
                f"{spec['packed_shape']} nor logical {spec['logical_shape']}"
            )
    return "logical"
