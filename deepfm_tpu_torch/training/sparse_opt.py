"""Per-table Adam moments of the fused table paths.

Port of ``deepfm_tpu/training/sparse_opt.py`` :: ``TableSlotState`` /
``init_table_state``. The row-sparse ``lazy_adam`` update of that module
is not ported yet (ROADMAP queue 1 item 6); the trainer refuses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TableSlotState(NamedTuple):
    mu: torch.Tensor  # shaped like the table: (rows, d+1) or packed (phys, 128)
    nu: torch.Tensor


def init_table_state(
    table: torch.Tensor, moments_dtype: torch.dtype | None = None
) -> TableSlotState:
    """Zero Adam moments for one table on its device, in the table's layout
    (a packed table's dead lanes get moments that stay 0); ``moments_dtype``
    overrides the storage type (``training.moments_dtype``: bf16 halves the
    moments' share of the bytes the table update moves; the math stays
    f32 in the kernels)."""
    dt = table.dtype if moments_dtype is None else moments_dtype
    return TableSlotState(
        mu=torch.zeros(table.shape, dtype=dt, device=table.device),
        nu=torch.zeros(table.shape, dtype=dt, device=table.device),
    )
