"""Per-table Adam moments, and the row-sparse ("lazy") Adam of
``training.optimizer: lazy_adam``.

Port of ``deepfm_tpu/training/sparse_opt.py``: ``TableSlotState`` /
``init_table_state`` (the moments of every fused table path), and
``dedupe_ids``, ``lazy_adam_table_update`` and ``table_ids_for_batch``
(the lazy path of ``training/steps.py``):

  * autograd produces the dense table gradient through the lookup's
    backward (the densify kernels on the card), duplicate ids already
    summed;
  * the update gathers only the rows the batch names, applies Adam with
    global-step bias correction, and writes the new rows back, one update
    per distinct id (``dedupe_ids``' first occurrences);
  * a table's L2 is applied as 2*l2*p on the touched rows only (lazy
    decay, SparseAdam's semantics) instead of a loss term over the whole
    table.

On a model-sharded mesh the update runs on the rank's slab of each table
(``parallel/sharding.py``), on the batch's rows that the slab holds,
shifted to slab-local rows (``slab_rows``); the rest are dropped.

The update is plain torch ops (gather, elementwise, ``index_copy_``), as it
is XLA code outside any Pallas kernel in the JAX package. Its f32 ops are
rounded one by one in the JAX source's order; XLA on the CPU contracts
``b1*mu + (1-b1)*g`` into FMAs, so the JAX moments differ from these by an
ulp on part of the elements.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deepfm_tpu_torch.training.optim import B1, B2, EPS


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


def dedupe_ids(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Map duplicate ids to the out-of-bounds index ``num_rows``, keeping
    the first occurrence of each distinct id. Returns (n,) scatter
    indices."""
    s, order = torch.sort(ids, stable=True)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    target = torch.where(first, s, torch.full_like(s, num_rows))
    out = torch.full_like(ids, num_rows)
    out[order] = target
    return out


def lazy_adam_table_update(
    table: torch.Tensor,
    grad: torch.Tensor,
    state: TableSlotState,
    ids: torch.Tensor,
    *,
    lr: torch.Tensor,
    step: torch.Tensor,
    l2: float = 0.0,
    grad_scale: torch.Tensor | None = None,
    b1: float = B1,
    b2: float = B2,
    eps: float = EPS,
) -> tuple[torch.Tensor, TableSlotState]:
    """Adam on only the rows named by ``ids`` (duplicates deduped), in
    place on ``table`` and ``state``; returns them.

    ``grad`` is the dense table gradient (rows outside ``ids`` are never
    read or written), ``grad_scale`` the global-norm clip's factor, ``step``
    the completed steps (bias correction at ``step + 1``). Selecting the
    distinct ids reads their count back to the host.
    """
    scatter = dedupe_ids(ids, table.shape[0])
    rows = scatter[scatter < table.shape[0]]

    g = grad[rows]
    if grad_scale is not None:
        g = g * grad_scale
    p = table[rows]
    if l2 > 0:
        # lazy L2: decay only touched rows (row 0s carry zero grad AND zero
        # weight, so they stay exactly zero)
        g = g + (2.0 * l2) * p

    mu = b1 * state.mu[rows] + (1.0 - b1) * g
    nu = b2 * state.nu[rows] + (1.0 - b2) * torch.square(g)

    t = step.to(torch.float32) + 1.0
    mu_hat = mu / (1.0 - torch.pow(torch.full_like(t, b1), t))
    nu_hat = nu / (1.0 - torch.pow(torch.full_like(t, b2), t))
    new_rows = p - lr * mu_hat / (torch.sqrt(nu_hat) + eps)

    with torch.no_grad():
        table.index_copy_(0, rows, new_rows)
        state.mu.index_copy_(0, rows, mu)
        state.nu.index_copy_(0, rows, nu)
    return table, state


def table_ids_for_batch(embedding, ids: torch.Tensor) -> dict[str, torch.Tensor]:
    """Flat row-id streams per fused table of ``embedding``
    (``ops/embedding.py::FeatureEmbedding``) for a packed (B, S) id batch.

    Row 0 duplicates across fields are harmless: their rows are all-zero
    with zero gradients (forward mask), and the update leaves them at zero.

    On packed tables the ids are physical rows (``id // pack``, ``pack =
    128 // (width+1)`` logical rows a physical row): the update then runs
    on whole physical rows, and a touched physical row's untouched logical
    neighbours take a zero-gradient Adam step (momentum decay, and their
    lazy L2), as dense Adam would give them.
    """
    out: dict[str, torch.Tensor] = {}
    for gi, group in enumerate(embedding.packed.lookup_groups):
        name = f"table_w{group.width}"
        flat = embedding.local_ids(gi, ids).reshape(-1)
        out[name] = flat // embedding.table_pack[name]
    return out


def slab_rows(row_ids: torch.Tensor, lo: int, rows: int) -> torch.Tensor:
    """Row ids of a whole table as the rows of the slab that starts at row
    ``lo`` and holds ``rows`` rows: ``row - lo`` where the slab holds the
    row, else ``rows`` (out of bounds, which ``lazy_adam_table_update``
    drops with the duplicates)."""
    local = row_ids - lo
    return torch.where((local >= 0) & (local < rows), local,
                       torch.full_like(local, rows))
