"""The packed table layout's lookup and its gradient densification: the
hand-written CUDA kernel and its plain version.

Replaces ``deepfm_tpu/ops/pallas/packed_grad_kernel.py`` ::
``densify_rows_grad_packed`` (the ``pl.pallas_call`` of ``_densify_kernel``)
and ``make_packed_lookup``. Source: ``csrc/densify_rows_grad_packed.cu``.

The packed layout (``deepfm_tpu_torch/utils/layout.py``) keeps
``pack = 128 // dcol`` logical rows of ``dcol`` columns side by side in each
128-float physical row: logical row ``r`` in physical row ``r // pack``,
lanes ``[(r % pack) * dcol, (r % pack + 1) * dcol)``; the lanes from
``pack * dcol`` on are dead and hold 0.

``densify_rows_grad_packed`` computes ``zeros((num_rows, dcol)).at[ids]
.add(ct)`` laid out packed, deterministic: the pairs are sorted by logical
id (``sort_pairs``), each row's run is summed in stream order, and the
result is bit-equal to the logical densify packed afterwards and to a
sequential scatter-add in the original order. What bounds it on an H100:
bytes, the packed gradient written once (760.7 MB at bench.py's table) and
the pairs read once (31 MB). The kernel is the logical densify's tiled
kernel (``csrc/densify_tile.cuh``) over 128-float physical rows, with the
tile plan of ``grad.densify_plan``. The TPU kernel's one-hot MXU matmul, its 3-way
bf16 split and its 2^24-row fallback are TPU artifacts and are not carried
over.

``packed_lookup`` is the gather of a packed table: its forward is plain
indexing into a ``(phys, pack, dcol)`` view of the table (the JAX forward
is XLA's gather; its ``"flat"`` mode, a documented TPU negative result that
no config reaches, is not ported), and its backward is always
``densify_rows_grad_packed``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.ops.kernels.grad import (
    MAX_ROWS,
    densify_plan,
    segment_rows_plain,
    sort_pairs,
)

SOURCE = "densify_rows_grad_packed.cu"
LANES = 128
_SIGNATURES = {
    "densify_rows_grad_packed_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ],
}


def pack_rows(dense: torch.Tensor, pack: int) -> torch.Tensor:
    """A logical (num_rows, dcol) block laid out packed:
    (ceil(num_rows / pack), 128), dead lanes and padding rows 0."""
    rows, dcol = dense.shape
    phys = -(-rows // pack)
    out = F.pad(dense, (0, 0, 0, phys * pack - rows))
    return F.pad(out.reshape(phys, pack * dcol), (0, LANES - pack * dcol))


def densify_packed_plain(sids: torch.Tensor, cts: torch.Tensor,
                         num_rows: int, pack: int) -> torch.Tensor:
    """Plain version on pairs sorted by ``sort_pairs``: the logical
    segmented row sum (``segment_rows_plain``), packed."""
    return pack_rows(segment_rows_plain(sids, cts, num_rows), pack)


def densify_rows_grad_packed_plain(ct: torch.Tensor, ids: torch.Tensor,
                                   num_rows: int, pack: int) -> torch.Tensor:
    """Plain PyTorch version of ``densify_rows_grad_packed``."""
    return densify_packed_plain(*sort_pairs(ids, ct), num_rows, pack)


def _check(cts: torch.Tensor, num_rows: int, pack: int) -> None:
    if cts.dim() != 2 or not 1 <= pack * cts.shape[1] <= LANES:
        raise ValueError(
            f"rows {tuple(cts.shape)} do not fit {pack} to a {LANES}-lane row"
        )
    if not 0 <= num_rows <= MAX_ROWS:
        raise ValueError(f"num_rows must be in [0, {MAX_ROWS}], got {num_rows}")


def _densify_packed_cuda(sids, cts, num_rows: int, pack: int) -> torch.Tensor:
    n, dcol = cts.shape
    if sids.dtype != torch.int32 or cts.dtype != torch.float32:
        raise TypeError(
            f"sorted ids must be int32 and rows float32, got {sids.dtype} / "
            f"{cts.dtype}"
        )
    if sids.shape != (n,) or sids.device != cts.device:
        raise ValueError(
            f"ids {tuple(sids.shape)} on {sids.device} do not match rows "
            f"{tuple(cts.shape)} on {cts.device}"
        )
    sids, cts = sids.contiguous(), cts.contiguous()
    plan = densify_plan(num_rows, dcol, pack, LANES, build.sm_count(cts))
    out = torch.empty(plan.phys, LANES, dtype=torch.float32,
                      device=cts.device)
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(cts.device):
        err = lib.densify_rows_grad_packed_launch(
            sids.data_ptr(), cts.data_ptr(), n, dcol, pack, num_rows,
            plan.tile_phys, plan.chunk_pairs, plan.grid, plan.smem_bytes,
            out.data_ptr(), build.stream_of(cts),
        )
    build.check(lib, SOURCE, "densify_rows_grad_packed", err)
    densify_rows_grad_packed.launches += 1
    return out


def densify_packed_sorted(sids: torch.Tensor, cts: torch.Tensor,
                          num_rows: int, pack: int) -> torch.Tensor:
    """``densify_rows_grad_packed`` on pairs already sorted by
    ``sort_pairs``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    _check(cts, num_rows, pack)
    if cts.device.type == "cpu":
        return densify_packed_plain(sids, cts, num_rows, pack)
    if cts.device.type != "cuda":
        raise ValueError(f"unsupported device {cts.device}")
    return _densify_packed_cuda(sids, cts, num_rows, pack)


def densify_rows_grad_packed(ct: torch.Tensor, ids: torch.Tensor,
                             num_rows: int, pack: int) -> torch.Tensor:
    """The packed (ceil(num_rows / pack), 128) f32 gradient of a gather of
    logical rows: per-occurrence rows ``ct`` (n, dcol) and their logical
    ids (n,); ids outside [0, num_rows) contribute nothing. ``sort_pairs``,
    then the kernel (CUDA) or the plain version (CPU)."""
    if ct.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ct.device}")
    return densify_packed_sorted(*sort_pairs(ids, ct), num_rows, pack)


densify_rows_grad_packed.launches = 0


def packed_rows(table: torch.Tensor, flat_ids: torch.Tensor, dcol: int,
                pack: int) -> torch.Tensor:
    """Logical rows ``flat_ids`` (n,) of a packed (phys, 128) table: (n,
    dcol), plain indexing into a strided (phys, pack, dcol) view (no copy of
    the table)."""
    view = table.as_strided((table.shape[0], pack, dcol),
                            (table.stride(0), dcol, 1))
    return view[flat_ids // pack, flat_ids % pack]


class _PackedLookup(torch.autograd.Function):
    """Packed-table gather whose backward is ``densify_rows_grad_packed``."""

    @staticmethod
    def forward(ctx, table, flat_ids, dcol, pack):
        ctx.save_for_backward(flat_ids)
        ctx.geometry = (table.shape[0], pack)
        return packed_rows(table, flat_ids, dcol, pack)

    @staticmethod
    def backward(ctx, ct):
        (flat_ids,) = ctx.saved_tensors
        phys, pack = ctx.geometry
        return (densify_rows_grad_packed(ct, flat_ids, phys * pack, pack),
                None, None, None)


def packed_lookup(table: torch.Tensor, flat_ids: torch.Tensor, dcol: int,
                  pack: int) -> torch.Tensor:
    """Logical rows of a packed table (``make_packed_lookup``'s window
    form); the table's gradient is densified straight into the packed
    layout by the kernel."""
    if not table.is_contiguous():
        raise ValueError("a packed table must be contiguous")
    return _PackedLookup.apply(table, flat_ids, dcol, pack)
