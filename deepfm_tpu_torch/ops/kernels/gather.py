"""Embedding-row gather: the hand-written CUDA kernel, its plain version and
the table lookup whose forward it is.

Replaces ``deepfm_tpu/ops/pallas/embedding_kernel.py`` :: ``pallas_lookup``
(the ``pl.pallas_call`` of ``_gather_kernel``), the opt-in lookup of
``pallas.use_embedding_kernel`` (off by default; off, the gather is plain
indexing, as the JAX default is XLA's own gather). Source:
``csrc/row_gather.cu``.

What it computes: ``out[i] = table[ids[i]]`` for a (V, C) f32 table, a zero
row for an id outside [0, V) (the kernel reads nothing outside the table).
The TPU kernel's gates (C | 128, V % (128 / C) == 0, a multiple of its
1024-id tile, else ``jnp.take``) do not apply: any shape runs the kernel.
What bounds it on an H100: bytes, each gathered row read and written once
(61 MB at bench.py's 425,984 ids x 17 columns, about 0.018 ms).

The lookup's backward is ``densify_rows_grad`` (``ops/kernels/grad.py``):
the JAX VJP is ``zeros.at[ids].add(g)``, and the stable-sorted stream-order
sum gives the same bits as a sequential scatter-add.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.ops.kernels.grad import densify_rows_grad

SOURCE = "row_gather.cu"
_SIGNATURES = {
    "row_gather_launch": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ],
}


def row_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table[ids]``, a zero row for an id outside
    [0, V)."""
    v = table.shape[0]
    valid = (ids >= 0) & (ids < v)
    rows = table[ids.clamp(0, max(v - 1, 0))]
    return torch.where(valid[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                         device=table.device))


@functools.cache
def _library():
    """The kernel's library, built, loaded and bound at the first launch."""
    return build.bind(SOURCE, _SIGNATURES)


def gather_operands(table: torch.Tensor, ids: torch.Tensor):
    """(table, ids) as the kernel takes them: a contiguous 2-D float32
    table and contiguous int64 ids on its device. Raises on anything
    else."""
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(
            f"the table must be a 2-D float32 tensor, got {table.dtype} "
            f"{tuple(table.shape)}"
        )
    if ids.dim() != 1 or ids.device != table.device:
        raise ValueError(
            f"ids {tuple(ids.shape)} on {ids.device} must be 1-D on the "
            f"table's device {table.device}"
        )
    if ids.dtype != torch.int64:  # (.to() costs microseconds even as a no-op)
        ids = ids.long()
    return table.contiguous(), ids.contiguous()


def row_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (n,) of a 2-D table: (n, C). A CPU table takes the plain
    version; a CUDA table launches the kernel (or raises).

    The host path is kept short, since a gather of tens of MB takes tens of
    microseconds on the card: the library is bound once, the stream is read
    without building a Stream object, and a table off the current device
    raises (``build.check_current``)."""
    if not table.is_cuda:
        if table.device.type == "cpu":
            return row_gather_plain(table, ids)
        raise ValueError(f"unsupported device {table.device}")
    table, ids = gather_operands(table, ids)
    v, c = table.shape
    n = ids.shape[0]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    if n == 0 or c == 0:
        return out
    lib = _library()
    dev = table.get_device()
    build.check_current(dev)
    err = lib.row_gather_launch(
        table.data_ptr(), v, c, ids.data_ptr(), n, out.data_ptr(), dev,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err:
        build.check(lib, SOURCE, "row_gather", err)
    row_gather.launches += 1
    return out


row_gather.launches = 0


class _RowGatherLookup(torch.autograd.Function):
    """Table gather by the kernel; its backward is ``densify_rows_grad``."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = table.shape[0]
        return row_gather(table, flat_ids)

    @staticmethod
    def backward(ctx, ct):
        (flat_ids,) = ctx.saved_tensors
        return densify_rows_grad(ct, flat_ids, ctx.num_rows), None


def row_gather_lookup(table: torch.Tensor, flat_ids: torch.Tensor):
    """Rows ``table[flat_ids]`` gathered by the kernel (``pallas_lookup``),
    the table's gradient densified by the densify kernel."""
    return _RowGatherLookup.apply(table, flat_ids)
