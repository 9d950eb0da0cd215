"""Embedding-gradient densification: the hand-written CUDA kernel, its plain
version, and the table lookup whose backward it is.

Replaces ``deepfm_tpu/ops/pallas/grad_kernel.py`` :: ``densify_rows_grad``
(the ``pl.pallas_call`` of ``_densify_kernel``) and ``sparse_grad_lookup``.
Source: ``csrc/densify_rows_grad.cu``.

What it computes: the dense (rows, D) gradient of a table gather,
``zeros((rows, D)).at[ids].add(ct)``, deterministic. The (id, cotangent)
pairs are sorted by id first (``sort_pairs``: a stable ``torch.sort``, as
the JAX wrapper sorts in XLA and not in Pallas), so each row's duplicates
form one run, summed in stream order: the result equals a sequential
scatter-add in the original order, bit for bit (``np.add.at``).

What bounds it on an H100: bytes. The dense output is written once (707 MB
at bench.py's 10.4M x 17 table) and the pairs are read once (31 MB). The
kernel (``csrc/densify_tile.cuh``, shared with the packed densify) builds
tiles of rows in shared memory and writes each with one bulk store, zeros
included; ``densify_plan`` is its tile plan. The TPU kernel's one-hot MXU
matmul, its 3-way bf16 mantissa split and its f32-exact id limit (2^24 rows) are TPU
artifacts and are not carried over; ids are int32, so a table may hold up
to 2^31 - 1 rows.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from deepfm_tpu_torch.ops.kernels import build

SOURCE = "densify_rows_grad.cu"
_SIGNATURES = {
    "densify_rows_grad_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ],
}
MAX_ROWS = 2**31 - 1

# The tile plan of the densify kernels (csrc/densify_tile.cuh)
SMEM_PER_BLOCK = 232_448  # Hopper: at most 227 KB of shared memory a block
TILE_BYTES = 32 * 1024  # one of a block's two tile buffers, at most
CHUNK_BYTES = 36 * 1024  # the cotangent rows of a window of staged pairs
MAX_CHUNK_PAIRS = 1024
BOUND_BATCH = 256  # kBoundBatch: tile bounds searched at once
BLOCKS_PER_SM = 2  # kBlocksPerSM: resident blocks an SM (launch bounds)
WAVES = 2  # blocks per resident slot, so a slow tile (a long run) delays
# one block of a few tiles while the others take the rest


@dataclass(frozen=True)
class DensifyPlan:
    """Where a densify launch writes: ``phys`` physical rows of ``width``
    floats, in tiles of ``tile_phys`` rows; block b of ``grid`` builds the
    contiguous tiles ``block_tiles(b)``, staging up to ``chunk_pairs``
    pairs at a time; a block takes ``smem_bytes`` of dynamic shared
    memory."""

    phys: int
    width: int
    tile_phys: int
    chunk_pairs: int
    grid: int
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return -(-self.phys // self.tile_phys)

    def block_tiles(self, block: int) -> range:
        return range(self.tiles * block // self.grid,
                     self.tiles * (block + 1) // self.grid)

    def tile_store(self, tile: int) -> tuple[int, int, int]:
        """(byte offset, bytes bulk-stored, bytes stored plainly) of a
        tile's output: every float but the last (floats % 4) goes in one
        bulk store."""
        phys0 = tile * self.tile_phys
        floats = min(self.tile_phys, self.phys - phys0) * self.width
        bulk = floats - floats % 4
        return 4 * phys0 * self.width, 4 * bulk, 4 * (floats - bulk)


def densify_plan(num_rows: int, dcol: int, pack: int = 1,
                 width: int | None = None, sms: int = 132) -> DensifyPlan:
    """The tile plan of a densify launch over ``num_rows`` logical rows of
    ``dcol`` columns, ``pack`` to a physical row of ``width`` floats
    (logical layout: pack 1, width dcol) on a card of ``sms`` SMs
    (``smem_bytes`` is ``densify_tile::smem_bytes``). A tile holds a
    multiple of 4 physical rows, so every tile but the last is a whole
    number of 16-byte units; raises ValueError when one block's shared
    memory would exceed SMEM_PER_BLOCK."""
    width = dcol if width is None else width
    if dcol < 1 or pack < 1 or pack * dcol > width:
        raise ValueError(
            f"{pack} rows of {dcol} columns do not fit a {width}-float row")
    phys = -(-num_rows // pack)
    tile = max(4, TILE_BYTES // (4 * width) // 4 * 4)
    tile = min(tile, max(4, -(-phys // 4) * 4))
    chunk = max(1, min(MAX_CHUNK_PAIRS, CHUNK_BYTES // (4 * dcol)))
    smem = (8 * tile * width + 8 * (BOUND_BATCH + 1)
            + chunk * (4 * dcol + 4))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"densify rows of {width} floats need {smem} bytes of shared "
            f"memory per block; the limit is {SMEM_PER_BLOCK}")
    grid = min(-(-phys // tile), WAVES * BLOCKS_PER_SM * sms)
    return DensifyPlan(phys, width, tile, chunk, grid, smem)


def sort_pairs(
    flat_ids: torch.Tensor, ct: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort (ids, cotangent rows) by id, stably: (sids (n,) int32,
    cts (n, D) f32). The port of ``sparse_adam_kernel.py::sort_pairs``,
    with the rows kept row-major (the TPU's transposed stream is a lane
    layout)."""
    sids, order = torch.sort(flat_ids.to(torch.int32), stable=True)
    return sids, ct[order].float().contiguous()


def segment_rows_plain(
    sids: torch.Tensor, cts: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain version of the segmented row sum: (num_rows, D) f32, row r the
    sum of the run of pairs with id r, taken in stream order. Ids outside
    [0, num_rows) contribute nothing, as in the kernel. Deterministic on
    every device: level k adds the k-th pair of every run, and no two pairs
    of one level share a row."""
    out = torch.zeros(num_rows, cts.shape[1], dtype=torch.float32,
                      device=cts.device)
    keep = (sids >= 0) & (sids < num_rows)
    sids, cts = sids[keep], cts[keep].float()
    n = sids.shape[0]
    if n == 0:
        return out
    pos = torch.arange(n, device=sids.device)
    first = torch.ones(n, dtype=torch.bool, device=sids.device)
    first[1:] = sids[1:] != sids[:-1]
    run_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - run_start
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        rows = sids[sel].long()
        out[rows] = out[rows] + cts[sel]
    return out


def densify_rows_grad_plain(
    ct: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain PyTorch version of ``densify_rows_grad``."""
    return segment_rows_plain(*sort_pairs(ids, ct), num_rows)


def _densify_cuda(sids, cts, num_rows: int) -> torch.Tensor:
    n, d = cts.shape
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
    if not 0 <= num_rows <= MAX_ROWS:
        raise ValueError(f"num_rows must be in [0, {MAX_ROWS}], got {num_rows}")
    sids, cts = sids.contiguous(), cts.contiguous()
    plan = densify_plan(num_rows, d, sms=build.sm_count(cts))
    out = torch.empty(num_rows, d, dtype=torch.float32, device=cts.device)
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(cts.device):
        err = lib.densify_rows_grad_launch(
            sids.data_ptr(), cts.data_ptr(), n, d, num_rows, plan.tile_phys,
            plan.chunk_pairs, plan.grid, plan.smem_bytes, out.data_ptr(),
            build.stream_of(cts),
        )
    build.check(lib, SOURCE, "densify_rows_grad", err)
    densify_rows_grad.launches += 1
    return out


def densify_sorted(
    sids: torch.Tensor, cts: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """``densify_rows_grad`` on pairs already sorted by ``sort_pairs``. A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if cts.device.type == "cpu":
        return segment_rows_plain(sids, cts, num_rows)
    if cts.device.type != "cuda":
        raise ValueError(f"unsupported device {cts.device}")
    return _densify_cuda(sids, cts, num_rows)


def densify_rows_grad(
    ct: torch.Tensor, ids: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Dense (num_rows, D) f32 gradient from per-occurrence rows ``ct``
    (n, D) and their row ids (n,): ``sort_pairs``, then the kernel (CUDA)
    or the plain version (CPU)."""
    if ct.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ct.device}")
    return densify_sorted(*sort_pairs(ids, ct), num_rows)


densify_rows_grad.launches = 0


class _SparseGradLookup(torch.autograd.Function):
    """Table gather whose backward is ``densify_rows_grad``."""

    @staticmethod
    def forward(ctx, table, flat_ids):
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = table.shape[0]
        return table[flat_ids]

    @staticmethod
    def backward(ctx, ct):
        (flat_ids,) = ctx.saved_tensors
        return densify_rows_grad(ct, flat_ids, ctx.num_rows), None


def sparse_grad_lookup(table: torch.Tensor, flat_ids: torch.Tensor):
    """Rows ``table[flat_ids]``; the table's gradient is densified by the
    kernel (``grad_kernel.py::sparse_grad_lookup``). The forward is plain
    indexing, as the JAX forward is XLA's gather."""
    return _SparseGradLookup.apply(table, flat_ids)
