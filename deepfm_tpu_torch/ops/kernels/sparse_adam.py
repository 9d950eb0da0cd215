"""Fused sparse backward-optimizer: two hand-written CUDA kernels and their
plain versions.

Replaces ``deepfm_tpu/ops/pallas/sparse_adam_kernel.py`` ::
``sparse_table_adam_packed`` (``_sparse_adam_kernel``) and
``segment_sumsq_pairs`` (``_segsumsq_kernel``). Source:
``csrc/sparse_table_adam.cu``.

``sparse_table_adam``: one pass per table that sums the sorted
(id, cotangent) pairs into each row's gradient, applies decay + clip + Adam
(``csrc/table_update.cuh``, shared with ``fused_table_adam``) in place, and
returns sum(p'^2) for the next step's clip norm. The dense gradient never
reaches device memory. It takes both table layouts: the packed
``(phys, 128)`` layout of the TPU kernel (``pack = 128 // (d+1)`` logical
rows per physical row, dead lanes updated with zeros and left 0) and the
logical ``(rows, d+1)`` one (``pack = 1``); the ids are logical in both.
On the same logical state the two give the same p, mu and nu bit for bit.
The TPU kernel's f32-exact id limit (2^24 rows) and its width gate
(128 // (d+1) > 1) do not apply here. What bounds it on an H100: bytes, p
read and written plus mu and nu read and written (2.83 GB at bench.py's
logical table with bf16 moments, about 0.85 ms at 3.35 TB/s; 3.04 GB
packed, 0.92 ms) and the pairs read once. A block owns one tile of rows
(``sparse_adam_plan``): it streams the tile in 16-byte vectors while it
builds the tile's gradient in shared memory from its pairs, staged a
window at a time, with the densify kernels' segmented row sum (a warp a
run, each column in stream order; a run longer than a window carries its
sum in the tile).

``segment_sumsq``: sum over runs of equal sorted ids of ||sum of the run's
rows||^2, the ||g||^2 term of the sparsely assembled clip norm
sumsq(g + wd*p) = sumsq(g) + 2*wd*<g, p> + wd^2*sumsq(p). Bounded by
reading the pairs once (31 MB, about 9 us). The TPU kernel's (c, c)
pairwise Gram blocks are an MXU artifact. Here the pairs are cut into
chunks of 32 (``segment_sumsq_plan``); each warp of a grid of at most one
wave takes a contiguous range of chunks, staging the next chunk's ids and
rows in shared memory by 16-byte ``cp.async`` while it sums this one. A
run that ends in its chunk is summed by its head's lane; one that goes on
past the chunk by the warp from device memory, or, reaching more than
``SCAN`` pairs further, by the block after its warps (fault 3: one thread
walked 16,384-pair runs). Each takes every column in stream order from 0
and adds its square column after column, so a run's square has the same
bits on every path. The last block to finish (an integer ticket) sums
the blocks' partials in order: one launch a call.

Both reduce their scalar per block into partials and then in a fixed
order, with no float atomics: the same inputs give the same bits.
``segment_sumsq`` takes rows of any width; ``sparse_table_adam`` takes
physical rows of at most 512 * gcd(width, 8) floats (512 at an odd width,
4096 at a multiple of 8), so that a tile of whole 16-byte vectors holds at
most TILE_ELEMENTS elements.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.ops.kernels.adam import (
    VECTOR,
    adam_scalars,
    adam_update_plain,
    aligned_head,
    betas,
    check_table,
)
from deepfm_tpu_torch.ops.kernels.grad import (
    MAX_ROWS,
    segment_rows_plain,
    sort_pairs,
)
from deepfm_tpu_torch.ops.kernels.packed_grad import LANES, pack_rows

SOURCE = "sparse_table_adam.cu"
# The plan of csrc/sparse_table_adam.cu (its constants of the same names)
THREADS = 256  # kThreads: threads a block
TILE_ELEMENTS = 2 * THREADS * VECTOR  # kTileElements: two vectors a thread
WINDOW_FLOATS = 4608  # kWindowFloats: a window of staged pairs
# segment_sumsq (its constants of the same names, kSsq...)
CHUNK = 32  # kSsqChunk: pairs a chunk, a lane each
SCAN = 64  # kSsqScan: a run reaching further past its chunk is long
SSQ_SMEM_LIMIT = 48 * 1024  # a block's shared memory without an opt-in
SSQ_WARPS = 132 * 4 * 8  # kSsqWarps: warps of the grid, at most (an H100 wave)
SSQ_IDS = 36  # kSsqIds: ids a stage buffer (the pair before, 32, the one after)
WARP_CHUNKS = 15  # kSsqWarpChunks: chunks a warp, at most
RING_FLOATS = 3 * 1536  # kRingFloats: the block path's staging ring


def tile_rows(width: int) -> int:
    """Physical rows a tile (``tile_rows`` in csrc/sparse_table_adam.cu):
    the most, in steps that keep the tile's element count a multiple of 8,
    with at most TILE_ELEMENTS elements (at least one step: a wider tile
    is refused by ``sparse_adam_plan``)."""
    q = next(q for q in range(1, VECTOR + 1) if q * width % VECTOR == 0)
    return max(TILE_ELEMENTS // width // q * q, q)


def window_pairs(dcol: int) -> int:
    """Pairs a staged window holds (``window_pairs``; at least one, as dcol
    is at most TILE_ELEMENTS)."""
    return WINDOW_FLOATS // (dcol + 1)


@dataclasses.dataclass(frozen=True)
class SparseAdamPlan:
    """One sparse_table_adam launch: a block a tile of ``tile_phys``
    physical rows; ``head``, the elements of every tile before its first
    16-byte vector of p, mu and nu (None: no common boundary, every element
    scalar); ``smem``, a block's dynamic shared memory in bytes."""

    rows: int
    width: int
    dcol: int
    pack: int
    head: int | None
    tile_phys: int

    @property
    def tiles(self) -> int:
        return -(-self.rows // self.tile_phys)

    @property
    def smem(self) -> int:
        """The tile's gradient (8 floats more, for the shift that aligns
        its vectors) and a window of the tile's pairs (rows and ids)."""
        return (4 * (self.tile_phys * self.width + VECTOR)
                + 4 * window_pairs(self.dcol) * (self.dcol + 1))

    def tile_split(self, tile: int) -> tuple[int, int, int, int]:
        """(first element, scalar head, vectors, scalar tail) of a tile."""
        phys0 = tile * self.tile_phys
        n = min(self.tile_phys, self.rows - phys0) * self.width
        head = n if self.head is None else min(self.head, n)
        vectors = (n - head) // VECTOR
        return phys0 * self.width, head, vectors, n - head - VECTOR * vectors


def sparse_adam_plan(rows: int, width: int, dcol: int, pack: int,
                     addresses) -> SparseAdamPlan:
    """The plan of a sparse_table_adam launch over a table of ``rows``
    physical rows of ``width`` floats, each holding ``pack`` logical rows
    of ``dcol`` columns, whose p, mu and nu lie at ``addresses``, (byte
    address, element size) pairs. The C launch recomputes it and refuses a
    mismatch; raises ValueError where the logical rows do not fit the row
    or a tile of whole vectors would pass TILE_ELEMENTS."""
    if dcol < 1 or pack < 1 or pack * dcol > width:
        raise ValueError(
            f"{pack} logical rows of {dcol} columns in a {width}-float row: "
            f"the kernel takes rows of at least 1 column that fit the row")
    plan = SparseAdamPlan(rows, width, dcol, pack, aligned_head(addresses),
                          tile_rows(width))
    if plan.tile_phys * width > TILE_ELEMENTS:
        raise ValueError(
            f"rows of {width} floats make a tile of {plan.tile_phys * width} "
            f"elements, more than the kernel's {TILE_ELEMENTS}: at most "
            f"512 * gcd(width, 8) floats a row")
    return plan


@dataclasses.dataclass(frozen=True)
class SegmentSumsqPlan:
    """One segment_sumsq launch (``SsqPlan`` in csrc/sparse_table_adam.cu):
    the pairs cut into chunks of CHUNK; a grid of blocks of THREADS threads
    (8 warps; one wave, more where a warp would take more than WARP_CHUNKS
    chunks), warp w taking chunks [w * q + min(w, r), ...), q of them and
    one more for w < r, staging the next chunk while it sums this one;
    ``staged``: a chunk's rows are staged in shared memory with its ids
    (else its lanes read their rows from device memory)."""

    n: int
    d: int
    staged: bool
    threads: int = THREADS

    @property
    def chunks(self) -> int:
        return -(-self.n // CHUNK)

    @property
    def warps(self) -> int:
        return self.threads // 32

    @property
    def grid(self) -> int:
        """One wave of blocks, or more where a warp would take more than
        WARP_CHUNKS chunks (which bounds a block's long runs)."""
        blocks = -(-self.chunks // self.warps)
        least = -(-self.chunks // (self.warps * WARP_CHUNKS))
        return max(1, min(blocks, SSQ_WARPS // self.warps), least)

    @property
    def warp_chunks(self) -> tuple[int, int]:
        """(q, r): warp w takes q chunks, one more for w < r."""
        return divmod(self.chunks, self.grid * self.warps)

    @property
    def buffer_floats(self) -> int:
        """A stage buffer: the chunk's rows (a multiple of 4 floats), then
        SSQ_IDS ids."""
        rows = -(-(CHUNK * self.d) // 4) * 4 if self.staged else 0
        return rows + SSQ_IDS

    @property
    def cap(self) -> int:
        """Long-run heads a block can hold: they lie more than SCAN pairs
        apart in its chunks."""
        q, r = self.warp_chunks
        return self.warps * (q + (r > 0)) * CHUNK // (SCAN + 1) + 1

    @property
    def smem(self) -> int:
        """Bytes: two stage buffers a warp, or the block path's ring and a
        pass of column sums where larger (they reuse them); the long-run
        heads (a multiple of 4), the warps' sums and a count."""
        region = max(2 * self.warps * self.buffer_floats,
                     RING_FLOATS + self.threads)
        return 4 * (region + -(-self.cap // 4) * 4 + self.warps + 4)

    @property
    def scratch(self) -> int:
        """Floats of the call's scratch: the sum, then a partial a block."""
        return 1 + self.grid


@functools.lru_cache(maxsize=64)
def segment_sumsq_plan(n: int, d: int) -> SegmentSumsqPlan:
    """The plan of a segment_sumsq launch over ``n`` sorted pairs of ``d``
    columns: rows staged where two stage buffers a warp fit
    SSQ_SMEM_LIMIT, else read from device memory. The C launch recomputes
    it and refuses a mismatch; raises ValueError where the kernel cannot
    take the pairs (d < 1, or n outside [0, 2^31))."""
    if d < 1 or not 0 <= n < 2 ** 31:
        raise ValueError(
            f"segment_sumsq takes 0 <= n < 2^31 pairs of at least 1 column, "
            f"got {n} pairs of {d}")
    plan = SegmentSumsqPlan(n, d, True)
    return plan if plan.smem <= SSQ_SMEM_LIMIT else SegmentSumsqPlan(
        n, d, False)


_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """segment_sumsq's ticket for calls on ``stream`` of ``device``: one
    zeroed int32, which each call's last block resets to 0. Calls on one
    stream run one after another; calls on two streams may overlap, so
    each stream has its own ticket."""
    t = _tickets.get((device.index, stream))
    if t is None:
        t = _tickets[(device.index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=device)
    return t


_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "sparse_table_adam_launch": [
        _P, _P, _P, _I, _LL, _I, _I, _I, _P, _P, _LL, _P, _F, _F, _F, _F, _I,
        _I, _I, _P, _P, _P, _P,
    ],
    "segment_sumsq_launch": [_P, _P, _LL, _I, _I, _I, _I, _LL, _P, _P, _P],
}

__all__ = [
    "segment_sumsq",
    "segment_sumsq_plain",
    "segment_sumsq_plan",
    "SegmentSumsqPlan",
    "SparseAdamPlan",
    "sort_pairs",
    "sparse_adam_plan",
    "sparse_table_adam",
    "sparse_table_adam_plain",
]


def _check_pairs(sids: torch.Tensor, cts: torch.Tensor) -> None:
    if sids.dtype != torch.int32 or cts.dtype != torch.float32:
        raise TypeError(
            f"sorted ids must be int32 and rows float32, got {sids.dtype} / "
            f"{cts.dtype}"
        )
    if cts.dim() != 2 or sids.shape != (cts.shape[0],) \
            or sids.device != cts.device:
        raise ValueError(
            f"ids {tuple(sids.shape)} on {sids.device} do not match rows "
            f"{tuple(cts.shape)} on {cts.device}"
        )


def segment_sumsq_plain(sids: torch.Tensor, cts: torch.Tensor) -> torch.Tensor:
    """Plain version: each run summed in stream order, then the sum of the
    squares of all run sums (f32 0-dim)."""
    n = sids.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=cts.device)
    first = torch.ones(n, dtype=torch.bool, device=sids.device)
    first[1:] = sids[1:] != sids[:-1]
    run = torch.cumsum(first.to(torch.int32), dim=0, dtype=torch.int32) - 1
    sums = segment_rows_plain(run, cts, int(run[-1]) + 1)
    return torch.sum(sums * sums)


def segment_sumsq(sids: torch.Tensor, cts: torch.Tensor) -> torch.Tensor:
    """sum_r ||sum_{i: sids[i] == r} cts[i]||^2 for SORTED ids, as an f32
    0-dim tensor. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises): one launch and one allocation a call.
    Calls on one stream share a ticket (``_ticket``)."""
    if cts.device.type == "cpu":
        return segment_sumsq_plain(sids, cts)
    if cts.device.type != "cuda":
        raise ValueError(f"unsupported device {cts.device}")
    _check_pairs(sids, cts)
    sids, cts = sids.contiguous(), cts.contiguous()
    n, d = cts.shape
    plan = segment_sumsq_plan(n, d)
    scratch = torch.empty(plan.scratch, dtype=torch.float32,
                          device=cts.device)
    lib = build.bind(SOURCE, _SIGNATURES)
    stream = build.stream_of(cts)
    with build.launch_device(cts.device):
        err = lib.segment_sumsq_launch(
            sids.data_ptr(), cts.data_ptr(), n, d, int(plan.staged),
            plan.threads, plan.smem, plan.grid, scratch.data_ptr(),
            _ticket(cts.device, stream).data_ptr(), stream,
        )
    build.check(lib, SOURCE, "segment_sumsq", err)
    segment_sumsq.launches += 1
    return scratch[0]


segment_sumsq.launches = 0


def sparse_table_adam_plain(param, mu, nu, sids, cts, lr, weight_decay,
                            global_norm, clip_norm, step, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8,
                            pack: int = 1):
    """Plain version: densify (``segment_rows_plain``, packed when
    ``pack`` > 1), the shared update over every element (dead lanes
    included), and sum(p'^2); in place on param, mu and nu."""
    sc = adam_scalars(lr, weight_decay, global_norm, clip_norm, step, b1, b2,
                      eps, device=param.device)
    grad = segment_rows_plain(sids, cts, param.shape[0] * pack)
    if pack > 1:
        grad = pack_rows(grad, pack)
    p2, m2, v2 = adam_update_plain(param, grad, mu, nu, sc, b1, b2)
    param.copy_(p2)
    mu.copy_(m2)
    nu.copy_(v2)
    return param, mu, nu, torch.sum(p2 * p2)


def _check_layout(param, cts, pack: int) -> None:
    rows, width = param.shape
    dcol = cts.shape[1]
    logical = pack == 1 and width == dcol
    packed = pack > 1 and width == LANES and pack * dcol <= LANES
    if not (logical or packed) or cts.device != param.device:
        raise ValueError(
            f"rows {tuple(cts.shape)} on {cts.device} do not match the table "
            f"{tuple(param.shape)} on {param.device} at pack {pack}"
        )
    if rows * pack > MAX_ROWS:
        raise ValueError(
            f"tables of at most {MAX_ROWS} logical rows, got {rows * pack}")


def sparse_table_adam(param, mu, nu, sids, cts, lr, weight_decay,
                      global_norm, clip_norm, step, b1: float = 0.9,
                      b2: float = 0.999, eps: float = 1e-8, pack: int = 1):
    """One fused densify + decay + clip + Adam step over a table, from its
    sorted (logical id, cotangent) pairs (``sort_pairs``), in place. The
    table is logical (rows, d+1) with ``pack`` = 1, or packed (phys, 128)
    with ``pack`` = 128 // (d+1) logical rows per physical row.

    Returns (param, mu, nu, sumsq(param')) — the first three are the input
    tensors. ``step`` counts completed steps; ``global_norm`` spans the full
    decayed gradient tree; clip_norm <= 0 disables clipping. Ids outside
    [0, rows * pack) contribute nothing. A CPU table takes the plain
    version; a CUDA table launches the kernel (or raises).
    """
    if param.device.type == "cpu":
        return sparse_table_adam_plain(param, mu, nu, sids, cts, lr,
                                       weight_decay, global_norm, clip_norm,
                                       step, b1, b2, eps, pack)
    if param.device.type != "cuda":
        raise ValueError(f"unsupported device {param.device}")
    check_table(param, mu, nu)
    _check_pairs(sids, cts)
    _check_layout(param, cts, pack)
    rows, width = param.shape
    sids, cts = sids.contiguous(), cts.contiguous()
    sc = adam_scalars(lr, weight_decay, global_norm, clip_norm, step, b1, b2,
                      eps, device=param.device)
    plan = sparse_adam_plan(rows, width, cts.shape[1], pack, [
        (t.data_ptr(), t.element_size()) for t in (param, mu, nu)])
    bounds = torch.empty(plan.tiles + 1, dtype=torch.int64,
                         device=param.device)
    partials = torch.empty(max(plan.tiles, 1), dtype=torch.float32,
                           device=param.device)
    psq = torch.empty((), dtype=torch.float32, device=param.device)
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(param.device):
        err = lib.sparse_table_adam_launch(
            param.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            int(mu.dtype == torch.bfloat16), rows, width, cts.shape[1], pack,
            sids.data_ptr(), cts.data_ptr(), cts.shape[0], sc.data_ptr(),
            *betas(b1, b2), plan.tile_phys,
            -1 if plan.head is None else plan.head, plan.smem,
            bounds.data_ptr(), partials.data_ptr(), psq.data_ptr(),
            build.stream_of(param),
        )
    build.check(lib, SOURCE, "sparse_table_adam", err)
    sparse_table_adam.launches += 1
    return param, mu, nu, psq


sparse_table_adam.launches = 0
