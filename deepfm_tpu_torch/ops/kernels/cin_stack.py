"""The CIN stack: hand-written CUDA kernels for its forward and its backward,
their plain versions, and ``CinStackFn``, which ties the two together for
autograd. This note covers the forward; the backward's is further down.

The forward replaces ``deepfm_tpu/ops/pallas/cin_stack_kernel.py`` ::
``make_cin_stack_pallas.forward`` / ``_stack_kernel`` (the
``pl.pallas_call`` of the forward) with two kernels: in f32
``csrc/cin_stack_fwd.cu`` (the FP32 pipes), and in the bf16 operand mode
``csrc/cin_stack_fwd_mma.cu`` (the tensor cores, ``cin_stack_mma``).

What it computes. Given x0 (B, F, D), per-layer weights W_i (M_i, H_i*F)
in the parameter's own h-major layout (column h*F + f) and biases b_i, each
layer is comp = relu(sum_{h,f} W_i[m, h*F+f] * hid[b,h,d] * x0[b,f,d] +
b_i[m]); with split-half every layer but the last pools its first M_i//2
maps and hands the rest on as the next hidden state, otherwise all maps do
both; the output is concat_i sum_d direct_i, shape (B, sum(direct_i)).

What bounds it on an H100: operations, not bytes. At bench.py's xDeepFM
shape (B=16384, F=27, D=16, [128,128] split) a forward is ~165 GFLOP
against ~41 MB of f32 input and output; only x0, the weights and the
pooled output touch device memory. Both kernels keep every per-layer
feature map and the outer product in shared memory and registers. The
f32 kernel (``fp32_forward_plan``: a block of up to 256 threads per tile
of samples, 8 x 8 register cells of maps by columns, each layer's
weights staged by cp.async and its outer product formed once a block, in
chunks of up to 32 rows of K; csrc/cin_stack.cuh's ``layer_product``,
which the backward's remat shares) is bounded by the FP32 FMA rate. The
bf16 kernel runs each layer as mma.sync m16n8k16
products whose B fragments (the outer product, rounded to bf16) are
formed in registers, with the weights streamed through shared memory; its
tile is ``forward_plan``'s. See the .cu files for the designs.

Re-layout done here, not in the kernels, and cached per weight and bias
tensor until that tensor changes (its version counter or storage moves),
so a served model pays for it once, not per request: for the f32 kernel
the weights are transposed to k-major (K_i, mpad_i), zero-padded to
mpad_i = round_up(M_i, 8) maps, and the biases padded to mpad_i; for the
bf16 kernel each weight becomes (round_up(M_i, 16), H_i * round_up(F, 16))
bf16, row-major, column h * round_up(F, 16) + f, zeros in the pads
(``mma_weight``), and the biases are read as they are. The TPU kernel's
f-major chunking, VMEM budgets and (F, D, B) transpose are TPU artifacts
and are not carried over. Neither is its alignment gate: both kernels take
any B >= 1, F, D and layer sizes (odd splits included) and mask the
ragged edges themselves. ``forward_plan`` fits every shape ``stack_route``
sends to the stack forward.

Routes. A block holds a tile's feature maps in shared memory, so a stack
with wide layers does not fit one block. ``stack_route``, one shape
predicate computed from the same arithmetic as the kernels' plans
(``stack_smem``; in the bf16 operand mode the backward goes by the bf16
kernel's own plan, ``mma_backward_plan``), sends such a stack, in each
direction on its own, down the "layers" route instead, the port of the
JAX package's fallbacks (``make_cin_stack_pallas``'s ``forward`` / ``bwd``
gates behind ``stack_tile``): the forward runs each layer through the
per-layer kernel ``cin_compress_layer`` (``ops/kernels/cin.py``), and the
backward is ``backward_xla``'s algorithm (``cin_stack_backward_layers``,
in f32). At the xDeepFM paper's Criteo CIN (D=10, 3 x 200 maps, no split)
the forward fits (F=27: 109,312 bytes by ``stack_smem``'s count; the bf16
kernel's plan takes 225,408); the f32 backward does not (250,496 at F=27,
268,928 at F=39), but the bf16 backward's streamed layout does (204,512
and 214,112 bytes at a tile of 128 columns). The plans themselves
still raise when called on a shape that does not fit.
The JAX package runs its jnp oracle where its forward finds no tile; the
port runs the kernel (there is no plain path on the card), so in bf16 the
two differ by the kernel's f32 accumulation. On the CPU the same
predicate picks the route, and every layer runs the plain version.

bf16 mode (``bf16_operands`` with a bfloat16 x0) follows the TPU kernel:
bf16 operands (x0, weights, the outer product), f32 accumulation, f32 bias
add, ReLU and pooling, the hidden state rounded to bf16 between layers,
and the output cast to bf16. The TPU pads F to 16 in this mode
(``cin_stack_kernel.py:601``), as the bf16 kernel does. The TPU
additionally requires every hidden height to be a multiple of 16 for this
mode and otherwise runs f32; the port has no such gate, so at other
heights the two differ by bf16 rounding. bf16 input without
``bf16_operands`` computes in f32. On the card every bf16-mode call down
the "stack" route launches the bf16 kernel; the f32 kernel has no bf16
instance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from deepfm_tpu_torch.ops.cin import cin_compress, cin_layer_sizes
from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.ops.kernels.cin import (
    SMEM_PER_SM,
    SMEM_RESERVED,
    _relayout,
    _round_up,
    _zero_padded,
    cin_compress_backward,
    cin_compress_layer,
    kmajor_weight,
)

SOURCE = "cin_stack_fwd.cu"
MMA_SOURCE = "cin_stack_fwd_mma.cu"
MAX_LAYERS = 8
# Hopper: at most 227 KB of shared memory per block.
SMEM_PER_BLOCK = 232_448
# The route's count (``stack_smem``), kept from the first f32 kernels'
# layout: columns padded to COLUMN_CHUNK, a chunk of A of HIDDEN_CHUNK
# hidden rows. The f32 plans (below) take every shape it sends to the stack.
HIDDEN_CHUNK = 4
COLUMN_CHUNK = 64
# The bf16 kernel (csrc/cin_stack_fwd_mma.cu): each warp owns 4 n8 tiles
# (32 columns) and at most a number of m16 tiles of a pass. Two instances,
# (warps, m16 tiles a warp): the first runs two blocks an SM, each within
# half of the SM's 228 KB less the 1 KB reserved per block.
MMA_WARP_COLUMNS = 32
MMA_TWO_BLOCKS = (8, 4)
MMA_ONE_BLOCK = (12, 5)
SMEM_TWO_BLOCKS = 115_712


def cin_stack_plain(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    layer_sizes: Sequence[int],
    split_half: bool,
    bf16_operands: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the JAX factory's ``oracle``,
    plus the bf16 rounding of the bf16 mode). Materialises the outer
    product; the tests and chip_smoke.py hold the kernel against it."""
    bf16 = bf16_operands and x0.dtype == torch.bfloat16

    def op(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if bf16 else t

    layer_sizes = tuple(layer_sizes)
    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    x = x0.float()
    hidden = x
    outs = []
    for i in range(n):
        comp = torch.relu(cin_compress(
            hidden, x, op(weights[i].float()), biases[i].float(), op
        ))
        if split_half and i < n - 1:
            direct = comp[:, : direct_sizes[i]]
            hidden = comp[:, direct_sizes[i] :]
        else:
            direct = hidden = comp
        hidden = op(hidden)
        outs.append(direct.sum(dim=2))
    return torch.cat(outs, dim=1).to(x0.dtype)


def stack_smem(
    batch: int, f: int, d: int, layer_sizes: Sequence[int],
    split_half: bool, backward: bool,
) -> tuple[int, int, int]:
    """(tile_b, ntp, smem_bytes) of the stack route's count in one
    direction (the layout of the first f32 kernels; the
    kernels' own layouts are ``fp32_forward_plan``'s and
    ``fp32_backward_plan``'s, which fit wherever this does).

    A block holds tile_b samples as tile_b*d columns padded to ntp, a
    multiple of the column chunk. The forward keeps (f + 2*max(M)) rows of
    f32 shared memory; the backward, per column, x0, each hidden state but
    x0, one layer's comp / dcomp, dhid, dx0 and a chunk of 4F rows of A
    (rounded up to 8), and one sign bit per element of every comp but the
    last layer's."""
    tile_b = max(1, min(batch, COLUMN_CHUNK // d))
    ntp = _round_up(tile_b * d, COLUMN_CHUNK)
    if not backward:
        return tile_b, ntp, 4 * (f + 2 * max(layer_sizes)) * ntp
    _, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    hmax = max([f, *next_sizes[:-1]])
    arows = _round_up(HIDDEN_CHUNK * f, 8)
    rows = (f + sum(next_sizes[:-1]) + max(layer_sizes) + hmax + f + arows)
    return tile_b, ntp, 4 * (rows * ntp + sum(layer_sizes[:-1]) * ntp // 32)


def _counts_fit(batch, f, d, layer_sizes, split_half, backward) -> bool:
    """Whether ``stack_smem``'s count fits one block in the forward and,
    with ``backward``, in the backward too."""
    dirs = (False, True) if backward else (False,)
    return all(stack_smem(batch, f, d, layer_sizes, split_half, bwd)[2]
               <= SMEM_PER_BLOCK for bwd in dirs)


def stack_route(
    batch: int, f: int, d: int, layer_sizes: Sequence[int],
    split_half: bool, backward: bool, bf16: bool = False,
) -> str:
    """The route of one direction: "stack" when its stack kernel fits one
    block's shared memory (the backward launches with the forward's tile,
    so it needs both to fit), else "layers". The one gate of both
    directions, as ``stack_tile`` is the JAX package's. ``bf16`` is the
    operand mode (``bf16_operands`` with a bfloat16 x0): its backward is
    "stack" where the forward's count fits and the bf16 kernel's own plan
    (``mma_backward_plan``) does; the f32 mode, and the forward in either,
    go by ``stack_smem``'s counts."""
    if not backward or not bf16:
        fits = _counts_fit(batch, f, d, layer_sizes, split_half, backward)
        return "stack" if fits else "layers"
    if not _counts_fit(batch, f, d, layer_sizes, split_half, False):
        return "layers"
    try:
        mma_backward_plan(batch, f, d, layer_sizes, split_half)
    except ValueError:
        return "layers"
    return "stack"


def plan_tile(
    batch: int, f: int, d: int, layer_sizes: Sequence[int]
) -> tuple[int, int, int]:
    """(tile_b, ntp, smem_bytes) of the forward's route count
    (``stack_smem``). Raises ValueError when that does not fit: where
    ``stack_route`` sends the forward to the layers route."""
    tile_b, ntp, smem = stack_smem(batch, f, d, layer_sizes, False, False)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"CIN stack with F={f}, D={d}, max layer size {max(layer_sizes)} "
            f"needs {smem} bytes of shared memory per block; the limit is "
            f"{SMEM_PER_BLOCK}"
        )
    return tile_b, ntp, smem


# The f32 kernels' plans (csrc/cin_stack.cuh and the .cu files recompute
# them; the constants are theirs): a block of at most F32_THREADS threads,
# 8 x 8 register cells, chunks of at most F32_CHUNK rows k of K, column
# tiles of up to F32_COLUMNS columns.
F32_THREADS = 256
F32_CHUNK = 32
F32_COLUMNS = 128
FULL_WARPS = 16  # warps an SM needs to keep the FP32 pipes fed
CHUNK_STEPS = 8  # a chunk's barrier and copies, in k steps of a cell
_CHUNKS = tuple(F32_CHUNK >> i for i in range(F32_CHUNK.bit_length()))


def _passes(groups: int, cx: int, threads: int) -> tuple[int, int, int]:
    """(passes, row groups a pass, column groups a pass) of a product of
    ``groups`` 8-row groups by ``cx`` 8-column groups on ``threads``
    threads (``passes_of``): whole rows of cells in near-equal passes where
    they fit, else one row group a pass in near-equal column windows."""
    if cx > threads:
        windows = -(-cx // threads)
        return groups * windows, 1, -(-cx // windows)
    n = -(-groups // (threads // cx))
    return n, -(-groups // n), cx


def _blocks_per_sm(threads: int, smem: int, max_regs: int) -> int:
    """Blocks an SM holds (``blocks_per_sm``): at most ``max_regs``
    registers a thread, 2048 threads, its shared memory, 32 blocks."""
    return min(65536 // (threads * max_regs), 2048 // threads,
               SMEM_PER_SM // (smem + SMEM_RESERVED), 32)


def _launch_cost(tiles: int, sms: int, bps: int, threads: int,
                 work: float) -> float:
    """Rounds of blocks over the card's slots, each as long as a block's
    work over the share of its SM it gets (``launch_cost``)."""
    rounds = -(-tiles // (sms * bps))
    return rounds * bps * threads * work / min(bps * threads // 32, FULL_WARPS)


def _tile_candidates(batch: int, d: int) -> list[int]:
    """Samples a tile: as many as fit 128, 64, 32, 16 and 8 columns, at
    least one."""
    out: list[int] = []
    cols = F32_COLUMNS
    while cols >= 8:
        tb = max(1, min(batch, cols // d))
        if not out or out[-1] != tb:
            out.append(tb)
        cols //= 2
    return out


class Fp32ForwardPlan(NamedTuple):
    """One launch of the f32 forward (csrc/cin_stack_fwd.cu): ``tile_b``
    samples a block, their columns padded to ``nt``; ``threads`` threads,
    chunks of at most ``kc`` rows of K; ``nbuf`` hidden buffers of ``hn`` rows; a stage region of ``stage``
    floats; ``smem`` bytes of shared memory; ``blocks_per_sm``."""

    tile_b: int
    nt: int
    threads: int
    kc: int
    nbuf: int
    hn: int
    stage: int
    smem: int
    blocks_per_sm: int


def _fp32_forward_layout(f, d, mpads, next_sizes, tile_b, kc, cap):
    """(threads, nbuf, hn, stage floats, smem bytes) of one forward layout
    of at most ``cap`` threads, the ``layout`` of csrc/cin_stack_fwd.cu."""
    n = len(mpads)
    nt = _round_up(tile_b * d, 8)
    cx = nt // 8
    threads = min(cap, _round_up(max(mpads) // 8 * cx, 32))
    passes = [_passes(mp // 8, cx, threads) for mp in mpads]
    nbuf = 0 if n == 1 else (
        2 if any(p[0] > 1 for p in passes[1:n - 1]) else 1)
    hn = max(next_sizes[: n - 1], default=0)
    stage = 2 * kc * (8 * max(p[1] for p in passes) + 8 * passes[0][2])
    return threads, nbuf, hn, stage, 4 * (f * nt + nbuf * hn * nt + stage)


@functools.lru_cache(maxsize=256)
def fp32_forward_plan(batch: int, f: int, d: int, layer_sizes: tuple,
                      split_half: bool, sms: int = 132) -> Fp32ForwardPlan:
    """The f32 forward's plan on a card of ``sms`` SMs: of every tile
    (``_tile_candidates``), thread count (the cells of the widest layer,
    at most 256, 128, 64 or 32: fewer threads make smaller weight stages)
    and chunk of K rows (32, 16, .., 1) whose shared memory fits a block,
    the one of least ``_launch_cost`` (the first, so the widest, on a
    tie). The work of a block in k steps is every layer's passes x (K =
    H*F and CHUNK_STEPS a chunk). It takes every shape that
    ``stack_route`` sends to the stack forward. Raises ValueError when
    nothing fits. The C launch recomputes it and refuses a mismatch."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    _, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    mpads = [_round_up(m, 8) for m in layer_sizes]
    hs = [f, *next_sizes[:-1]]
    best, best_cost = None, None
    for tb in _tile_candidates(batch, d):
        nt = _round_up(tb * d, 8)
        cx = nt // 8
        need = _round_up(max(mpads) // 8 * cx, 32)
        caps = [F32_THREADS >> i for i in range(F32_THREADS.bit_length())
                if F32_THREADS >> i >= 32
                and (i == 0 or min(F32_THREADS >> i, need)
                     != min(F32_THREADS >> (i - 1), need))]
        for cap, kc in ((c, kc) for c in caps for kc in _CHUNKS):
            threads, nbuf, hn, stage, smem = _fp32_forward_layout(
                f, d, mpads, next_sizes, tb, kc, cap)
            if smem > SMEM_PER_BLOCK:
                continue
            bps = _blocks_per_sm(threads, smem, 128)
            work = 0.0
            for mp, h in zip(mpads, hs):
                work += _passes(mp // 8, cx, threads)[0] * (
                    h * f + -(-h * f // kc) * CHUNK_STEPS)
            cost = _launch_cost(-(-batch // tb), sms, bps, threads, work)
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = Fp32ForwardPlan(tb, nt, threads, kc, nbuf, hn, stage,
                                       smem, bps)
    if best is None:
        raise ValueError(
            f"f32 CIN stack with F={f}, D={d}, layers {layer_sizes} needs "
            f"{_fp32_forward_layout(f, d, mpads, next_sizes, 1, 1, 32)[4]} "
            f"bytes of shared memory per block; the limit is "
            f"{SMEM_PER_BLOCK}")
    return best


class ForwardPlan(NamedTuple):
    """One launch of the bf16 forward kernel: ``tile_b`` samples a block,
    their columns padded to ``ntp``, taken ``columns`` at a time (32 per
    n-group of warps) and ``rows`` maps at a time, the weights streamed in
    chunks of ``chunk`` k16 steps, ``warps`` warps owning up to
    ``warp_tiles`` m16 tiles each (the kernel's instance), ``smem`` bytes
    of shared memory."""

    tile_b: int
    ntp: int
    columns: int
    rows: int
    chunk: int
    warps: int
    warp_tiles: int
    smem: int


def _mma_smem(f: int, d: int, hn: int, maxdir: int, columns: int,
              tile_b: int, rows: int) -> tuple[int, int]:
    """(ntp, bytes) of one bf16-kernel layout: x0 and two hidden buffers in
    bf16, the region of the two weight stages (= rows x columns f32 comps)
    and the pooled sums (the layout in csrc/cin_stack_fwd_mma.cu)."""
    ntp = _round_up(tile_b * d, columns)
    nbytes = (_round_up(2 * f * ntp, 16) + 2 * _round_up(2 * hn * ntp, 16)
              + 4 * rows * columns + _round_up(4 * tile_b * maxdir, 16))
    return ntp, nbytes


def forward_plan(
    batch: int, f: int, d: int, layer_sizes: Sequence[int], split_half: bool
) -> ForwardPlan:
    """The bf16 forward kernel's plan. The two-block instance (8 warps, 4
    m16 tiles a warp) at 128 columns where every layer's maps fit one pass
    of it and two blocks fit an SM (bench.py's CIN); else the one-block
    instance (12 warps, 5 tiles a warp) at the widest column pass
    (128, 64 or 32 columns), then the most maps a pass (a multiple of 16),
    whose shared memory fits one block. It fits every shape whose
    ``stack_smem`` forward count fits (about half of it: bf16 hidden
    states, no f32 comp buffers). Raises ValueError when nothing fits. The
    C launch recomputes it and refuses a mismatch."""
    direct_sizes, next_sizes = cin_layer_sizes(tuple(layer_sizes), split_half)
    hn = max(next_sizes[:-1], default=0)
    maxdir = max(direct_sizes)
    mtop = _round_up(max(layer_sizes), 16)
    for wn in (4, 2, 1):
        columns = MMA_WARP_COLUMNS * wn
        tile_b = 1 if d > columns else min(batch, columns // d)
        warps, tiles = MMA_TWO_BLOCKS
        if wn == 4 and mtop <= warps // wn * 16 * tiles:
            ntp, smem = _mma_smem(f, d, hn, maxdir, columns, tile_b, mtop)
            if smem <= SMEM_TWO_BLOCKS:
                return ForwardPlan(tile_b, ntp, columns, mtop, columns // 16,
                                   warps, tiles, smem)
        warps, tiles = MMA_ONE_BLOCK
        for rows in range(min(mtop, warps // wn * 16 * tiles), 0, -16):
            ntp, smem = _mma_smem(f, d, hn, maxdir, columns, tile_b, rows)
            if smem <= SMEM_PER_BLOCK:
                return ForwardPlan(tile_b, ntp, columns, rows, columns // 16,
                                   warps, tiles, smem)
    raise ValueError(
        f"bf16 CIN stack with F={f}, D={d}, layers {tuple(layer_sizes)} "
        f"needs more shared memory per block than the limit of "
        f"{SMEM_PER_BLOCK} bytes"
    )


def mma_weight(w: torch.Tensor, f: int) -> torch.Tensor:
    """W (M, H*F) as the bf16 kernel reads it: (round_up(M, 16),
    H * round_up(F, 16)) bf16, row-major, column h * round_up(F, 16) + f,
    zeros in the pads; cached until W changes."""
    m, k = w.shape
    h, fp = k // f, _round_up(f, 16)

    def make():
        out = torch.zeros(_round_up(m, 16), h, fp, dtype=torch.bfloat16,
                          device=w.device)
        out[:m, :, :f] = w.detach().reshape(m, h, f)
        return out.reshape(out.shape[0], h * fp)

    return _relayout(w, ("mma", fp), make)


_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cin_stack_fwd": [_P, _P, _PP, _PP, _IP, _IP, _IP, _IP] + [_I] * 9 + [_P],
}


def _check_shapes(x0, weights, biases, layer_sizes, next_sizes) -> None:
    if x0.dim() != 3:
        raise ValueError(f"x0 must be (B, F, D), got shape {tuple(x0.shape)}")
    n = len(layer_sizes)
    if not 1 <= n <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} CIN layers supported, got {n}")
    if len(weights) != n or len(biases) != n:
        raise ValueError(
            f"{n} layers but {len(weights)} weights / {len(biases)} biases"
        )
    f = x0.shape[1]
    h = f
    for i, m in enumerate(layer_sizes):
        if tuple(weights[i].shape) != (m, h * f):
            raise ValueError(
                f"layer {i}: weight shape {tuple(weights[i].shape)}, "
                f"expected {(m, h * f)}"
            )
        if tuple(biases[i].shape) != (m,):
            raise ValueError(
                f"layer {i}: bias shape {tuple(biases[i].shape)}, "
                f"expected {(m,)}"
            )
        h = next_sizes[i]


def _check_inputs(x0, weights, biases, layer_sizes, next_sizes) -> None:
    _check_shapes(x0, weights, biases, layer_sizes, next_sizes)
    if x0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x0 must be float32 or bfloat16, got {x0.dtype}")
    for t in (*weights, *biases):
        if t.device != x0.device:
            raise ValueError(f"all inputs must be on {x0.device}, found "
                             f"{t.device}")


def _cin_stack_cuda(x0, weights, biases, layer_sizes,
                    split_half) -> torch.Tensor:
    """The f32 kernel (csrc/cin_stack_fwd.cu, ``fp32_forward_plan``); a
    bf16 x0 is computed in f32 and the output cast back."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    _check_inputs(x0, weights, biases, layer_sizes, next_sizes)
    dev = x0.device
    bsz, f, d = x0.shape
    out = torch.empty(bsz, sum(direct_sizes), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out.to(x0.dtype)
    x = x0.float().contiguous()
    plan = fp32_forward_plan(bsz, f, d, layer_sizes, split_half,
                             build.sm_count(x))

    # re-layout: k-major weights padded to mpad maps, f32 padded biases
    mpads = [_round_up(m, 8) for m in layer_sizes]
    wts, bs = [], []
    for w, b, mp in zip(weights, biases, mpads):
        wts.append(kmajor_weight(w, torch.float32))
        bs.append(_relayout(b, (mp,), lambda: _zero_padded(
            b, (mp,), torch.float32)))

    n = len(layer_sizes)

    def ints(vs):
        return (ctypes.c_int * n)(*vs)

    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(dev):
        err = lib.cin_stack_fwd(
            x.data_ptr(), out.data_ptr(),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in wts]),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs]),
            ints(layer_sizes), ints(mpads), ints(direct_sizes),
            ints(next_sizes), n, bsz, f, d, plan.tile_b, plan.nt,
            plan.threads, plan.kc, plan.smem, build.stream_of(x),
        )
    build.check(lib, SOURCE, "cin_stack_fwd", err)
    cin_stack_forward.launches += 1
    # wts/bs/x stay referenced until here; the stream orders their reuse
    return out.to(x0.dtype)


_MMA_SIGNATURES = {
    "cin_stack_fwd_mma": [_P, _P, _PP, _PP, _IP, _IP, _IP] + [_I] * 10 + [_P],
}


def _cin_stack_mma_cuda(x0, weights, biases, layer_sizes,
                        split_half) -> torch.Tensor:
    layer_sizes = tuple(int(m) for m in layer_sizes)
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    _check_inputs(x0, weights, biases, layer_sizes, next_sizes)
    bsz, f, d = x0.shape
    out = torch.empty(bsz, sum(direct_sizes), dtype=torch.bfloat16,
                      device=x0.device)
    if bsz == 0:
        return out
    plan = forward_plan(bsz, f, d, layer_sizes, split_half)
    x = x0.contiguous()
    wts = [mma_weight(w, f) for w in weights]
    bs = [b.float().contiguous() for b in biases]
    n = len(layer_sizes)

    def ints(vs):
        return (ctypes.c_int * n)(*vs)

    lib = build.bind(MMA_SOURCE, _MMA_SIGNATURES)
    with build.launch_device(x0.device):
        err = lib.cin_stack_fwd_mma(
            x.data_ptr(), out.data_ptr(),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in wts]),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs]),
            ints(layer_sizes), ints(direct_sizes), ints(next_sizes),
            n, bsz, f, d, plan.tile_b, plan.ntp, plan.columns // MMA_WARP_COLUMNS,
            plan.rows, plan.warp_tiles, plan.smem, build.stream_of(x),
        )
    build.check(lib, MMA_SOURCE, "cin_stack_fwd_mma", err)
    cin_stack_mma.launches += 1
    # wts/bs/x stay referenced until here; the stream orders their reuse
    return out


def cin_stack_mma(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    layer_sizes: Sequence[int],
    split_half: bool,
) -> torch.Tensor:
    """The stack forward in the bf16 operand mode, x0 (B, F, D) bfloat16 ->
    (B, sum(direct)) bfloat16, no autograd graph. A CPU tensor takes the
    plain version; a CUDA tensor launches the tensor-core kernel
    (csrc/cin_stack_fwd_mma.cu) or raises, also where ``forward_plan``
    finds no tile."""
    if x0.dtype != torch.bfloat16:
        raise TypeError(f"x0 must be bfloat16, got {x0.dtype}")
    if x0.device.type == "cpu":
        return cin_stack_plain(x0, weights, biases, layer_sizes, split_half,
                               bf16_operands=True)
    return _cin_stack_mma_cuda(x0, weights, biases, layer_sizes, split_half)


cin_stack_mma.launches = 0


def cin_stack_layers(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    layer_sizes: Sequence[int],
    split_half: bool,
) -> torch.Tensor:
    """The forward's "layers" route: each layer's compression by
    ``cin_compress_layer`` (the per-layer kernel on CUDA, its plain version
    on the CPU), then ReLU, split and sum pooling. The hidden state is
    handed on in x0's dtype, as ``cin_compress_pallas`` returns it; the
    bf16 operand mode does not apply."""
    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    hidden, outs = x0, []
    for i in range(n):
        comp = torch.relu(cin_compress_layer(hidden, x0, weights[i],
                                             biases[i]))
        if split_half and i < n - 1:
            direct, hidden = comp[:, : direct_sizes[i]], comp[:, direct_sizes[i]:]
        else:
            direct = hidden = comp
        outs.append(direct.sum(dim=2))
    return torch.cat(outs, dim=1)


def _cin_stack_raw(x0, weights, biases, layer_sizes, split_half,
                   bf16_operands) -> torch.Tensor:
    """The forward without an autograd graph, down ``stack_route``'s route:
    plain on the CPU, the kernels on CUDA (or a raise)."""
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    bsz, f, d = x0.shape
    if stack_route(bsz, f, d, layer_sizes, split_half, False) == "layers":
        return cin_stack_layers(x0, weights, biases, layer_sizes, split_half)
    if bf16_operands and x0.dtype == torch.bfloat16:
        return cin_stack_mma(x0, weights, biases, layer_sizes, split_half)
    if x0.device.type == "cpu":
        return cin_stack_plain(x0, weights, biases, layer_sizes, split_half)
    return _cin_stack_cuda(x0, weights, biases, layer_sizes, split_half)


def cin_stack_forward(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    layer_sizes: Sequence[int],
    split_half: bool,
    bf16_operands: bool = False,
) -> torch.Tensor:
    """(B, F, D) -> (B, sum(direct)). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (or raises); a stack too large for
    the stack kernel takes the "layers" route (``stack_route``). Where a
    gradient is needed the call goes through ``CinStackFn``, whose backward
    is ``cin_stack_backward``."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x0, *weights, *biases)
    ):
        return CinStackFn.apply(x0, tuple(layer_sizes), split_half,
                                bf16_operands, *weights, *biases)
    return _cin_stack_raw(
        x0, weights, biases, layer_sizes, split_half, bf16_operands
    )


cin_stack_forward.launches = 0


# ---------------------------------------------------------------- backward
#
# Replaces ``deepfm_tpu/ops/pallas/cin_stack_kernel.py`` ::
# ``make_cin_stack_pallas.backward_pallas`` / ``_stack_bwd_kernel`` (the
# ``pl.pallas_call`` of the backward) with two kernels: in f32
# ``csrc/cin_stack_bwd.cu`` (the FP32 pipes), and in the bf16 operand mode
# ``csrc/cin_stack_bwd_mma.cu`` (the tensor cores, ``cin_stack_bwd_mma``;
# its layout and tile are ``mma_backward_plan``'s: the f32 hidden rows in
# shared memory, or in a device-memory region a tile where the resident
# layout would starve the remat; it reads the forward's re-laid weight,
# ``mma_weight``). The
# designs are in the head notes of the .cu files. Bounded by operations:
# three products of a forward's size (remat, A and dW) and the group sums,
# ~500 GFLOP at bench.py's xDeepFM shape.

BWD_SOURCE = "cin_stack_bwd.cu"
BWD_MMA_SOURCE = "cin_stack_bwd_mma.cu"
# The bf16 backward sums dW over K = B*D in at most MAX_SPLITS fixed chunks
# of at least SPLIT_COLUMNS columns each, then adds the partials in order.
SPLIT_COLUMNS = 4096
MAX_SPLITS = 64
# The f32 backward's dW kernel (csrc/cin_stack_bwd.cu): tiles of F32_DW_MAPS
# maps by F32_DW_ROWS outer rows, F32_DW_BLOCKS blocks an SM, steps of
# F32_DW_STEP columns of K; each layer's K is cut into splits of at least
# F32_SPLIT_COLUMNS columns, at most MAX_SPLITS (``dw_splits``).
F32_DW_MAPS, F32_DW_ROWS, F32_DW_BLOCKS, F32_DW_STEP = 128, 128, 2, 32
F32_SPLIT_COLUMNS = 512
_BWD_SIGNATURES = {
    "cin_stack_bwd": [_P, _P, _PP, _PP, _PP, _IP, _IP, _IP, _IP, _IP]
    + [_I] * 11 + [_IP] + [_P] * 5 + [_PP, _P, _P],
}
_BWD_MMA_SIGNATURES = {
    "cin_stack_bwd_mma": [_P, _P, _PP, _PP, _IP, _IP, _IP] + [_I] * 15
    + [_P] * 7 + [_PP, _P, _P],
    "cin_stack_bwd_mma_attributes": [_I, _P],
}
# The bf16 backward's tile kernel (csrc/cin_stack_bwd_mma.cu): 8 warps; the
# remat runs the forward's layer product with up to 4 m16 tiles a warp;
# A = W^T dcomp stages up to 8 row tiles (one hidden row and 16 fields
# each) at a time, 4 where a layer has 1 or 3 hidden rows (its warps split
# the tiles by the parity of h and hold at most 5 each). Its dW kernel
# owns 128 maps x 128 columns (h, f) and stages 64 columns of K, each
# stage row padded by 8 bf16.
MMA_BWD_WARPS = 8
MMA_BWD_TILES = 4
MMA_BWD_A_TILES = (8, 4, 2, 1)
DW_MAPS, DW_COLUMNS, DW_K = 128, 128, 64


def _dcomp(col: torch.Tensor, dhid_next: torch.Tensor | None,
           mask: torch.Tensor, split_here: bool) -> torch.Tensor:
    """The cotangent of one layer's comp (B, M, D): its pooled columns'
    cotangent ``col`` (B, direct) broadcast over d, then the next layer's
    dhid, after the direct maps with split-half or added to them without,
    masked by the ReLU's ``mask`` (comp > 0)."""
    ddirect = col[:, :, None].expand(-1, -1, mask.shape[2])
    if split_here:
        dcomp = torch.cat([ddirect, dhid_next], dim=1)
    elif dhid_next is not None:
        dcomp = ddirect + dhid_next
    else:
        dcomp = ddirect
    return dcomp * mask


def cin_stack_backward_plain(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    layer_sizes: Sequence[int],
    split_half: bool,
    bf16_operands: bool = False,
    dcomp_round: bool = True,
    masks: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """Plain version of the kernel: (dx0, dWs, dbs) of the stack for the
    output cotangent g (B, sum(direct)), the adjoints written out as the
    JAX package's ``backward_xla`` does, with the bf16 mode's rounding
    points (see ``csrc/cin_stack_bwd.cu``). dx0 comes back in x0's dtype,
    each dW and db in its parameter's.

    ``dcomp_round=False`` leaves out the bf16 cast of dcomp before its two
    products: a control that chip_smoke.py's bf16 check must refuse.
    ``masks``, each layer's ReLU mask (B, M_i, D) bool, stand in for this
    remat's comp > 0: the masks of another remat of the same forward
    (chip_smoke.py reads the tensor-core kernel's), so that the two
    backwards differ by their arithmetic alone."""
    bf16 = bf16_operands and x0.dtype == torch.bfloat16

    def op(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).float() if bf16 else t

    layer_sizes = tuple(layer_sizes)
    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    x = x0.float()
    bsz, f, d = x.shape
    # remat: every layer's comp and input hidden state, in f32
    comps, hids = [], []
    hidden = x
    for i in range(n):
        hids.append(hidden)
        pre = cin_compress(
            op(hidden), x, op(weights[i].float()), biases[i].float(), op
        )
        comp = (torch.relu(pre) if masks is None
                else torch.where(masks[i], pre, pre.new_zeros(())))
        comps.append(comp)
        hidden = (comp[:, direct_sizes[i]:] if split_half and i < n - 1
                  else comp)
    g = g.float()
    cols = torch.split(g, list(direct_sizes), dim=1)
    dx0 = torch.zeros_like(x)
    dws: list = [None] * n
    dbs: list = [None] * n
    dhid_next = None
    for i in reversed(range(n)):
        mask = comps[i] > 0 if masks is None else masks[i]
        dcomp = _dcomp(cols[i], dhid_next, mask, split_half and i < n - 1)
        dbs[i] = dcomp.sum(dim=(0, 2))
        dc = op(dcomp) if dcomp_round else dcomp
        hid = hids[i]
        m, h = layer_sizes[i], hid.shape[1]
        outer = op(op(hid)[:, :, None, :] * x[:, None, :, :])  # (B,H,F,D)
        dws[i] = torch.einsum("bmd,bhfd->mhf", dc, outer).reshape(m, h * f)
        w3 = op(weights[i].float()).reshape(m, h, f)
        a = torch.einsum("mhf,bmd->bhfd", w3, dc)
        dhid_next = (a * x[:, None]).sum(dim=2)          # sum over f
        dx0 = dx0 + (a * hid[:, :, None]).sum(dim=1)    # sum over h
    dx0 = dx0 + dhid_next  # the first layer's hidden state is x0
    return (dx0.to(x0.dtype),
            [dw.to(w.dtype) for dw, w in zip(dws, weights)],
            [db.to(b.dtype) for db, b in zip(dbs, biases)])


def dw_splits(m: int, hf: int, k: int, sms: int = 132) -> tuple[int, int]:
    """(splits, columns a split) of one layer's f32 dW product over K = k
    columns (``dw_splits`` of csrc/cin_stack_bwd.cu): of 1 .. min(64,
    k // F32_SPLIT_COLUMNS) splits, a split's columns a multiple of 32, the
    one whose rounds of the dW grid (128-map by 128-row tiles, times the
    splits) over the card's slots times a split's columns is least, the
    fewest on a tie."""
    tiles = -(-hf // F32_DW_ROWS) * -(-m // F32_DW_MAPS)
    slots = sms * F32_DW_BLOCKS
    best, chunk = None, None
    for s in range(1, min(MAX_SPLITS, max(1, k // F32_SPLIT_COLUMNS)) + 1):
        c = _round_up(-(-k // s), F32_DW_STEP)
        cost = -(-(tiles * -(-k // c)) // slots) * c
        if best is None or cost < best:
            best, chunk = cost, c
    return -(-k // chunk), chunk


class Fp32BackwardPlan(NamedTuple):
    """One launch of the f32 backward (csrc/cin_stack_bwd.cu): the tile
    kernel's ``tile_b`` samples a block, their columns padded to ``nt``,
    ``threads`` threads; the remat's chunks of at most ``kc`` rows of K;
    A = W^T dcomp in chunks of ``hc`` hidden rows (``arows`` rows of A),
    ``mc`` maps a weight stage; ``smem`` bytes of shared memory,
    ``blocks_per_sm``; and the dW product's ``splits`` of each layer."""

    tile_b: int
    nt: int
    threads: int
    kc: int
    hc: int
    mc: int
    arows: int
    smem: int
    blocks_per_sm: int
    splits: tuple


@functools.lru_cache(maxsize=256)
def fp32_backward_plan(batch: int, f: int, d: int, layer_sizes: tuple,
                       split_half: bool, sms: int = 132) -> Fp32BackwardPlan:
    """The f32 backward's plan on a card of ``sms`` SMs: of every tile
    (``_tile_candidates``), hidden rows a chunk of A (8..1), maps a weight
    stage of A (32, 16, .., 1) and rows of K a chunk of the remat (32, 16,
    .., 1) whose shared memory fits a block, the one of least
    ``_launch_cost`` (the first on a tie); a block's work in k steps: the
    remat's passes x (K and CHUNK_STEPS a chunk), A's chunks x passes x (M
    and CHUNK_STEPS a weight stage). The layout (csrc/cin_stack_bwd.cu):
    x0, the hidden states of layers 1.. (each layer's dhid is written over
    them), one layer's dcomp and dx0 as f32 rows of nt; one region for the
    remat's stages or a chunk of A and its weight stages; a sign bit per
    comp of every layer but the last. It takes every shape that
    ``stack_route`` sends to the stack backward. Raises ValueError when
    nothing fits. The C launch recomputes it and refuses a mismatch."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    _, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    mpads = [_round_up(m, 8) for m in layer_sizes]
    hs = [f, *next_sizes[:-1]]
    rows = 2 * f + sum(hs[1:]) + max(layer_sizes)
    mask_maps = sum(layer_sizes) - layer_sizes[-1]
    best, best_cost, least = None, None, None
    for tb in _tile_candidates(batch, d):
        nt = _round_up(tb * d, 8)
        cx = nt // 8
        words = -(-nt // 32)
        for hc in range(8, 0, -1):
            arows = _round_up(hc * f, 8)
            gmax = max(arows // 8, max(mpads) // 8)
            threads = min(F32_THREADS, _round_up(gmax * cx, 32))
            passes = [_passes(mp // 8, cx, threads) for mp in mpads]
            wgroups, cols = max(p[1] for p in passes), passes[0][2]
            a_n, a_groups, _ = _passes(arows // 8, cx, threads)
            base = rows * nt + mask_maps * words
            for mc in (32, 16, 8, 4, 2, 1):
                adj = arows * nt + 2 * mc * 8 * a_groups
                adj_work = [-(-h // hc) * a_n * (m + -(-m // mc) * CHUNK_STEPS)
                            for m, h in zip(layer_sizes, hs)]
                for kc in _CHUNKS:
                    stage = 2 * kc * (8 * wgroups + 8 * cols)
                    smem = 4 * (base + max(stage, adj))
                    least = smem if least is None else min(least, smem)
                    if smem > SMEM_PER_BLOCK:
                        continue
                    bps = _blocks_per_sm(threads, smem, 255)
                    work = 0.0
                    for (p_n, _, _), h, aw in zip(passes, hs, adj_work):
                        work += p_n * (h * f + -(-h * f // kc) * CHUNK_STEPS)
                        work += aw
                    cost = _launch_cost(-(-batch // tb), sms, bps, threads,
                                        work)
                    if best_cost is None or cost < best_cost:
                        best_cost = cost
                        best = (tb, nt, threads, kc, hc, mc, arows, smem, bps)
    if best is None:
        raise ValueError(
            f"f32 CIN stack backward with F={f}, D={d}, layers "
            f"{layer_sizes} needs {least} bytes of shared memory per block; "
            f"the limit is {SMEM_PER_BLOCK}")
    splits = tuple(dw_splits(m, h * f, batch * d, sms)[0]
                   for m, h in zip(layer_sizes, hs))
    return Fp32BackwardPlan(*best, splits)


def plan_backward(
    batch: int, f: int, d: int, layer_sizes: Sequence[int], split_half: bool,
    sms: int = 132,
) -> tuple[int, int, int, tuple]:
    """(tile_b, ntp, smem_bytes, splits) of one f32 backward launch: its
    tile, shared memory and dW splits (``fp32_backward_plan``). Raises
    ValueError where ``stack_route`` sends the backward to the layers route
    (the forward's or the backward's ``stack_smem`` count does not fit)."""
    plan_tile(batch, f, d, layer_sizes)
    smem = stack_smem(batch, f, d, layer_sizes, split_half, True)[2]
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"CIN stack backward with F={f}, D={d}, layers "
            f"{tuple(layer_sizes)} needs {smem} bytes of shared memory per "
            f"block; the limit is {SMEM_PER_BLOCK}"
        )
    p = fp32_backward_plan(batch, f, d, tuple(layer_sizes), split_half, sms)
    return p.tile_b, p.nt, p.smem, p.splits


class BackwardPlan(NamedTuple):
    """One launch of the bf16 backward: ``tile_b`` samples a block, their
    columns padded to ``ntp``, their cotangent staged in shared memory if
    ``g_staged``; the remat (the forward's layer product) takes
    ``columns`` columns and ``rows`` maps a pass, ``chunk`` k16 steps a
    weight stage; A = W^T dcomp stages ``a_tiles`` row tiles x ``a_steps``
    map steps of 16; ``smem`` bytes of shared memory for the tile kernel,
    whose f32 hidden rows, dhid and dx0 sums are in shared memory or, if
    ``streamed``, in a device-memory region a tile; dW is summed in ``splits`` chunks of K by a kernel of
    ``dw_smem`` bytes of shared memory."""

    tile_b: int
    ntp: int
    columns: int
    g_staged: bool
    rows: int
    chunk: int
    a_tiles: int
    a_steps: int
    smem: int
    splits: int
    dw_smem: int
    streamed: bool


def _dw_smem(h: int, f: int) -> int:
    """The dW kernel's two stages for a layer of h hidden rows: 128 dcomp
    rows, the hidden rows and the x0 rows a block's 128 columns (h, f)
    touch, each row DW_K + 8 bf16."""
    rows = DW_MAPS + min(h, (DW_COLUMNS - 1) // f + 2) + min(f, DW_COLUMNS)
    return 2 * rows * (DW_K + 8) * 2


def _mma_bwd_smem(f, d, tile_b, columns, g_bytes, rows, a_tiles, a_steps,
                  msum, hsum, hin, hmax, mp16max,
                  streamed) -> tuple[int, int]:
    """(ntp, bytes) of one tile-kernel layout (csrc/cin_stack_bwd_mma.cu):
    x0 in bf16, a sign bit per comp, one layer's dcomp in bf16 and x0 in
    f32 (dcomp's and the f32 x0's rows ntp + 8 long), ``g_bytes`` of the
    tile's cotangent; resident, every hidden state, dhid and two dx0 (one
    per group of A's warps, rows ntp + 8 long) in f32 and one region for
    the remat's weight stages or A's transposed ones; streamed (those f32
    rows in device memory), the input rows of the layer the remat is at in
    bf16 (hin rows) and the remat's weight stages after them, or A's
    stages over both."""
    ntp = _round_up(tile_b * d, columns)
    remat = 4 * rows * columns
    adj = 2 * a_steps * 16 * (32 * a_tiles + 16)
    nbytes = (_round_up(2 * f * ntp, 16) + _round_up(msum * ntp // 8, 16)
              + _round_up(2 * mp16max * (ntp + 8), 16)
              + 4 * f * (ntp + 8) + g_bytes)
    if streamed:
        nbytes += max(_round_up(2 * hin * ntp, 16) + remat, adj)
    else:
        nbytes += (4 * hsum * ntp + 4 * hmax * ntp + 2 * 4 * f * (ntp + 8)
                   + max(remat, adj))
    return ntp, nbytes


def mma_backward_plan(
    batch: int, f: int, d: int, layer_sizes: Sequence[int], split_half: bool
) -> BackwardPlan:
    """The bf16 backward's plan, in one of two layouts of the tile kernel.
    Resident: every f32 state of the tile in shared memory; the widest
    column pass (128, 64 or 32 columns), then the tile's cotangent staged
    in shared memory, then the most maps a remat pass, then the most A
    tiles and map steps a stage, whose tile kernel fits one block's shared
    memory. Streamed: each layer's f32 hidden rows, dhid and A's dx0 sums
    in a device-memory region a tile, shared memory holding the remat's
    current input rows in bf16, so wide stacks fit; the widest column pass
    with one remat pass of every map (as many as its warps take), then the
    cotangent staged, then the most A tiles and map steps.
    The resident plan is taken where it fits with a full remat pass, and
    on every shape whose ``stack_smem`` backward count fits (the shapes the
    stack route took before the streamed layout, whose plans and bits it
    keeps); elsewhere the streamed plan where it fits (the paper's Criteo
    CIN, whose resident plan runs 16-map passes), else the resident one.
    Raises ValueError when nothing fits. The C launch recomputes it (in the
    layout given) and refuses a mismatch."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    plan = _mma_backward_plan(batch, f, d, layer_sizes, bool(split_half))
    if plan is None:
        raise ValueError(
            f"bf16 CIN stack backward with F={f}, D={d}, layers "
            f"{layer_sizes} needs more shared memory per block than "
            f"the limit of {SMEM_PER_BLOCK} bytes"
        )
    return plan


@functools.lru_cache(maxsize=256)
def _mma_backward_plan(batch: int, f: int, d: int, layer_sizes: tuple,
                       split_half: bool) -> BackwardPlan | None:
    plan = _mma_layout_plan(batch, f, d, layer_sizes, split_half, False)
    full = min(_round_up(max(layer_sizes), 16),
               MMA_BWD_WARPS // (plan.columns // MMA_WARP_COLUMNS) * 16
               * MMA_BWD_TILES) if plan else 0
    kept = stack_smem(batch, f, d, layer_sizes, split_half,
                      True)[2] <= SMEM_PER_BLOCK
    if plan is None or not (kept or plan.rows == full):
        plan = _mma_layout_plan(batch, f, d, layer_sizes, split_half,
                                True) or plan
    return plan


def _mma_layout_plan(batch: int, f: int, d: int, layer_sizes: tuple,
                     split_half: bool, streamed: bool) -> BackwardPlan | None:
    """``mma_backward_plan``'s search in one layout; None where nothing
    fits."""
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    hs = [f, *next_sizes[:-1]]
    msum, hsum, hmax = sum(layer_sizes), sum(hs[1:]), max(hs)
    hin = max(hs[1:], default=0)
    mp16max = _round_up(max(layer_sizes), 16)
    splits = max(1, min(MAX_SPLITS, -(-batch * d // SPLIT_COLUMNS)))
    dw_smem = max(_dw_smem(h, f) for h in hs)
    a_tiles_top = MMA_BWD_A_TILES[1] if {1, 3} & set(hs) else MMA_BWD_A_TILES[0]
    for wn in (4, 2, 1):
        columns = MMA_WARP_COLUMNS * wn
        tile_b = 1 if d > columns else min(batch, columns // d)
        most = MMA_BWD_WARPS // wn * 16 * MMA_BWD_TILES
        full = min(mp16max, most)
        for g_staged in (True, False):
            g_bytes = _round_up(4 * tile_b * sum(direct_sizes), 16) * g_staged
            for rows in range(full, full - 1 if streamed else 0, -16):
                for a_tiles in (t for t in MMA_BWD_A_TILES
                                if t <= a_tiles_top):
                    for a_steps in range(mp16max // 16, 0, -1):
                        ntp, smem = _mma_bwd_smem(
                            f, d, tile_b, columns, g_bytes, rows, a_tiles,
                            a_steps, msum, hsum, hin, hmax, mp16max,
                            streamed)
                        if smem <= SMEM_PER_BLOCK:
                            return BackwardPlan(
                                tile_b, ntp, columns, g_staged, rows,
                                columns // 16, a_tiles, a_steps, smem,
                                splits, dw_smem, streamed)
    return None


def _chunked(w: torch.Tensor, h: int, f: int, hc: int = HIDDEN_CHUNK):
    """W (M, H*F) in f32, m-major by chunks of ``hc`` hidden rows, each
    chunk's hc*F columns zero-padded to a multiple of 8 (the f32 kernel
    stages 8 aligned weights at a time): (M, ceil(H / hc) * that)."""
    m = w.shape[0]
    chunks = -(-h // hc)
    width = hc * f
    f32 = dict(dtype=torch.float32, device=w.device)
    out = torch.zeros(m, chunks, _round_up(width, 8), **f32)
    full = torch.zeros(m, chunks * width, **f32)
    full[:, : h * f] = w.detach()
    out[:, :, :width] = full.reshape(m, chunks, width)
    return out.reshape(m, -1)


def _check_cotangent(x0, weights, biases, g, layer_sizes, next_sizes,
                     direct_sizes) -> None:
    _check_inputs(x0, weights, biases, layer_sizes, next_sizes)
    if g.device != x0.device:
        raise ValueError(f"all inputs must be on {x0.device}, found {g.device}")
    if tuple(g.shape) != (x0.shape[0], sum(direct_sizes)):
        raise ValueError(
            f"g has shape {tuple(g.shape)}, expected "
            f"{(x0.shape[0], sum(direct_sizes))}"
        )


def _zero_grads(x0, weights, biases):
    return (torch.zeros_like(x0), [torch.zeros_like(w) for w in weights],
            [torch.zeros_like(b) for b in biases])


def _cin_stack_bwd_cuda(x0, weights, biases, g, layer_sizes, split_half):
    """The f32 kernels (csrc/cin_stack_bwd.cu, ``fp32_backward_plan``); a
    bf16 x0 is computed in f32 and dx0 cast back."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    _check_cotangent(x0, weights, biases, g, layer_sizes, next_sizes,
                     direct_sizes)
    dev = x0.device
    bsz, f, d = x0.shape
    n = len(layer_sizes)
    hs = [f, *next_sizes[:-1]]
    f32 = dict(dtype=torch.float32, device=dev)
    if bsz == 0:
        return _zero_grads(x0, weights, biases)
    x = x0.float().contiguous()
    plan = fp32_backward_plan(bsz, f, d, layer_sizes, split_half,
                              build.sm_count(x))
    gg = g.float().contiguous()
    mpads = [_round_up(m, 8) for m in layer_sizes]
    wts, wms, bs = [], [], []
    for w, b, mp, h in zip(weights, biases, mpads, hs):
        wts.append(kmajor_weight(w, torch.float32))
        wms.append(_relayout(w, ("chunked", plan.hc),
                             lambda: _chunked(w, h, f, plan.hc)))
        bs.append(_relayout(b, (mp,), lambda: _zero_padded(
            b, (mp,), torch.float32)))
    kpads = [t.shape[1] for t in wms]
    # every output element is written by the kernels
    dx0 = torch.empty(bsz, f, d, **f32)
    dws = [torch.empty(m, h * f, **f32) for m, h in zip(layer_sizes, hs)]
    db = torch.empty(sum(layer_sizes), **f32)
    k = bsz * d
    dcomp = torch.empty(sum(layer_sizes), k, **f32)
    hid = torch.empty(max(sum(hs[1:]), 1), k, **f32)
    db_part = torch.empty(-(-bsz // plan.tile_b), sum(layer_sizes), **f32)
    dw_part = torch.empty(sum(s * m * h * f for s, m, h in zip(
        plan.splits, layer_sizes, hs)), **f32)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    def ints(vs):
        return (ctypes.c_int * n)(*vs)

    lib = build.bind(BWD_SOURCE, _BWD_SIGNATURES)
    with build.launch_device(dev):
        err = lib.cin_stack_bwd(
            x.data_ptr(), gg.data_ptr(), ptrs(wts), ptrs(wms), ptrs(bs),
            ints(layer_sizes), ints(mpads), ints(direct_sizes),
            ints(next_sizes), ints(kpads), n, bsz, f, d, plan.tile_b, plan.nt,
            plan.threads, plan.kc, plan.hc, plan.mc, plan.smem,
            ints(plan.splits), dx0.data_ptr(), dcomp.data_ptr(),
            hid.data_ptr(), db_part.data_ptr(), dw_part.data_ptr(), ptrs(dws),
            db.data_ptr(), build.stream_of(x),
        )
    build.check(lib, BWD_SOURCE, "cin_stack_bwd", err)
    cin_stack_backward.launches += 1
    # the workspace stays referenced until here; the stream orders its reuse
    dbs = torch.split(db, list(layer_sizes))
    return (dx0.to(x0.dtype),
            [dw.to(w.dtype) for dw, w in zip(dws, weights)],
            [v.to(b.dtype) for v, b in zip(dbs, biases)])


def _cin_stack_bwd_mma_cuda(x0, weights, biases, g, layer_sizes, split_half,
                            workspace: dict | None = None):
    """The launch of ``cin_stack_bwd_mma`` on the card. ``workspace``, if
    given, receives the dW step's bf16 rows, each round_up(B*D, 8) columns
    (b*D + d): ``dcomp`` (each layer's maps, after its ReLU mask) and
    ``hid`` (the hidden state of each layer past the first), for a check
    to read."""
    layer_sizes = tuple(int(m) for m in layer_sizes)
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    _check_cotangent(x0, weights, biases, g, layer_sizes, next_sizes,
                     direct_sizes)
    bsz, f, d = x0.shape
    if bsz == 0:
        return _zero_grads(x0, weights, biases)
    plan = mma_backward_plan(bsz, f, d, layer_sizes, split_half)
    dev = x0.device
    n = len(layer_sizes)
    hs = [f, *next_sizes[:-1]]
    f32 = dict(dtype=torch.float32, device=dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    x = x0.contiguous()
    gg = g.float().contiguous()
    wts = [mma_weight(w, f) for w in weights]
    bs = [b.float().contiguous() for b in biases]
    # every output element is written by the kernels
    dx0 = torch.empty(bsz, f, d, **f32)
    dws = [torch.empty(m, h * f, **f32) for m, h in zip(layer_sizes, hs)]
    db = torch.empty(sum(layer_sizes), **f32)
    # the dW step's bf16 workspace, rows of round_up(B*D, 8) columns
    kp = _round_up(bsz * d, 8)
    xt = torch.empty(f, kp, **bf)
    hid = torch.empty(max(sum(hs[1:]), 1), kp, **bf)
    dcomp = torch.empty(sum(layer_sizes), kp, **bf)
    db_part = torch.empty(-(-bsz // plan.tile_b), sum(layer_sizes), **f32)
    dw_part = torch.empty(
        plan.splits * sum(m * h * f for m, h in zip(layer_sizes, hs)), **f32)
    # streamed: a region a tile of its f32 hidden rows (sum_{i>0} H_i rows of
    # ntp columns), its two dx0 sums (2 x F rows of ntp + 8) and dhid (max
    # H_i rows of ntp)
    tile_floats = ((sum(hs[1:]) + max(hs)) * plan.ntp
                   + 2 * f * (plan.ntp + 8))
    tile_ws = torch.empty(
        -(-bsz // plan.tile_b) * tile_floats if plan.streamed else 1, **f32)

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    def ints(vs):
        return (ctypes.c_int * n)(*vs)

    lib = build.bind(BWD_MMA_SOURCE, _BWD_MMA_SIGNATURES)
    with build.launch_device(dev):
        err = lib.cin_stack_bwd_mma(
            x.data_ptr(), gg.data_ptr(), ptrs(wts), ptrs(bs),
            ints(layer_sizes), ints(direct_sizes), ints(next_sizes),
            n, bsz, f, d, plan.tile_b, plan.ntp,
            plan.columns // MMA_WARP_COLUMNS, int(plan.g_staged), plan.rows,
            plan.a_tiles,
            plan.a_steps, plan.smem, plan.splits, plan.dw_smem,
            int(plan.streamed),
            dx0.data_ptr(), xt.data_ptr(), hid.data_ptr(), dcomp.data_ptr(),
            db_part.data_ptr(), dw_part.data_ptr(), tile_ws.data_ptr(),
            ptrs(dws), db.data_ptr(), build.stream_of(x),
        )
    build.check(lib, BWD_MMA_SOURCE, "cin_stack_bwd_mma", err)
    cin_stack_bwd_mma.launches += 1
    if workspace is not None:
        workspace.update(dcomp=dcomp, hid=hid)
    # the workspace stays referenced until here; the stream orders its reuse
    dbs = torch.split(db, list(layer_sizes))
    return (dx0.to(x0.dtype),
            [dw.to(w.dtype) for dw, w in zip(dws, weights)],
            [v.to(b.dtype) for v, b in zip(dbs, biases)])


def bwd_mma_attributes(t: torch.Tensor, plan: BackwardPlan) -> dict:
    """The compiled bf16 tile kernel on ``t``'s card: registers and local
    memory (bytes) a thread, static shared memory (bytes), and the blocks
    an SM holds at the plan's shared memory."""
    lib = build.bind(BWD_MMA_SOURCE, _BWD_MMA_SIGNATURES)
    out = (ctypes.c_int * 4)()
    with build.launch_device(t.device):
        err = lib.cin_stack_bwd_mma_attributes(plan.smem,
                                               ctypes.addressof(out))
    build.check(lib, BWD_MMA_SOURCE, "cin_stack_bwd_mma_attributes", err)
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "blocks_per_sm"), out))


def cin_stack_bwd_mma(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    layer_sizes: Sequence[int],
    split_half: bool,
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """The stack backward in the bf16 operand mode: (dx0, dWs, dbs) for x0
    (B, F, D) bfloat16 and the output cotangent g. A CPU tensor takes the
    plain version; a CUDA tensor launches the tensor-core kernels
    (csrc/cin_stack_bwd_mma.cu) or raises, also where
    ``mma_backward_plan`` finds no tile."""
    if x0.dtype != torch.bfloat16:
        raise TypeError(f"x0 must be bfloat16, got {x0.dtype}")
    if x0.device.type == "cpu":
        return cin_stack_backward_plain(x0, weights, biases, g, layer_sizes,
                                        split_half, bf16_operands=True)
    return _cin_stack_bwd_mma_cuda(x0, weights, biases, g, layer_sizes,
                                   split_half)


cin_stack_bwd_mma.launches = 0


def cin_stack_backward_layers(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    layer_sizes: Sequence[int],
    split_half: bool,
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """The backward's "layers" route, the algorithm of the JAX package's
    ``backward_xla`` (``cin_stack_kernel.py:775-840``): every layer's comp
    recomputed in f32 by ``cin_compress_layer`` (the per-layer kernel on
    CUDA, its plain version on the CPU), then, last layer first, dcomp and
    the layer's adjoints dhid, dx0, dW and db (``cin_compress_backward``:
    f32 einsums and matmuls). f32 throughout, as there: the bf16 operand
    mode does not apply. dx0 comes back in x0's dtype, each dW and db in
    its parameter's."""
    layer_sizes = tuple(layer_sizes)
    direct_sizes, _ = cin_layer_sizes(layer_sizes, split_half)
    n = len(layer_sizes)
    x = x0.float()
    comps, hids, hidden = [], [], x
    for i in range(n):
        hids.append(hidden)
        comp = torch.relu(cin_compress_layer(
            hidden, x, weights[i].float(), biases[i].float()))
        comps.append(comp)
        hidden = (comp[:, direct_sizes[i]:] if split_half and i < n - 1
                  else comp)
    cols = torch.split(g.float(), list(direct_sizes), dim=1)
    dx0 = torch.zeros_like(x)
    dws: list = [None] * n
    dbs: list = [None] * n
    dhid_next = None
    for i in reversed(range(n)):
        dcomp = _dcomp(cols[i], dhid_next, comps[i] > 0,
                       split_half and i < n - 1)
        dhid_next, dx, dws[i], dbs[i] = cin_compress_backward(
            dcomp, hids[i], x, weights[i])
        dx0 = dx0 + dx
    dx0 = dx0 + dhid_next  # the first layer's hidden state is x0
    return (dx0.to(x0.dtype),
            [dw.to(w.dtype) for dw, w in zip(dws, weights)],
            [db.to(b.dtype) for db, b in zip(dbs, biases)])


def cin_stack_backward(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    g: torch.Tensor,
    layer_sizes: Sequence[int],
    split_half: bool,
    bf16_operands: bool = False,
) -> tuple[torch.Tensor, list[torch.Tensor], list[torch.Tensor]]:
    """(dx0, dWs, dbs) of the stack for the output cotangent g. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (or
    raises): the bf16 operand mode with a bfloat16 x0 the tensor-core one
    (``cin_stack_bwd_mma``), else the f32 one; a stack whose backward does
    not fit the stack kernel of its operand mode takes the "layers" route
    (``stack_route``, ``cin_stack_backward_layers``)."""
    if x0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x0.device}")
    bsz, f, d = x0.shape
    bf16 = bf16_operands and x0.dtype == torch.bfloat16
    if stack_route(bsz, f, d, layer_sizes, split_half, True, bf16) == "layers":
        return cin_stack_backward_layers(x0, weights, biases, g, layer_sizes,
                                         split_half)
    if bf16:
        return cin_stack_bwd_mma(x0, weights, biases, g, layer_sizes,
                                 split_half)
    if x0.device.type == "cpu":
        return cin_stack_backward_plain(x0, weights, biases, g, layer_sizes,
                                        split_half)
    return _cin_stack_bwd_cuda(x0, weights, biases, g, layer_sizes,
                               split_half)


cin_stack_backward.launches = 0


class CinStackFn(torch.autograd.Function):
    """The CIN stack with its backward: ``cin_stack_forward``'s raw
    forward, and ``cin_stack_backward``. Saves only x0, the weights and the
    biases; the backward recomputes the forward (remat, as the JAX
    package's custom_vjp does).

    apply(x0, layer_sizes, split_half, bf16_operands, *weights, *biases)
    """

    @staticmethod
    def forward(ctx, x0, layer_sizes, split_half, bf16_operands, *params):
        n = len(layer_sizes)
        ctx.cfg = (layer_sizes, split_half, bf16_operands)
        ctx.save_for_backward(x0, *params)
        return _cin_stack_raw(x0, params[:n], params[n:], layer_sizes,
                              split_half, bf16_operands)

    @staticmethod
    def backward(ctx, g):
        layer_sizes, split_half, bf16_operands = ctx.cfg
        x0, *params = ctx.saved_tensors
        n = len(layer_sizes)
        dx0, dws, dbs = cin_stack_backward(
            x0, params[:n], params[n:], g, layer_sizes, split_half,
            bf16_operands,
        )
        return (dx0, None, None, None, *dws, *dbs)
