"""One CIN layer: a hand-written CUDA kernel for its compression, its plain
version and ``CinCompressFn``, which gives it the JAX package's gradient.

Replaces ``deepfm_tpu/ops/pallas/cin_kernel.py`` :: ``cin_compress_pallas``
/ ``_cin_kernel`` (the ``pl.pallas_call`` at :97). Source:
``csrc/cin_compress.cu``.

What it computes. (B,H,D) hidden, (B,F,D) x0, (M,H*F) W in the
parameter's own h-major layout (column h*F + f), (M,) b -> (B,M,D),
pre-ReLU:

  out[b,m,d] = sum_{h,f} W[m, h*F+f] * hidden[b,h,d] * x0[b,f,d] + b[m]

As the TPU kernel does: the inputs are cast to f32, the sum is taken in
f32, the bias added in f32, and the result cast back to hidden's dtype.

What bounds it on an H100: operations. At the xDeepFM paper's Criteo
shape (B=4096, F=27, D=10, 200 maps, H=200) a layer is 88.7 GFLOP against
74 MB of f32 input and output. The kernel is one GEMM with M rows, N = B*D
columns and K = H*F, whose B operand (the outer product) is formed chunk by
chunk in shared memory from the hidden state and x0 and never written to
device memory; it runs on the FP32 FMA pipes (no TF32). A block owns every
map of a map tile (up to 256), so each chunk of the outer product is formed
once; ``compress_plan`` sets the tiles, the block and the grid, and the C
launch recomputes it. K is streamed, so any H, F, M, D and B fit: this
kernel is the CIN stack's route for stacks too large for one block's shared
memory (``cin_stack.stack_route``). See the .cu file for the design.

Left out: the TPU kernel's VMEM tile gate and its jnp fallback
(``cin_kernel.py:51-69, 84-89``) are TPU artifacts; this kernel runs
every shape.

Re-layout done here, not in the kernel: the weight is transposed to
k-major (K, mpad), zero-padded to mpad = round_up(M, 8) maps, f32, and
cached per weight tensor until it changes (``_relayout``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from deepfm_tpu_torch.ops.cin import cin_compress, cin_outer
from deepfm_tpu_torch.ops.kernels import build

SOURCE = "cin_compress.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "cin_compress": [_P] * 5 + [_I] * 10 + [_P],
    "cin_compress_attributes": [_I, _I, _P],
}

# The plan of csrc/cin_compress.cu (its constants of the same names)
SMEM_PER_BLOCK = 232_448  # Hopper: at most 227 KB of shared memory a block
SMEM_PER_SM = 233_472  # 228 KB an SM, of which a block reserves 1 KB
SMEM_RESERVED = 1024
THREADS = 256  # kThreads: threads of a block, at most
MIN_THREADS = 128  # kMinThreads: threads of a block, at least
MAX_GROUPS = 32  # kMaxGroups: 8-map groups of a map tile (256 maps)
MIN_CX, MAX_CX = 8, 10  # kMinCx, kMaxCx: 8-column groups of a tile
CHUNK = 32  # kBK: K rows (fields of one hidden row) a chunk, at most
STAGES = 2  # weight, x0 and hidden stages and product buffers, each
WEIGHT_PITCH = MAX_GROUPS * 8  # kWP: floats a weight stage row
ROW_PITCH = MAX_CX * 8  # kBP: floats an x0, hidden or product row


def x0_resident(f: int) -> bool:
    """Whether a block stages all F rows of x0 once (else by chunk)."""
    return f <= 2 * CHUNK


def compress_smem(f: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes``): two weight
    stages, two product buffers, two hidden rows and x0 (F rows, or two
    stages of CHUNK rows)."""
    x_rows = f if x0_resident(f) else STAGES * CHUNK
    return 4 * (STAGES * CHUNK * WEIGHT_PITCH + STAGES * CHUNK * ROW_PITCH
                + STAGES * ROW_PITCH + x_rows * ROW_PITCH)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _zero_padded(t: torch.Tensor, shape: tuple, dtype: torch.dtype):
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t.detach()
    return out


# tensor -> {"state": (storage, version), key: re-laid-out copy}; entries
# die with their tensor
_relayout_cache = WeakTensorKeyDictionary()


def _relayout(
    t: torch.Tensor, key: tuple, make: Callable[[], torch.Tensor]
) -> torch.Tensor:
    """``make()``, cached on ``t`` under ``key`` until t changes in place or
    is given new storage (each CIN kernel keeps its copies of a weight).
    Inference tensors carry no version counter and are re-laid out on
    every call."""
    if t.is_inference():
        return make()
    state = (t.data_ptr(), t._version)
    entries = _relayout_cache.get(t)
    if entries is None or entries["state"] != state:
        entries = _relayout_cache[t] = {"state": state}
    out = entries.get(key)
    if out is None:
        out = entries[key] = make()
    return out


def kmajor_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W (M, K) as the CIN kernels read it: k-major (K, round_up(M, 8)),
    zero-padded, in ``dtype``, cached until W changes."""
    mp = _round_up(w.shape[0], 8)
    return _relayout(w, (dtype, mp), lambda: _zero_padded(
        w.t(), (w.shape[1], mp), dtype))


class CompressPlan(NamedTuple):
    """The launch of ``cin_compress`` over N = B*D columns and M maps.

    The maps, padded to ``mp`` (a multiple of 8), are cut into
    ``map_tiles`` tiles of ``tile_maps`` (a whole number of 8-map groups,
    at most 256); the columns into ``col_tiles`` tiles of ``tile_cols`` =
    8 * ``cx``. A block of ``threads`` threads owns one (column tile, map
    tile): thread t < (tile_maps / 8) * cx owns the 8 x 8 cell of map group
    t // cx and column group t % cx. ``grid`` is (col_tiles,
    map_tiles); ``smem`` the dynamic shared memory of a block;
    ``blocks_per_sm`` the blocks an SM holds (at most 128 registers a
    thread, the launch bounds), ``waves`` the grid over the card's slots.
    """

    n: int
    m: int
    mp: int
    map_tiles: int
    tile_maps: int
    cx: int
    threads: int
    col_tiles: int
    smem: int
    blocks_per_sm: int
    sms: int

    @property
    def tile_cols(self) -> int:
        return 8 * self.cx

    @property
    def grid(self) -> tuple[int, int]:
        return self.col_tiles, self.map_tiles

    @property
    def waves(self) -> float:
        return self.col_tiles * self.map_tiles / (self.sms * self.blocks_per_sm)

    @property
    def wave_fill(self) -> float:
        """Share of the slots of the launch's rounds that hold a block."""
        slots = self.sms * self.blocks_per_sm
        blocks = self.col_tiles * self.map_tiles
        return blocks / (-(-blocks // slots) * slots)

    @property
    def padded_maps(self) -> int:
        """Maps computed on zero weights: past M, up to the tiles' end."""
        return self.map_tiles * self.tile_maps - self.m


def _blocks_per_sm(threads: int, smem: int) -> int:
    return min(65536 // (threads * 128), SMEM_PER_SM // (smem + SMEM_RESERVED))


def _plan_threads(groups: int, cx: int) -> int:
    # every cell, and at least MIN_THREADS (a thread for each position of
    # an x0 row)
    return _round_up(max(groups * cx, MIN_THREADS), 32)


@functools.lru_cache(maxsize=256)
def compress_plan(bsz: int, f: int, d: int, m: int,
                  sms: int = 132) -> CompressPlan:
    """The plan of ``cin_compress`` for B=``bsz``, F=``f``, D=``d`` and
    ``m`` maps on a card of ``sms`` SMs (H does not enter it: K is
    streamed). Map tiles: ceil(groups / 32) of equal whole groups. cx: of
    8..10 (as the cells fit 256 threads), the one whose rounds of blocks
    times warps a block is least, the widest on a tie, so the last wave is
    nearly full. Shared memory depends on F alone (``compress_smem``)."""
    if bsz < 0 or f < 1 or d < 1 or m < 1:
        raise ValueError(f"no plan for B={bsz}, F={f}, D={d}, M={m}")
    smem = compress_smem(f)
    n = bsz * d
    mp = _round_up(m, 8)
    groups = mp // 8
    map_tiles = -(-groups // MAX_GROUPS)
    tile_groups = -(-groups // map_tiles)
    best = None
    for cx in range(MAX_CX, MIN_CX - 1, -1):
        if tile_groups * cx > THREADS:
            continue
        threads = _plan_threads(tile_groups, cx)
        tiles = -(-n // (8 * cx))
        slots = sms * _blocks_per_sm(threads, smem)
        cost = -(-(tiles * map_tiles) // slots) * (threads // 32)
        if best is None or cost < best[0]:
            best = (cost, cx, threads, tiles)
    _, cx, threads, tiles = best
    return CompressPlan(n, m, mp, map_tiles, 8 * tile_groups, cx, threads,
                        tiles, smem, _blocks_per_sm(threads, smem), sms)


def compress_attributes(t: torch.Tensor, plan: CompressPlan) -> dict:
    """The compiled kernel on ``t``'s card: registers and local memory
    (bytes) a thread, static shared memory (bytes), and the blocks an SM
    holds at the plan's threads and shared memory."""
    lib = build.bind(SOURCE, _SIGNATURES)
    out = (ctypes.c_int * 4)()
    with build.launch_device(t.device):
        err = lib.cin_compress_attributes(plan.threads, plan.smem,
                                          ctypes.addressof(out))
    build.check(lib, SOURCE, "cin_compress_attributes", err)
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "blocks_per_sm"), out))


def cin_compress_plain(hidden: torch.Tensor, x0: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``ops/cin.py::cin_compress``
    (the JAX package's oracle) on f32 casts, cast back to hidden's dtype.
    Materialises the outer product."""
    return cin_compress(hidden.float(), x0.float(), w.float(),
                        b.float()).to(hidden.dtype)


def _check(hidden, x0, w, b) -> None:
    if hidden.dim() != 3 or x0.dim() != 3:
        raise ValueError(f"hidden and x0 must be (B, H, D) and (B, F, D), got "
                         f"{tuple(hidden.shape)} and {tuple(x0.shape)}")
    bsz, h, d = hidden.shape
    f = x0.shape[1]
    if (x0.shape[0], x0.shape[2]) != (bsz, d):
        raise ValueError(f"x0 {tuple(x0.shape)} does not match hidden "
                         f"{tuple(hidden.shape)}")
    if w.dim() != 2 or w.shape[1] != h * f:
        raise ValueError(f"weight shape {tuple(w.shape)}, expected "
                         f"(M, {h * f})")
    if tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias shape {tuple(b.shape)}, expected "
                         f"{(w.shape[0],)}")
    for t in (x0, w, b):
        if t.device != hidden.device:
            raise ValueError(f"all inputs must be on {hidden.device}, found "
                             f"{t.device}")


def _cin_compress_cuda(hidden, x0, w, b) -> torch.Tensor:
    bsz, h, d = hidden.shape
    f = x0.shape[1]
    m = w.shape[0]
    dev = hidden.device
    out = torch.empty(bsz, m, d, dtype=torch.float32, device=dev)
    if bsz * d == 0:
        return out.to(hidden.dtype)
    hid = hidden.float().contiguous()
    x = x0.float().contiguous()
    wt = kmajor_weight(w, torch.float32)
    bias = b.float().contiguous()
    plan = compress_plan(bsz, f, d, m, sms=build.sm_count(hid))
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(dev):
        err = lib.cin_compress(
            hid.data_ptr(), x.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bsz, h, f, d, m, wt.shape[1], plan.tile_maps,
            plan.cx, plan.threads, plan.smem, build.stream_of(hid),
        )
    build.check(lib, SOURCE, "cin_compress", err)
    cin_compress_layer.launches += 1
    # hid/x/wt/bias stay referenced until here; the stream orders their reuse
    return out.to(hidden.dtype)


def _cin_compress_raw(hidden, x0, w, b) -> torch.Tensor:
    """The layer without an autograd graph: plain on the CPU, the kernel on
    CUDA (or a raise)."""
    if hidden.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hidden.device}")
    _check(hidden, x0, w, b)
    if hidden.device.type == "cpu":
        return cin_compress_plain(hidden, x0, w, b)
    return _cin_compress_cuda(hidden, x0, w, b)


def cin_compress_layer(hidden: torch.Tensor, x0: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,H,D),(B,F,D),(M,H*F),(M,) -> (B,M,D) pre-ReLU in hidden's dtype.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises). Where a gradient is needed the call goes through
    ``CinCompressFn``."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (hidden, x0, w, b)
    ):
        return CinCompressFn.apply(hidden, x0, w, b)
    return _cin_compress_raw(hidden, x0, w, b)


cin_compress_layer.launches = 0


def cin_compress_backward(g: torch.Tensor, hidden: torch.Tensor,
                          x0: torch.Tensor, w: torch.Tensor):
    """(dhid, dx0, dW, db) of one layer for the cotangent g (B,M,D), all
    f32: the four contractions of ``cin_kernel.py:133-150`` (which XLA
    computes outside any kernel), written pairwise so that the largest
    intermediate is one (B, H*F, D) tensor: A = W^T g, then dhid = sum_f
    A x0, dx0 = sum_h A hid, dW = g . outer^T over (b, d), db = sum g."""
    g, hid, x, w = g.float(), hidden.float(), x0.float(), w.float()
    bsz, h, d = hid.shape
    f = x.shape[1]
    a = torch.einsum("mk,bmd->bkd", w, g).reshape(bsz, h, f, d)
    dhid = (a * x[:, None]).sum(dim=2)
    dx0 = (a * hid[:, :, None]).sum(dim=1)
    dw = torch.einsum("bmd,bkd->mk", g, cin_outer(hid, x))
    db = g.sum(dim=(0, 2))
    return dhid, dx0, dw, db


class CinCompressFn(torch.autograd.Function):
    """One CIN layer with the gradient of ``cin_compress_pallas``'s
    custom_vjp: the forward is ``cin_compress_layer``'s kernel (or plain
    version), the backward ``cin_compress_backward``, each gradient cast
    to its input's dtype.

    apply(hidden, x0, w, b)
    """

    @staticmethod
    def forward(ctx, hidden, x0, w, b):
        ctx.save_for_backward(hidden, x0, w, b)
        return _cin_compress_raw(hidden, x0, w, b)

    @staticmethod
    def backward(ctx, g):
        hidden, x0, w, b = ctx.saved_tensors
        dhid, dx0, dw, db = cin_compress_backward(g, hidden, x0, w)
        return (dhid.to(hidden.dtype), dx0.to(x0.dtype), dw.to(w.dtype),
                db.to(b.dtype))
