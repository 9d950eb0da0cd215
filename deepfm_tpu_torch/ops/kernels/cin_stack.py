"""CIN-stack forward: the hand-written CUDA kernel and its plain version.

Replaces ``deepfm_tpu/ops/pallas/cin_stack_kernel.py`` ::
``make_cin_stack_pallas.forward`` / ``_stack_kernel`` (the
``pl.pallas_call`` of the forward). Source: ``csrc/cin_stack_fwd.cu``.

What it computes. Given x0 (B, F, D), per-layer weights W_i (M_i, H_i*F)
in the parameter's own h-major layout (column h*F + f) and biases b_i, each
layer is comp = relu(sum_{h,f} W_i[m, h*F+f] * hid[b,h,d] * x0[b,f,d] +
b_i[m]); with split-half every layer but the last pools its first M_i//2
maps and hands the rest on as the next hidden state, otherwise all maps do
both; the output is concat_i sum_d direct_i, shape (B, sum(direct_i)).

What bounds it on an H100: operations, not bytes. At bench.py's xDeepFM
shape (B=16384, F=27, D=16, [128,128] split) a forward is ~165 GFLOP
against ~41 MB of f32 input and output; only x0, the weights and the
pooled output touch device memory. The kernel keeps every per-layer
feature map and the outer product in shared memory and registers (one
block of 128 threads per tile of samples, an 8x8 register tile per
thread, the outer product formed on the fly), so the work is bounded by
the FP32 FMA rate; tensor cores (wgmma) are later work. See the .cu file
for the design.

Re-layout done here, not in the kernel: the weights are transposed to
k-major (K_i, mpad_i), zero-padded to mpad_i = round_up(M_i, 8) maps
(cast to bf16 in bf16 mode), and the biases padded and cast to f32. The
re-laid-out copies are cached per weight and bias tensor and made again
only when that tensor changes (its version counter or storage moves), so
a served model pays for them once, not per request. The TPU kernel's f-major chunking, VMEM budgets and (F, D, B) transpose are
TPU artifacts and are not carried over. Neither is its gate: the kernel
takes any B >= 1, F, D and layer sizes (odd splits included) and masks
the ragged edges itself; the only refusal is a shape whose tile does not
fit in shared memory, which raises here.

bf16 mode (``bf16_operands`` with a bfloat16 x0) follows the TPU kernel:
bf16 operands (x0, weights, the outer product), f32 accumulation, f32 bias
add, ReLU and pooling, the hidden state rounded to bf16 between layers,
and the output cast to bf16. The TPU additionally requires every hidden
height to be a multiple of 16 for this mode and otherwise runs f32; the
port has no such gate, so at other heights the two differ by bf16
rounding. bf16 input without ``bf16_operands`` computes in f32.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from deepfm_tpu_torch.ops.cin import cin_compress, cin_layer_sizes

SOURCE = "cin_stack_fwd.cu"
MAX_LAYERS = 8
# Hopper: at most 227 KB of shared memory per block.
SMEM_PER_BLOCK = 232_448
# A block is 8 x 16 threads, each owning 8 columns and 8 maps: a column
# chunk of 64 (kTX * kTN in the .cu file).
COLUMN_CHUNK = 64


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_tile(
    batch: int, f: int, d: int, layer_sizes: Sequence[int]
) -> tuple[int, int, int]:
    """(tile_b, ntp, smem_bytes) for one launch.

    A block holds tile_b samples as tile_b*d columns padded to ntp, a
    multiple of the column chunk, in (f + 2*max(M)) rows of f32 shared
    memory. Raises ValueError when that does not fit.
    """
    tile_b = max(1, min(batch, COLUMN_CHUNK // d))
    ntp = _round_up(tile_b * d, COLUMN_CHUNK)
    smem = 4 * (f + 2 * max(layer_sizes)) * ntp
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"CIN stack with F={f}, D={d}, max layer size {max(layer_sizes)} "
            f"needs {smem} bytes of shared memory per block; the limit is "
            f"{SMEM_PER_BLOCK}"
        )
    return tile_b, ntp, smem


def _zero_padded(t: torch.Tensor, shape: tuple, dtype: torch.dtype):
    out = torch.zeros(shape, dtype=dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t.detach()
    return out


# tensor -> (key, re-laid-out copy); entries die with their tensor
_relayout_cache = WeakTensorKeyDictionary()


def _relayout(
    t: torch.Tensor, key: tuple, make: Callable[[], torch.Tensor]
) -> torch.Tensor:
    """``make()``, cached on ``t`` until t changes in place or is given
    new storage. Inference tensors carry no version counter and are
    re-laid out on every call."""
    if t.is_inference():
        return make()
    full = (key, t.data_ptr(), t._version)
    hit = _relayout_cache.get(t)
    if hit is not None and hit[0] == full:
        return hit[1]
    out = make()
    _relayout_cache[t] = (full, out)
    return out


def _lib() -> ctypes.CDLL:
    from deepfm_tpu_torch.ops.kernels import build

    lib = build.load(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.cin_stack_fwd.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ptrs, ptrs]
            + [ints] * 4
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p]
        )
        lib.cin_stack_fwd.restype = ctypes.c_int
        lib.cin_stack_error_string.argtypes = [ctypes.c_int]
        lib.cin_stack_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


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


def _cin_stack_cuda(x0, weights, biases, layer_sizes, split_half,
                    bf16_operands) -> torch.Tensor:
    layer_sizes = tuple(int(m) for m in layer_sizes)
    direct_sizes, next_sizes = cin_layer_sizes(layer_sizes, split_half)
    _check_shapes(x0, weights, biases, layer_sizes, next_sizes)
    if x0.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x0 must be float32 or bfloat16, got {x0.dtype}")
    dev = x0.device
    for t in (*weights, *biases):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, found {t.device}")
    bf16 = bf16_operands and x0.dtype == torch.bfloat16
    op_dt = torch.bfloat16 if bf16 else torch.float32
    bsz, f, d = x0.shape
    out = torch.empty(bsz, sum(direct_sizes), dtype=op_dt, device=dev)
    if bsz == 0:
        return out.to(x0.dtype)
    x = x0.to(op_dt).contiguous()
    tile_b, ntp, _ = plan_tile(bsz, f, d, layer_sizes)

    # re-layout: k-major weights padded to mpad maps, f32 padded biases
    mpads = [_round_up(m, 8) for m in layer_sizes]
    wts, bs = [], []
    for w, b, mp in zip(weights, biases, mpads):
        wts.append(_relayout(w, (op_dt, mp), lambda: _zero_padded(
            w.t(), (w.shape[1], mp), op_dt)))
        bs.append(_relayout(b, (mp,), lambda: _zero_padded(
            b, (mp,), torch.float32)))

    n = len(layer_sizes)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cin_stack_fwd(
            x.data_ptr(), out.data_ptr(),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in wts]),
            (ctypes.c_void_p * n)(*[t.data_ptr() for t in bs]),
            (ctypes.c_int * n)(*layer_sizes),
            (ctypes.c_int * n)(*mpads),
            (ctypes.c_int * n)(*direct_sizes),
            (ctypes.c_int * n)(*next_sizes),
            n, bsz, f, d, tile_b, ntp, int(bf16), stream,
        )
    if err != 0:
        raise RuntimeError(
            "cin_stack_fwd launch failed: "
            + lib.cin_stack_error_string(err).decode()
        )
    cin_stack_forward.launches += 1
    # wts/bs/x stay referenced until here; the stream orders their reuse
    return out.to(x0.dtype)


def cin_stack_forward(
    x0: torch.Tensor,
    weights: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    layer_sizes: Sequence[int],
    split_half: bool,
    bf16_operands: bool = False,
) -> torch.Tensor:
    """(B, F, D) -> (B, sum(direct)). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (or raises). The kernel has no
    backward yet, so on CUDA it refuses inputs that would need one; the
    serving path runs under ``torch.inference_mode``."""
    if x0.device.type == "cpu":
        return cin_stack_plain(
            x0, weights, biases, layer_sizes, split_half, bf16_operands
        )
    if x0.device.type != "cuda":
        raise ValueError(f"unsupported device {x0.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x0, *weights, *biases)
    ):
        raise RuntimeError(
            "cin_stack_forward on CUDA has no backward yet (it comes with "
            "the training slice): call it under torch.inference_mode() or "
            "torch.no_grad()"
        )
    return _cin_stack_cuda(
        x0, weights, biases, layer_sizes, split_half, bf16_operands
    )


cin_stack_forward.launches = 0
