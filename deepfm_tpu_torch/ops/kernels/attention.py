"""Field self-attention block: the hand-written CUDA kernels (forward and
backward) and their plain versions.

Replaces ``deepfm_tpu/ops/pallas/attention_fmajor_kernel.py`` ::
``make_attention_block_fmajor`` → ``forward`` / ``_attn_fwd_kernel`` and
``backward`` / ``_attn_bwd_kernel``. Sources: ``csrc/attention_block.cu``
(forward) and ``csrc/attention_bwd.cu`` (backward), both built from
``csrc/attention_tile.cuh``; each design is in its source's head note, and
each kernel's plan (``forward_plan``, ``backward_plan``) is computed here
and recomputed by its launch.

What it computes, per sample x (F, d) in the compute type (x's dtype):
q/k/v = x · W + b in f32, a softmax over the F key fields per head in f32,
the context in f32, ``out = cast(ctx) · wo + bo``, then with residual
LayerNorm(out + x) · ln_scale + ln_bias (eps 1e-5), cast to x's dtype. The
weights are cast to the compute type, the biases and LayerNorm parameters
stay f32: the TPU kernel's rounding points. The JAX package's
``block_oracle`` (its fallback where the kernel is ineligible) computes
everything in bf16 instead; in f32 the two agree.

The port keeps the ``(B, F, d)`` layout at every function: the TPU
kernel's ``(F, d, B)`` transpose (batch on the 128-lane axis), its tile
gate (B % 128, hd % 8, d % 8) and its VMEM budget are TPU artifacts. The
kernels take any B, F, d and heads dividing a; they raise only where a
block's shared memory would exceed 227 KB (``forward_plan``,
``backward_plan``).

What bounds them on an H100: bytes (x read, out written) for the forward at
bench.py's shape, operations (~20 GFLOP) for the backward, if every
operation ran at the bf16 tensor-core rate; both run their projections on
the tensor cores in bf16 and the attention core on the FP32 pipes, whose
rate bounds them more (the mixed bound, see the .cu files).

AutoInt's interacting layer (Song et al., CIKM 2019, section 4.4) is the
second pair of kernels in the same sources (``interacting_fwd``,
``interacting_bwd``): per sample, [q|k|v|res] = x · [wq|wk|wv|wres] with no
biases, an unscaled softmax over the F key fields per head (``scale`` 1),
``out = ReLU(ctx + res)`` of width a, in x's dtype. Rounding points: x and
the weights in the compute type into the products; q/k/v/res, scores,
softmax, context and the residual sum in f32; the output cast once; in the
backward [dq|dk|dv|dres] cast to the compute type before its two products
(dW and dx). Plans: ``interacting_forward_plan``,
``interacting_backward_plan`` (the backward's attention core is the tiled
core of ``csrc/attention_tile.cuh`` on all warps where its layout fits,
with the lane-per-query core's bits; ``interacting_backward.tiled_launches``
counts those launches beside ``launches``, and the tracing counter
``attention.tiled_core_rows`` their rows); plain versions
``interacting_plain``, ``interacting_backward_plain``; the autograd
Function ``InteractingLayerFn``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from deepfm_tpu_torch.ops.kernels import build
from deepfm_tpu_torch.utils import tracing

SOURCE = "attention_block.cu"
BWD_SOURCE = "attention_bwd.cu"
LN_EPS = 1e-5
SMEM_PER_BLOCK = 232_448  # Hopper: at most 227 KB of shared memory a block
SMEM_PER_SM = 233_472  # 228 KB an SM, of which a block reserves 1 KB
SMEM_RESERVED = 1024
# the backward's block count (one block an SM of an H100 SXM, a constant so
# that the bits do not depend on the card) fixes the partition of its
# gradient sums; the forward has no cross-sample sums and fills the card
BWD_BLOCKS = 132
WARPS = 8  # 256 threads a block, both kernels
MAX_SAMPLES = 8  # samples a tile, at most, both kernels
PARAM_NAMES = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
LN_NAMES = ("ln_scale", "ln_bias")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
INTERACT_NAMES = ("wq", "wk", "wv", "wres")
INTERACT_SCALE = 1.0  # AutoInt's scores: the unscaled inner product
_SIGNATURES = {
    "attention_block_fwd": [_P] * 8 + [_I] * 5 + [_F] + [_I] * 7 + [_P],
    "attention_block_fwd_attributes": [_I, _I, _P],
    "interacting_fwd": [_P] * 3 + [_I] * 5 + [_F] + [_I] * 6 + [_P],
    "interacting_fwd_attributes": [_I, _I, _P],
}
_BWD_SIGNATURES = {
    "attention_bwd": [_P] * 10 + [_I] * 6 + [_F] + [_I] * 6 + [_P],
    "interacting_bwd": [_P] * 6 + [_I] * 6 + [_F] + [_I] * 6 + [_P],
}


@functools.lru_cache(maxsize=None)
def head_scale(head_dim: int) -> float:
    """1 / sqrt(hd), computed in f32 as the TPU kernel does."""
    hd = torch.tensor(float(head_dim), dtype=torch.float32)
    return float(1.0 / torch.sqrt(hd))


def _geometry(x: torch.Tensor, p: dict, num_heads: int):
    bsz, f, d = x.shape
    a = p["wq"].shape[1]
    if num_heads < 1 or a % num_heads != 0:
        raise ValueError(
            f"attention_dim ({a}) must be divisible by num_heads ({num_heads})"
        )
    return bsz, f, d, a, a // num_heads


def _recompute(x: torch.Tensor, p: dict, num_heads: int):
    """(xf, op, wqkv, q, k, v, w, ctx) of the forward, in f32."""
    cdt = x.dtype

    def op(t: torch.Tensor) -> torch.Tensor:
        return t.to(cdt).float()

    bsz, f, d, a, hd = _geometry(x, p, num_heads)
    xf = x.float()
    wqkv = op(torch.cat([p["wq"], p["wk"], p["wv"]], dim=1).float())
    bqkv = torch.cat([p["bq"], p["bk"], p["bv"]]).float()
    qkv = xf @ wqkv + bqkv
    q, k, v = (t.reshape(bsz, f, num_heads, hd)
               for t in torch.split(qkv, a, dim=2))
    s = torch.einsum("bihe,bjhe->bhij", q, k) * head_scale(hd)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhij,bjhe->bihe", w, v).reshape(bsz, f, a)
    return xf, op, wqkv, q, k, v, w, ctx


def _layer_norm_parts(y: torch.Tensor):
    mean = y.mean(dim=-1, keepdim=True)
    yc = y - mean
    var = (yc * yc).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + LN_EPS)
    return yc * inv, inv


def attention_block_plain(x: torch.Tensor, p: dict, num_heads: int,
                          use_residual: bool,
                          ctx_round: bool = True) -> torch.Tensor:
    """Plain version of the forward kernel, (B, F, d) -> (B, F, d) in x's
    dtype, with the kernel's rounding points.

    ``ctx_round=False`` leaves out the cast of the context to the compute
    type before the output projection: a control that chip_smoke.py's bf16
    check must refuse."""
    xf, op, _, _, _, _, _, ctx = _recompute(x, p, num_heads)
    out = (op(ctx) if ctx_round else ctx) @ op(p["wo"].float()) \
        + p["bo"].float()
    if use_residual:
        yn, _ = _layer_norm_parts(out + xf)
        out = yn * p["ln_scale"].float() + p["ln_bias"].float()
    return out.to(x.dtype)


def attention_block_backward_plain(x: torch.Tensor, p: dict, g: torch.Tensor,
                                   num_heads: int, use_residual: bool,
                                   dall_round: bool = True):
    """Plain version of the backward kernel: (dx in x's dtype, {name:
    gradient in the parameter's dtype}) for the output cotangent g.

    ``dall_round=False`` leaves out the cast of [dq|dk|dv] to the compute
    type before its two products: a control that chip_smoke.py's bf16
    check must refuse."""
    xf, op, wqkv, q, k, v, w, ctx = _recompute(x, p, num_heads)
    bsz, f, d, a, hd = _geometry(x, p, num_heads)
    gf = g.float()
    grads = {}
    if use_residual:
        y = op(ctx) @ op(p["wo"].float()) + p["bo"].float() + xf
        yn, inv = _layer_norm_parts(y)
        grads["ln_scale"] = (gf * yn).sum(dim=(0, 1))
        grads["ln_bias"] = gf.sum(dim=(0, 1))
        dyn = gf * p["ln_scale"].float()
        dout = inv * (dyn - dyn.mean(dim=-1, keepdim=True)
                      - yn * (dyn * yn).mean(dim=-1, keepdim=True))
        dx = dout
    else:
        dout = gf
        dx = torch.zeros_like(xf)
    grads["bo"] = dout.sum(dim=(0, 1))
    grads["wo"] = torch.einsum("bfj,bfc->jc", op(ctx), op(dout))
    dctx = (op(dout) @ op(p["wo"].float()).t()).reshape(bsz, f, num_heads, hd)
    dw = torch.einsum("bihe,bjhe->bhij", dctx, v)
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True)) * head_scale(hd)
    dq = torch.einsum("bhij,bjhe->bihe", ds, k)
    dk = torch.einsum("bhij,bihe->bjhe", ds, q)
    dv = torch.einsum("bhij,bihe->bjhe", w, dctx)
    dall = torch.cat([t.reshape(bsz, f, a) for t in (dq, dk, dv)], dim=2)
    dall_op = op(dall) if dall_round else dall
    dwqkv = torch.einsum("bfj,bfc->cj", dall_op, xf)
    dbqkv = dall.sum(dim=(0, 1))
    for i, name in enumerate(("q", "k", "v")):
        grads[f"w{name}"] = dwqkv[:, i * a:(i + 1) * a]
        grads[f"b{name}"] = dbqkv[i * a:(i + 1) * a]
    dx = dx + dall_op @ wqkv.t()
    return dx.to(x.dtype), {n: t.to(p[n].dtype) for n, t in grads.items()}


def _check(x: torch.Tensor, p: dict, use_residual: bool) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, F, d), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    d = x.shape[2]
    a = p["wq"].shape[1]
    shapes = {"wq": (d, a), "wk": (d, a), "wv": (d, a), "bq": (a,),
              "bk": (a,), "bv": (a,), "wo": (a, d), "bo": (d,)}
    if use_residual:
        shapes.update(ln_scale=(d,), ln_bias=(d,))
    for name, shape in shapes.items():
        t = p[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def n_grad(d: int, a: int) -> int:
    """Floats of one block's gradient partials: dWqkv, dbqkv, dWo, dbo,
    dls, dlb."""
    return d * 3 * a + 3 * a + a * d + 3 * d


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _row_stride(n: int) -> int:
    """A multiple of 4 floats that is not a multiple of 8 (the .cu's
    row_stride): the 8 rows of an mma fragment start on distinct banks."""
    s = _up(n, 4)
    return s + 4 if s % 8 == 0 else s


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """One backward block's work and shared memory (csrc/attention_bwd.cu's
    make_plan / choose_plan, which the launch recomputes and checks).

    samples: samples a tile (rows = samples * F, padded to 16); core_warps:
    warps that run the attention core (the lane-per-query core: one
    (sample, head) each at a time; the tiled core: all of them on every
    pair); smem: dynamic shared memory in bytes; tiled: the interacting
    backward's tiled core and layout; grid: blocks for batch ``bsz``."""
    samples: int
    core_warps: int
    rows: int
    smem: int
    tiled: bool = False

    def grid(self, bsz: int) -> int:
        return min(-(-bsz // self.samples), BWD_BLOCKS)


def _bwd_floats(f: int, d: int, a: int, h: int, samples: int,
                core_warps: int) -> int:
    hdp = _up(a // h, 4)
    ap = _up(h * hdp, 16)
    n3, dp = 3 * ap, _up(d, 16)
    ws, os_ = _row_stride(n3), _row_stride(dp)
    rows = _up(samples * f, 16)
    weights = dp * ws + ap * os_ + n3 + 2 * dp  # wqkv, wo, bqkv, bo, ls
    grads = dp * ws + ap * os_ + n3 + 3 * dp    # their accumulators, dls, dlb
    tile = rows * (3 * _row_stride(dp) + _row_stride(n3) + _row_stride(ap))
    # w and ds of each core warp's (sample, head); between the two cores
    # the tile's g and the column sums' partials
    scratch = max(core_warps * 2 * f * (f | 1),
                  rows * _row_stride(dp) + 3 * max(WARPS * 32, d))
    return weights + grads + tile + scratch


def _choose_backward(floats, what: str, f: int, d: int, a: int,
                     num_heads: int) -> BackwardPlan:
    for nc in range(WARPS, 0, -1):
        for s in range(MAX_SAMPLES, 0, -1):
            if nc > s * num_heads:
                continue
            smem = 4 * floats(f, d, a, num_heads, s, nc)
            if smem <= SMEM_PER_BLOCK:
                return BackwardPlan(s, nc, _up(s * f, 16), smem)
    smem = 4 * floats(f, d, a, num_heads, 1, 1)
    raise ValueError(
        f"{what} backward with F={f}, d={d}, a={a}, H={num_heads} "
        f"needs {smem} bytes of shared memory per block; the limit is "
        f"{SMEM_PER_BLOCK}"
    )


def backward_plan(f: int, d: int, a: int, num_heads: int) -> BackwardPlan:
    """The most core warps, then the most samples a tile, that fit one
    block; raises ValueError where one sample and one warp do not."""
    return _choose_backward(_bwd_floats, "attention block", f, d, a,
                            num_heads)


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """One forward block's work and shared memory (csrc/attention_block.cu's
    make_fwd_plan / choose_fwd_plan, which the launch recomputes and
    checks).

    samples: samples a tile (rows = samples * F, padded to 16); core_warps:
    warps that run the attention core, one (sample, head) each at a time;
    smem: dynamic shared memory in bytes; blocks_per_sm: the blocks an SM
    is planned to hold."""
    samples: int
    core_warps: int
    rows: int
    smem: int
    blocks_per_sm: int

    def tiles(self, bsz: int) -> int:
        return -(-bsz // self.samples)

    def grid(self, bsz: int, sms: int) -> int:
        """A block a tile, at most blocks_per_sm on each of ``sms`` SMs."""
        return min(self.tiles(bsz), self.blocks_per_sm * sms)


def _fwd_floats(f: int, d: int, a: int, h: int, samples: int,
                core_warps: int) -> int:
    hdp = _up(a // h, 4)
    ap = _up(h * hdp, 16)
    n3, dp = 3 * ap, _up(d, 16)
    rows = _up(samples * f, 16)
    weights = dp * _row_stride(n3) + ap * _row_stride(dp) + n3 + 3 * dp
    tile = rows * (_row_stride(dp) + _row_stride(n3) + _row_stride(ap))
    # each core warp's scores, and each row's LayerNorm mean and 1/std
    return weights + tile + core_warps * f * (f | 1) + 2 * rows


@functools.lru_cache(maxsize=None)
def forward_plan(f: int, d: int, a: int, num_heads: int) -> ForwardPlan:
    """For one and for two blocks an SM, the most core warps and then the
    most samples a tile that fit a block's share of the SM's shared
    memory; of the two, the one with more core warps an SM (two blocks on a
    tie). Raises ValueError where one sample and one warp do not fit one
    block."""
    return _choose_forward(_fwd_floats, "attention block", f, d, a,
                           num_heads)


def _choose_forward(floats, what: str, f: int, d: int, a: int,
                    num_heads: int) -> ForwardPlan:
    best = None
    for blocks in (2, 1):
        limit = min(SMEM_PER_BLOCK, SMEM_PER_SM // blocks - SMEM_RESERVED)
        fit = next(((nc, s, smem) for nc in range(WARPS, 0, -1)
                    for s in range(MAX_SAMPLES, 0, -1) if nc <= s * num_heads
                    for smem in [4 * floats(f, d, a, num_heads, s, nc)]
                    if smem <= limit), None)
        if fit and (best is None
                    or fit[0] * blocks > best.core_warps * best.blocks_per_sm):
            nc, s, smem = fit
            best = ForwardPlan(s, nc, _up(s * f, 16), smem, blocks)
    if best is None:
        smem = 4 * floats(f, d, a, num_heads, 1, 1)
        raise ValueError(
            f"{what} forward with F={f}, d={d}, a={a}, "
            f"H={num_heads} needs {smem} bytes of shared memory per block; "
            f"the limit is {SMEM_PER_BLOCK}"
        )
    return best


def plan(f: int, d: int, a: int, num_heads: int, backward: bool) -> int:
    """Dynamic shared memory (bytes) of one block; raises ValueError where
    it does not fit."""
    if backward:
        return backward_plan(f, d, a, num_heads).smem
    return forward_plan(f, d, a, num_heads).smem


def _operands(x: torch.Tensor, p: dict, use_residual: bool):
    """The weights in the compute type and the f32 vectors, contiguous."""
    cdt, d = x.dtype, x.shape[2]
    wqkv = torch.cat([p["wq"], p["wk"], p["wv"]], dim=1).to(cdt).contiguous()
    bqkv = torch.cat([p["bq"], p["bk"], p["bv"]]).float().contiguous()
    wo = p["wo"].to(cdt).contiguous()
    bo = p["bo"].float().contiguous()
    if use_residual:
        ls = p["ln_scale"].float().contiguous()
        lb = p["ln_bias"].float().contiguous()
    else:
        ls = torch.ones(d, dtype=torch.float32, device=x.device)
        lb = torch.zeros(d, dtype=torch.float32, device=x.device)
    return wqkv, bqkv, wo, bo, ls, lb


def _forward_cuda(x, p, num_heads, use_residual) -> torch.Tensor:
    _check(x, p, use_residual)
    bsz, f, d, a, hd = _geometry(x, p, num_heads)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if bsz == 0:
        return out
    fp = forward_plan(f, d, a, num_heads)
    x = x.contiguous()
    wqkv, bqkv, wo, bo, ls, lb = _operands(x, p, use_residual)
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(x.device):
        err = lib.attention_block_fwd(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), ls.data_ptr(), lb.data_ptr(), out.data_ptr(),
            bsz, f, d, a, num_heads, head_scale(hd), int(use_residual),
            int(x.dtype == torch.bfloat16), fp.samples, fp.core_warps,
            fp.blocks_per_sm, fp.grid(bsz, build.sm_count(x)), fp.smem,
            build.stream_of(x),
        )
    build.check(lib, SOURCE, "attention_block_fwd", err)
    attention_block_forward.launches += 1
    return out


def forward_attributes(x: torch.Tensor, fp: ForwardPlan,
                       entry: str = "attention_block_fwd_attributes") -> dict:
    """The compiled forward kernel for x's dtype on x's card: registers and
    local memory (bytes) a thread, static shared memory (bytes), and the
    blocks an SM holds at the plan's shared memory. ``entry`` names the
    block's kernel or, ``interacting_fwd_attributes``, the interacting
    layer's."""
    lib = build.bind(SOURCE, _SIGNATURES)
    out = (ctypes.c_int * 4)()
    with build.launch_device(x.device):
        err = getattr(lib, entry)(
            int(x.dtype == torch.bfloat16), fp.smem, ctypes.addressof(out))
    build.check(lib, SOURCE, entry, err)
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "blocks_per_sm"), out))


def _backward_cuda(x, p, g, num_heads, use_residual):
    _check(x, p, use_residual)
    bsz, f, d, a, hd = _geometry(x, p, num_heads)
    if tuple(g.shape) != tuple(x.shape) or g.device != x.device:
        raise ValueError(
            f"g {tuple(g.shape)} on {g.device} does not match x "
            f"{tuple(x.shape)} on {x.device}"
        )
    n = n_grad(d, a)
    flat = torch.zeros(n, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if bsz > 0:
        bp = backward_plan(f, d, a, num_heads)
        x = x.contiguous()
        gg = g.float().contiguous()
        wqkv, bqkv, wo, bo, ls, _ = _operands(x, p, use_residual)
        grid = bp.grid(bsz)
        part = torch.empty(grid, n, dtype=torch.float32, device=x.device)
        lib = build.bind(BWD_SOURCE, _BWD_SIGNATURES)
        with build.launch_device(x.device):
            err = lib.attention_bwd(
                x.data_ptr(), gg.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                wo.data_ptr(), bo.data_ptr(), ls.data_ptr(), dx.data_ptr(),
                part.data_ptr(), flat.data_ptr(), n, bsz, f, d, a, num_heads,
                head_scale(hd), int(use_residual),
                int(x.dtype == torch.bfloat16), bp.samples, bp.core_warps,
                grid, bp.smem, build.stream_of(x),
            )
        build.check(lib, BWD_SOURCE, "attention_bwd", err)
        attention_block_backward.launches += 1
    else:
        dx.zero_()
    dwqkv, dbqkv, dwo, dbo, dls, dlb = torch.split(
        flat, [d * 3 * a, 3 * a, a * d, d, d, d])
    dwqkv = dwqkv.reshape(d, 3 * a)
    grads = {"wo": dwo.reshape(a, d), "bo": dbo}
    for i, name in enumerate(("q", "k", "v")):
        grads[f"w{name}"] = dwqkv[:, i * a:(i + 1) * a]
        grads[f"b{name}"] = dbqkv[i * a:(i + 1) * a]
    if use_residual:
        grads["ln_scale"], grads["ln_bias"] = dls, dlb
    return dx, {n_: t.to(p[n_].dtype) for n_, t in grads.items()}


def attention_block_forward(x: torch.Tensor, p: dict, num_heads: int,
                            use_residual: bool) -> torch.Tensor:
    """One attention block, (B, F, d) -> (B, F, d), without an autograd
    graph. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if x.device.type == "cpu":
        return attention_block_plain(x, p, num_heads, use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _forward_cuda(x, p, num_heads, use_residual)


attention_block_forward.launches = 0


def attention_block_backward(x: torch.Tensor, p: dict, g: torch.Tensor,
                             num_heads: int, use_residual: bool):
    """(dx in x's dtype, {name: gradient in the parameter's dtype}) of one
    block for the output cotangent g. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if x.device.type == "cpu":
        return attention_block_backward_plain(x, p, g, num_heads,
                                              use_residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _backward_cuda(x, p, g, num_heads, use_residual)


attention_block_backward.launches = 0


def param_names(use_residual: bool) -> tuple[str, ...]:
    return PARAM_NAMES + (LN_NAMES if use_residual else ())


class AttentionBlockFn(torch.autograd.Function):
    """One attention block with its backward kernel. Saves x and the
    parameters; the backward recomputes the forward (as the TPU kernel's
    custom_vjp does).

    apply(x, num_heads, use_residual, *params), the parameters in the
    order of ``param_names(use_residual)``.
    """

    @staticmethod
    def forward(ctx, x, num_heads, use_residual, *params):
        ctx.cfg = (num_heads, use_residual)
        ctx.save_for_backward(x, *params)
        p = dict(zip(param_names(use_residual), params))
        return attention_block_forward(x, p, num_heads, use_residual)

    @staticmethod
    def backward(ctx, g):
        num_heads, use_residual = ctx.cfg
        x, *params = ctx.saved_tensors
        names = param_names(use_residual)
        with tracing.span("model.attention_backward"):
            dx, dp = attention_block_backward(
                x, dict(zip(names, params)), g, num_heads, use_residual)
        return (dx, None, None, *(dp[n] for n in names))


def attention_block(x: torch.Tensor, p: dict, num_heads: int,
                    use_residual: bool) -> torch.Tensor:
    """The block, through ``AttentionBlockFn`` where a gradient is
    needed."""
    names = param_names(use_residual)
    params = [p[n] for n in names]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return AttentionBlockFn.apply(x, num_heads, use_residual, *params)
    return attention_block_forward(x, p, num_heads, use_residual)



# ---- AutoInt's interacting layer ---------------------------------------


def softmax_backward(w: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The softmax's adjoint over the last axis: w * (dw - sum(dw * w))."""
    return w * (dw - (dw * w).sum(dim=-1, keepdim=True))


def _interact_check(x: torch.Tensor, p: dict, num_heads: int) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, F, d), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    d, a = x.shape[2], p["wq"].shape[1]
    if num_heads < 1 or a % num_heads != 0:
        raise ValueError(
            f"attention_dim ({a}) must be divisible by num_heads ({num_heads})"
        )
    for name in INTERACT_NAMES:
        t = p[name]
        if tuple(t.shape) != (d, a):
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {(d, a)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _interact_recompute(x: torch.Tensor, p: dict, num_heads: int):
    """(xf, w4, q, k, v, w, ctx, pre) of the forward in f32: w4 the weights
    [wq|wk|wv|wres] rounded to x's dtype, pre = ctx + res."""
    bsz, f, _ = x.shape
    a = p["wq"].shape[1]
    hd = a // num_heads
    xf = x.float()
    w4 = torch.cat([p[n] for n in INTERACT_NAMES], dim=1).to(x.dtype).float()
    proj = xf @ w4
    q, k, v = (t.reshape(bsz, f, num_heads, hd)
               for t in torch.split(proj[..., :3 * a], a, dim=2))
    s = torch.einsum("bihe,bjhe->bhij", q, k) * INTERACT_SCALE
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = e / e.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bhij,bjhe->bihe", w, v).reshape(bsz, f, a)
    return xf, w4, q, k, v, w, ctx, ctx + proj[..., 3 * a:]


def interacting_plain(x: torch.Tensor, p: dict,
                      num_heads: int) -> torch.Tensor:
    """Plain version of the interacting layer's forward kernel: (B, F, d)
    -> ReLU(ctx + x · wres) (B, F, a) in x's dtype, at the kernel's
    rounding points."""
    return torch.relu(_interact_recompute(x, p, num_heads)[-1]).to(x.dtype)


def interacting_backward_plain(x: torch.Tensor, p: dict, g: torch.Tensor,
                               num_heads: int, dall_round: bool = True):
    """Plain version of the interacting layer's backward kernel: (dx in x's
    dtype, {name: gradient in the parameter's dtype}) for the output
    cotangent g (B, F, a).

    ``dall_round=False`` leaves out the cast of [dq|dk|dv|dres] to the
    compute type before its two products: a control that chip_smoke.py's
    bf16 check must refuse."""
    xf, w4, q, k, v, w, ctx, pre = _interact_recompute(x, p, num_heads)
    bsz, f, _ = x.shape
    a = p["wq"].shape[1]
    dres = g.to(x.dtype).float() * (pre > 0)
    dctx = dres.reshape(bsz, f, num_heads, a // num_heads)
    ds = softmax_backward(
        w, torch.einsum("bihe,bjhe->bhij", dctx, v)) * INTERACT_SCALE
    dq = torch.einsum("bhij,bjhe->bihe", ds, k)
    dk = torch.einsum("bhij,bihe->bjhe", ds, q)
    dv = torch.einsum("bhij,bihe->bjhe", w, dctx)
    dall = torch.cat([t.reshape(bsz, f, a) for t in (dq, dk, dv)]
                     + [dres], dim=2)
    if dall_round:
        dall = dall.to(x.dtype).float()
    dw4 = torch.einsum("bfc,bfj->cj", xf, dall)
    dx = dall @ w4.t()
    grads = dict(zip(INTERACT_NAMES, torch.split(dw4, a, dim=1)))
    return dx.to(x.dtype), {n: t.to(p[n].dtype) for n, t in grads.items()}


def _interact_floats(f: int, d: int, a: int, h: int, samples: int,
                     core_warps: int, backward: bool) -> int:
    hdp = _up(a // h, 4)
    ap, dp = _up(h * hdp, 16), _up(d, 16)
    rows = _up(samples * f, 16)
    weights = dp * _row_stride(4 * ap)  # [wq|wk|wv|wres]
    if backward:
        # x, [q|k|v|res] (then dall4), ctx (then dx); two F x F a core warp
        tile = rows * (_row_stride(dp) + _row_stride(4 * ap)
                       + _row_stride(max(ap, dp)))
        return weights + tile + core_warps * 2 * f * (f | 1)
    tile = rows * (_row_stride(dp) + _row_stride(3 * ap) + _row_stride(ap))
    return weights + tile + core_warps * f * (f | 1)


@functools.lru_cache(maxsize=None)
def interacting_forward_plan(f: int, d: int, a: int,
                             num_heads: int) -> ForwardPlan:
    """The interacting layer's forward plan (csrc/attention_block.cu's
    make_interact_fwd_plan), chosen as ``forward_plan`` chooses the
    block's."""
    return _choose_forward(
        lambda *s: _interact_floats(*s, backward=False), "interacting layer",
        f, d, a, num_heads)


def _interact_tiled_floats(f: int, d: int, a: int, h: int,
                           samples: int) -> int:
    """Floats of the interacting backward's tiled layout
    (csrc/attention_bwd.cu's make_tiled_interact_plan)."""
    hdp = _up(a // h, 4)
    ap, dp = _up(h * hdp, 16), _up(d, 16)
    rows = _up(samples * f, 16)
    weights = dp * _row_stride(4 * ap)  # [wq|wk|wv|wres]
    # [q|k|v|res] (then dall4), ctx (then dq, then dx)
    tile = rows * (_row_stride(4 * ap) + _row_stride(max(ap, dp)))
    # x's rows, or between the products every pair's W, then every pair's D
    shared = max(rows * _row_stride(dp), samples * h * 2 * f * (f | 1))
    return weights + tile + shared


@functools.lru_cache(maxsize=None)
def interacting_backward_plan(f: int, d: int, a: int,
                              num_heads: int) -> BackwardPlan:
    """The interacting layer's backward plan (csrc/attention_bwd.cu's
    choose_interact_plan): the tiled core's layout with the most samples a
    tile that fits one block, its core on all warps; where none fits, the
    lane-per-query core's (make_interact_plan): the most core warps, then
    the most samples a tile, that fit one block, with no gradient
    accumulator in shared memory."""
    for s in range(MAX_SAMPLES, 0, -1):
        smem = 4 * _interact_tiled_floats(f, d, a, num_heads, s)
        if smem <= SMEM_PER_BLOCK:
            return BackwardPlan(s, WARPS, _up(s * f, 16), smem, tiled=True)
    return _choose_backward(
        lambda *s: _interact_floats(*s, backward=True), "interacting layer",
        f, d, a, num_heads)


def interacting_partial_floats(d: int, a: int, num_heads: int) -> int:
    """Floats of one backward block's dW partial in device memory: d
    rounded up to 16 rows of the 4 padded sections."""
    return _up(d, 16) * 4 * _up(num_heads * _up(a // num_heads, 4), 16)


def _interact_weights(x: torch.Tensor, p: dict) -> torch.Tensor:
    return torch.cat([p[n] for n in INTERACT_NAMES], dim=1).to(
        x.dtype).contiguous()


def _interact_forward_cuda(x, p, num_heads) -> torch.Tensor:
    _interact_check(x, p, num_heads)
    bsz, f, d = x.shape
    a = p["wq"].shape[1]
    out = torch.empty(bsz, f, a, dtype=x.dtype, device=x.device)
    if bsz == 0:
        return out
    fp = interacting_forward_plan(f, d, a, num_heads)
    x = x.contiguous()
    w4 = _interact_weights(x, p)
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(x.device):
        err = lib.interacting_fwd(
            x.data_ptr(), w4.data_ptr(), out.data_ptr(), bsz, f, d, a,
            num_heads, INTERACT_SCALE, int(x.dtype == torch.bfloat16),
            fp.samples, fp.core_warps, fp.blocks_per_sm,
            fp.grid(bsz, build.sm_count(x)), fp.smem, build.stream_of(x),
        )
    build.check(lib, SOURCE, "interacting_fwd", err)
    interacting_forward.launches += 1
    return out


def _interact_backward_cuda(x, p, g, num_heads):
    _interact_check(x, p, num_heads)
    bsz, f, d = x.shape
    a = p["wq"].shape[1]
    if tuple(g.shape) != (bsz, f, a) or g.device != x.device:
        raise ValueError(
            f"g {tuple(g.shape)} on {g.device} does not match the output "
            f"{(bsz, f, a)} on {x.device}"
        )
    # the reduce kernel writes every element of flat
    flat = torch.empty(d, 4 * a, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if bsz > 0:
        bp = interacting_backward_plan(f, d, a, num_heads)
        x = x.contiguous()
        gg = g.to(x.dtype).contiguous()
        w4 = _interact_weights(x, p)
        grid = bp.grid(bsz)
        n_part = interacting_partial_floats(d, a, num_heads)
        part = torch.empty(grid, n_part, dtype=torch.float32, device=x.device)
        lib = build.bind(BWD_SOURCE, _BWD_SIGNATURES)
        with build.launch_device(x.device):
            err = lib.interacting_bwd(
                x.data_ptr(), gg.data_ptr(), w4.data_ptr(), dx.data_ptr(),
                part.data_ptr(), flat.data_ptr(), n_part, bsz, f, d, a,
                num_heads, INTERACT_SCALE, int(x.dtype == torch.bfloat16),
                bp.samples, bp.core_warps, int(bp.tiled), grid, bp.smem,
                build.stream_of(x),
            )
        build.check(lib, BWD_SOURCE, "interacting_bwd", err)
        interacting_backward.launches += 1
        if bp.tiled:
            interacting_backward.tiled_launches += 1
            tracing.count("attention.tiled_core_rows", bsz * f)
    else:
        dx.zero_()
        flat.zero_()
    grads = dict(zip(INTERACT_NAMES, torch.split(flat, a, dim=1)))
    return dx, {n: t.to(p[n].dtype) for n, t in grads.items()}


def interacting_forward(x: torch.Tensor, p: dict,
                        num_heads: int) -> torch.Tensor:
    """One interacting layer, (B, F, d) -> (B, F, a), without an autograd
    graph. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if x.device.type == "cpu":
        return interacting_plain(x, p, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _interact_forward_cuda(x, p, num_heads)


interacting_forward.launches = 0


def interacting_backward(x: torch.Tensor, p: dict, g: torch.Tensor,
                         num_heads: int):
    """(dx in x's dtype, {name: gradient in the parameter's dtype}) of one
    interacting layer for the output cotangent g. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernels (or raises)."""
    if x.device.type == "cpu":
        return interacting_backward_plain(x, p, g, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _interact_backward_cuda(x, p, g, num_heads)


interacting_backward.launches = 0
# launches that took the tiled core (the rest took the lane-per-query core)
interacting_backward.tiled_launches = 0


class InteractingLayerFn(torch.autograd.Function):
    """One interacting layer with its backward kernel. Saves x and the
    weights; the backward recomputes the forward.

    apply(x, num_heads, wq, wk, wv, wres).
    """

    @staticmethod
    def forward(ctx, x, num_heads, *params):
        ctx.num_heads = num_heads
        ctx.save_for_backward(x, *params)
        return interacting_forward(x, dict(zip(INTERACT_NAMES, params)),
                                   num_heads)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        with tracing.span("model.attention_backward"):
            dx, dp = interacting_backward(
                x, dict(zip(INTERACT_NAMES, params)), g, ctx.num_heads)
        return (dx, None, *(dp[n] for n in INTERACT_NAMES))


def interacting_layer(x: torch.Tensor, p: dict,
                      num_heads: int) -> torch.Tensor:
    """The layer, through ``InteractingLayerFn`` where a gradient is
    needed."""
    params = [p[n] for n in INTERACT_NAMES]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return InteractingLayerFn.apply(x, num_heads, *params)
    return interacting_forward(x, p, num_heads)

__all__ = [
    "AttentionBlockFn",
    "BackwardPlan",
    "ForwardPlan",
    "attention_block",
    "attention_block_backward",
    "attention_block_backward_plain",
    "attention_block_forward",
    "attention_block_plain",
    "backward_plan",
    "forward_attributes",
    "forward_plan",
    "head_scale",
    "interacting_backward",
    "interacting_backward_plain",
    "interacting_backward_plan",
    "interacting_forward",
    "interacting_forward_plan",
    "interacting_layer",
    "interacting_plain",
    "InteractingLayerFn",
]
