"""Fused table Adam: the hand-written CUDA kernel and its plain version.

Replaces ``deepfm_tpu/ops/pallas/adam_kernel.py`` :: ``fused_table_adam``
(the ``pl.pallas_call`` of ``_adam_kernel``). Source:
``csrc/fused_table_adam.cu``; the per-element update lives in
``csrc/table_update.cuh`` and is shared with the sparse kernel
(``ops/kernels/sparse_adam.py``).

What it computes: ``optax.chain(add_decayed_weights(wd),
clip_by_global_norm(clip), adam(lr))`` restricted to one table, with the
global norm of the whole decayed gradient tree supplied by the caller, in
optax's literal f32 op order (decay, clip's divide-then-multiply, the
moment updates, the bias-correction divisions). Adam's normalisation turns
last-ulp differences into lr-sized ones within two steps, so the order is
kept exactly: the kernel rounds every operation as a separate PyTorch op
would, and on the card its mu/nu equal the plain version's bit for bit.
Moments are stored in their own type (f32 or bf16, rounded to nearest);
the math is f32. The table, mu and nu are updated in place.

What bounds it on an H100: bytes, 20 per element with bf16 moments
(3.54 GB at bench.py's 10.4M x 17 table, about 1.06 ms at 3.35 TB/s). The
kernel moves them in 16-byte accesses, 8 elements a thread a step;
``vector_split`` cuts the arrays into a scalar head, that body of vectors
and a scalar tail, from the four pointers' alignment.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from deepfm_tpu_torch.ops.kernels import build

SOURCE = "fused_table_adam.cu"
_SIGNATURES = {
    "fused_table_adam_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ],
}
MOMENT_DTYPES = (torch.float32, torch.bfloat16)
VECTOR = 8  # elements a thread takes in one step (kVec)


class VectorSplit(NamedTuple):
    """Elements [0, head) and [head + 8 * vectors, numel) are updated one
    at a time, [head, head + 8 * vectors) in vectors of 8 whose every
    pointer is 16-byte aligned."""

    head: int
    vectors: int
    tail: int


def aligned_head(addresses) -> int | None:
    """The first element h in [0, 8) at which every array at
    ``addresses``, (byte address, element size) pairs, is 16-byte aligned,
    or None (``table_update::aligned_head``)."""
    return next((h for h in range(VECTOR)
                 if all((a + h * size) % 16 == 0 for a, size in addresses)),
                None)


def vector_split(numel: int, addresses) -> VectorSplit:
    """The kernel's split of ``numel`` elements over arrays at
    ``addresses``, (byte address, element size) pairs: the head is
    ``aligned_head`` (all of numel when there is none, or when it lies past
    the end); then as many whole vectors as fit; the rest is the tail. The
    C launch recomputes it from the pointers."""
    head = aligned_head(addresses)
    head = numel if head is None else min(head, numel)
    vectors = (numel - head) // VECTOR
    return VectorSplit(head, vectors, numel - head - VECTOR * vectors)


def _scalar(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def adam_scalars(lr, weight_decay, global_norm, clip_norm, step,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 device=None) -> torch.Tensor:
    """The kernels' per-launch scalars, computed on ``device`` (default: the
    global norm's) so no launch waits for the host: (8,) f32
    [lr, wd, max(gnorm, 1e-30), clip, 1 - b1^t, 1 - b2^t, eps, noclip] with
    t = step + 1 in f32 (``step`` counts completed steps) and noclip =
    clip <= 0 or gnorm < clip, as ``adam_kernel.py`` assembles them."""
    if device is None:
        device = (global_norm.device if isinstance(global_norm, torch.Tensor)
                  else torch.device("cpu"))
    gnorm = _scalar(global_norm, device)
    t = _scalar(step, device) + 1.0
    bc1 = 1.0 - torch.pow(_scalar(b1, device), t)
    bc2 = 1.0 - torch.pow(_scalar(b2, device), t)
    clip = float(clip_norm)
    noclip = (torch.ones((), device=device) if clip <= 0
              else (gnorm < clip).float())
    return torch.stack([
        _scalar(lr, device), _scalar(weight_decay, device),
        torch.clamp_min(gnorm, 1e-30), _scalar(clip, device), bc1, bc2,
        _scalar(eps, device), noclip,
    ])


def betas(b1: float, b2: float) -> tuple[float, float, float, float]:
    """(1 - b1, b1, 1 - b2, b2) as the kernels take them; ctypes rounds each
    double to f32, as JAX rounds its Python-float constants."""
    return 1.0 - b1, b1, 1.0 - b2, b2


def adam_update_plain(p, g, mu, nu, scalars, b1: float = 0.9,
                      b2: float = 0.999):
    """The per-element update as separate PyTorch ops, in the kernel's
    order; returns (p', mu', nu') with the moments in their own dtype.
    The dynamic scalars are 0-dim tensors on p's device, so on CUDA each
    division is a true division (PyTorch turns a division by a CPU scalar
    into a multiplication by its reciprocal)."""
    lr, wd, gnorm, clip, bc1, bc2, eps, noclip = scalars.unbind()
    g = g + wd * p
    g = torch.where(noclip > 0, g, g / gnorm * clip)
    m = (1.0 - b1) * g + b1 * mu.float()
    v = (1.0 - b2) * (g * g) + b2 * nu.float()
    m_hat = m / bc1
    v_hat = v / bc2
    p_new = p - lr * (m_hat / (torch.sqrt(v_hat) + eps))
    return p_new, m.to(mu.dtype), v.to(nu.dtype)


def fused_table_adam_plain(param, mu, nu, grad, lr, weight_decay,
                           global_norm, clip_norm, step, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-8):
    """Plain PyTorch version of ``fused_table_adam``: the same update, in
    place on param, mu and nu."""
    sc = adam_scalars(lr, weight_decay, global_norm, clip_norm, step, b1, b2,
                      eps, device=param.device)
    p2, m2, v2 = adam_update_plain(param, grad, mu, nu, sc, b1, b2)
    param.copy_(p2)
    mu.copy_(m2)
    nu.copy_(v2)
    return param, mu, nu


def check_table(param, mu, nu) -> None:
    """Shape, type, device and layout checks of a table and its moments."""
    if param.dtype != torch.float32 or param.dim() != 2:
        raise TypeError(
            f"the table must be a 2-D float32 tensor, got {param.dtype} "
            f"{tuple(param.shape)}"
        )
    if mu.dtype not in MOMENT_DTYPES or nu.dtype != mu.dtype:
        raise TypeError(
            f"moments must both be float32 or bfloat16, got {mu.dtype} / "
            f"{nu.dtype}"
        )
    for name, t in (("mu", mu), ("nu", nu)):
        if t.shape != param.shape or t.device != param.device:
            raise ValueError(
                f"{name} {tuple(t.shape)} on {t.device} does not match the "
                f"table {tuple(param.shape)} on {param.device}"
            )
    for name, t in (("table", param), ("mu", mu), ("nu", nu)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: it is updated in place")


def fused_table_adam(param, mu, nu, grad, lr, weight_decay, global_norm,
                     clip_norm, step, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8):
    """One Adam step over a 2-D table from its dense gradient, in place.
    Returns (param, mu, nu), the same tensors. ``step`` counts completed
    steps; ``global_norm`` is the norm of the whole decayed gradient tree;
    clip_norm <= 0 disables clipping. A CPU table takes the plain version;
    a CUDA table launches the kernel (or raises)."""
    if param.device.type == "cpu":
        return fused_table_adam_plain(param, mu, nu, grad, lr, weight_decay,
                                      global_norm, clip_norm, step, b1, b2,
                                      eps)
    if param.device.type != "cuda":
        raise ValueError(f"unsupported device {param.device}")
    check_table(param, mu, nu)
    if grad.shape != param.shape or grad.dtype != torch.float32 \
            or grad.device != param.device:
        raise ValueError(
            f"grad {grad.dtype} {tuple(grad.shape)} on {grad.device} does not "
            f"match the table"
        )
    grad = grad.contiguous()
    sc = adam_scalars(lr, weight_decay, global_norm, clip_norm, step, b1, b2,
                      eps, device=param.device)
    split = vector_split(param.numel(), [
        (t.data_ptr(), t.element_size()) for t in (param, grad, mu, nu)])
    lib = build.bind(SOURCE, _SIGNATURES)
    with build.launch_device(param.device):
        err = lib.fused_table_adam_launch(
            param.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            int(mu.dtype == torch.bfloat16), grad.data_ptr(), param.numel(),
            split.head, split.vectors, sc.data_ptr(), *betas(b1, b2),
            build.stream_of(param),
        )
    build.check(lib, SOURCE, "fused_table_adam", err)
    fused_table_adam.launches += 1
    return param, mu, nu


fused_table_adam.launches = 0
