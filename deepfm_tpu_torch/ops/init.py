"""Weight initializers matching the JAX package's scales (``ops/init.py``).

torch-default Linear bounds, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for kernel
and bias, and xavier-uniform bounds, each drawn from an explicit
``torch.Generator`` so a seed fixes every parameter. The draws differ from
``jax.random``'s for the same seed; tests carry weights across with
``deepfm_tpu_torch.convert`` instead.
"""

from __future__ import annotations

import math

import torch


def uniform_(
    t: torch.Tensor, bound: float, generator: torch.Generator
) -> torch.Tensor:
    """Fill ``t`` in place with U(-bound, bound) drawn from ``generator``."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
        t.copy_(u.mul_(2.0).sub_(1.0).mul_(bound))
    return t


def torch_linear_bound(fan_in: int) -> float:
    """1/sqrt(fan_in) — torch nn.Linear's default kernel and bias bound."""
    return 1.0 / math.sqrt(max(fan_in, 1))


def xavier_bound(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))
