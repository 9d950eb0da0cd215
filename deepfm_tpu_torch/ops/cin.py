"""Compressed Interaction Network (CIN) for xDeepFM.

Port of ``deepfm_tpu/ops/cin.py``. Per layer: the outer product of the
running hidden state (B, H, D) with the input (B, F, D), compressed by a
(M, H*F) weight (a 1x1 convolution), plus bias, ReLU, optional split-half
routing, sum-pooling over D and concatenation across layers.

``CIN`` always goes through ``cin_stack_forward``
(``ops/kernels/cin_stack.py``): the whole stack runs in one hand-written
CUDA kernel on a CUDA tensor, and in its plain version on a CPU tensor;
where a gradient is needed the call goes through ``CinStackFn``, whose
backward is the CIN-stack backward kernel (or its plain version). A stack
too large for one block's shared memory (``stack_route``) is not refused:
in the direction that does not fit it runs layer by layer through the
per-layer kernel (``ops/kernels/cin.py``), as the JAX package falls back
to ``cin_compress_pallas`` where no stack tile fits.
With ``use_kernel`` off (config ``pallas.use_cin_kernel: false``) the
JAX package runs its plain jnp function; the port runs its plain version
on the CPU as well, and refuses any other device, since there is no plain
path on the card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from deepfm_tpu_torch.ops.init import torch_linear_bound, uniform_


def cin_layer_sizes(
    layer_sizes: Sequence[int], split_half: bool
) -> tuple[list[int], list[int]]:
    """(direct_sizes, next_sizes) per layer."""
    direct_sizes: list[int] = []
    next_sizes: list[int] = []
    for i, layer_size in enumerate(layer_sizes):
        if split_half and i < len(layer_sizes) - 1:
            direct = layer_size // 2
            direct_sizes.append(direct)
            next_sizes.append(layer_size - direct)
        else:
            direct_sizes.append(layer_size)
            next_sizes.append(layer_size)
    return direct_sizes, next_sizes


def cin_output_dim(layer_sizes: Sequence[int], split_half: bool) -> int:
    return sum(cin_layer_sizes(layer_sizes, split_half)[0])


def cin_outer(hidden: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """(B,H,D),(B,F,D) -> (B, H*F, D), row h*F + f = hidden[h] * x0[f]."""
    bsz, h, d = hidden.shape
    return torch.einsum("bhd,bfd->bhfd", hidden, x0).reshape(
        bsz, h * x0.shape[1], d
    )


def cin_compress(
    hidden: torch.Tensor,
    x0: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    operand: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
) -> torch.Tensor:
    """One CIN compression: (B,H,D),(B,F,D),(M,H*F) -> (B,M,D), pre-ReLU.
    ``operand`` is applied to the outer product before the contraction
    (the bf16 rounding of the kernel's bf16 mode)."""
    return (
        torch.einsum("mc,bcd->bmd", w, operand(cin_outer(hidden, x0)))
        + b[None, :, None]
    )


class CIN(nn.Module):
    """Parameters ``conv_{i}_kernel`` (M, H*F) and ``conv_{i}_bias`` (M,),
    named and laid out as in the JAX tree (column h*F + f)."""

    def __init__(
        self,
        num_fields: int,
        layer_sizes: Sequence[int] = (128, 128),
        split_half: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        use_kernel: bool = True,
        bf16_operands: bool = False,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.num_fields = num_fields
        self.layer_sizes = tuple(layer_sizes)
        self.split_half = split_half
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.bf16_operands = bf16_operands
        _, next_sizes = cin_layer_sizes(self.layer_sizes, split_half)
        prev = num_fields
        for i, layer_size in enumerate(self.layer_sizes):
            in_ch = prev * num_fields
            bound = torch_linear_bound(in_ch)
            self.register_parameter(f"conv_{i}_kernel", nn.Parameter(
                uniform_(torch.empty(layer_size, in_ch), bound, g)
            ))
            self.register_parameter(f"conv_{i}_bias", nn.Parameter(
                uniform_(torch.empty(layer_size), bound, g)
            ))
            prev = next_sizes[i]

    @property
    def output_dim(self) -> int:
        return cin_output_dim(self.layer_sizes, self.split_half)

    def forward(self, field_embeddings: torch.Tensor) -> torch.Tensor:
        from deepfm_tpu_torch.ops.kernels.cin_stack import cin_stack_forward

        cdt = self.compute_dtype
        x0 = field_embeddings.to(cdt)  # (B, F, D)
        if not self.use_kernel and x0.device.type != "cpu":
            raise ValueError(
                "pallas.use_cin_kernel=false selects the plain CIN version, "
                f"which runs only on the CPU; got a tensor on {x0.device}"
            )
        n = len(self.layer_sizes)
        return cin_stack_forward(
            x0,
            [getattr(self, f"conv_{i}_kernel") for i in range(n)],
            [getattr(self, f"conv_{i}_bias") for i in range(n)],
            self.layer_sizes, self.split_half,
            bf16_operands=self.bf16_operands,
        ).to(cdt)
