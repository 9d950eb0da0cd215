"""Multi-head self-attention over the field axis (AttentionDeepFM).

Port of ``deepfm_tpu/ops/attention.py``: N stacked blocks of Q/K/V
projection (embed_dim -> attention_dim), scaled dot-product softmax over
the F fields, output projection back to embed_dim, optional residual +
LayerNorm. Parameters are named and laid out as in the JAX tree
(``block_{i}.wq`` (d, a), ``bq`` (a,), ..., ``wo`` (a, d), ``bo`` (d,),
``ln_scale`` / ``ln_bias`` (d,) with residual), so no transpose is needed.

Every block goes through ``attention_block`` (``ops/kernels/attention.py``):
the hand-written CUDA kernels on a CUDA tensor, their plain versions on a
CPU tensor, with ``AttentionBlockFn`` tying forward and backward together.
With ``use_kernel`` off (config ``pallas.use_attention_kernel: false``) the
JAX package runs its XLA tower; the port runs the plain version on the CPU
and refuses any other device, since there is no plain path on the card.
The ``(F, d, B)`` transposes around the JAX stack are a TPU artifact: the
port keeps ``(B, F, d)`` throughout.

``InteractingStack`` is AutoInt's (Song et al., CIKM 2019, section 4.4;
the port's own, not in the JAX package): N stacked interacting layers,
each ``layer_{i}.wq``, ``wk``, ``wv`` (d_l, a) and ``wres`` (d_l, a) with no
biases, ``out = ReLU(softmax(q k^T) v + x · wres)`` of width a, d_1 the
embedding width and d_l = a after it. Each layer goes through
``interacting_layer`` (``ops/kernels/attention.py``), on the same terms as
a block.

Tracing (``utils/tracing.py``): each stack's forward is the span
``model.attention``, and each layer adds its B·F rows to the counter
``attention.rows`` (an interacting layer's backward adds them to
``attention.tiled_core_rows`` where it takes the tiled core).
"""

from __future__ import annotations

import torch
from torch import nn

from deepfm_tpu_torch.ops.init import torch_linear_bound, uniform_
from deepfm_tpu_torch.ops.kernels.attention import (
    INTERACT_NAMES,
    attention_block,
    interacting_layer,
    param_names,
)
from deepfm_tpu_torch.utils import tracing


class AttentionBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, attention_dim: int,
                 use_residual: bool,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        d, a = embed_dim, attention_dim
        self.num_heads = num_heads
        self.use_residual = use_residual
        for name in ("q", "k", "v"):  # torch_linear_kernel/bias(d)
            self.register_parameter(f"w{name}", nn.Parameter(
                uniform_(torch.empty(d, a), torch_linear_bound(d), g)))
            self.register_parameter(f"b{name}", nn.Parameter(
                uniform_(torch.empty(a), torch_linear_bound(d), g)))
        self.wo = nn.Parameter(uniform_(torch.empty(a, d), torch_linear_bound(a), g))
        self.bo = nn.Parameter(uniform_(torch.empty(d), torch_linear_bound(a), g))
        if use_residual:
            self.ln_scale = nn.Parameter(torch.ones(d))
            self.ln_bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {n: getattr(self, n) for n in param_names(self.use_residual)}
        return attention_block(x, p, self.num_heads, self.use_residual)


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int = 4,
                 attention_dim: int = 64, num_layers: int = 1,
                 use_residual: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if attention_dim % num_heads != 0:
            raise ValueError(
                f"attention_dim ({attention_dim}) must be divisible by "
                f"num_heads ({num_heads})"
            )
        g = generator if generator is not None else torch.Generator()
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"block_{i}", AttentionBlock(
                embed_dim, num_heads, attention_dim, use_residual, g))

    def forward(self, field_embeddings: torch.Tensor) -> torch.Tensor:
        return _run_stack(self, "block", field_embeddings)


def _run_stack(stack: nn.Module, layer: str,
               field_embeddings: torch.Tensor) -> torch.Tensor:
    """``stack``'s layers ``{layer}_0`` .. in order over the field
    embeddings cast to its compute dtype."""
    with tracing.span("model.attention"):
        x = field_embeddings.to(stack.compute_dtype)  # (B, F, d)
        if not stack.use_kernel and x.device.type != "cpu":
            raise ValueError(
                "pallas.use_attention_kernel=false selects the plain "
                "attention version, which runs only on the CPU; got a "
                f"tensor on {x.device}"
            )
        for i in range(stack.num_layers):
            tracing.count("attention.rows", x.shape[0] * x.shape[1])
            x = getattr(stack, f"{layer}_{i}")(x)
        return x


class InteractingLayer(nn.Module):
    """One AutoInt interacting layer, (B, F, d_in) -> (B, F, a)."""

    def __init__(self, in_dim: int, num_heads: int, attention_dim: int,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.num_heads = num_heads
        for name in INTERACT_NAMES:
            self.register_parameter(name, nn.Parameter(uniform_(
                torch.empty(in_dim, attention_dim), torch_linear_bound(in_dim),
                g)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return interacting_layer(
            x, {n: getattr(self, n) for n in INTERACT_NAMES}, self.num_heads)


class InteractingStack(nn.Module):
    """AutoInt's ``num_layers`` interacting layers over the field
    embeddings: (B, F, embed_dim) -> (B, F, attention_dim) in the compute
    dtype."""

    def __init__(self, embed_dim: int, num_heads: int = 2,
                 attention_dim: int = 64, num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernel: bool = True,
                 generator: torch.Generator | None = None) -> None:
        super().__init__()
        if attention_dim % num_heads != 0:
            raise ValueError(
                f"attention_dim ({attention_dim}) must be divisible by "
                f"num_heads ({num_heads})"
            )
        g = generator if generator is not None else torch.Generator()
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", InteractingLayer(
                embed_dim if i == 0 else attention_dim, num_heads,
                attention_dim, g))

    def forward(self, field_embeddings: torch.Tensor) -> torch.Tensor:
        return _run_stack(self, "layer", field_embeddings)
