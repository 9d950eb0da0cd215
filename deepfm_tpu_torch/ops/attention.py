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
"""

from __future__ import annotations

import torch
from torch import nn

from deepfm_tpu_torch.ops.init import torch_linear_bound, uniform_
from deepfm_tpu_torch.ops.kernels.attention import attention_block, param_names


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
        x = field_embeddings.to(self.compute_dtype)  # (B, F, d)
        if not self.use_kernel and x.device.type != "cpu":
            raise ValueError(
                "pallas.use_attention_kernel=false selects the plain "
                "attention version, which runs only on the CPU; got a "
                f"tensor on {x.device}"
            )
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x)
        return x
