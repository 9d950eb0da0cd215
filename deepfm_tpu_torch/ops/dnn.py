"""MLP tower: Linear -> (BatchNorm) -> activation -> dropout, stacked.

Port of ``deepfm_tpu/ops/dnn.py``. BatchNorm uses batch statistics in
training and running averages in eval, momentum 0.1 and eps 1e-5 (flax's
``momentum=0.9`` is the weight of the old average, torch's 0.1 that of the
new batch). Layers are named ``dense_{i}`` / ``bn_{i}`` as in the JAX
tree; torch's Linear stores its weight ``(out, in)``, the transpose of
flax's ``(in, out)`` kernel (``convert.params_from_jax`` transposes).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from deepfm_tpu_torch.ops.init import torch_linear_bound, uniform_

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "leaky_relu": lambda x: nn.functional.leaky_relu(x, negative_slope=0.01),
    "gelu": lambda x: nn.functional.gelu(x, approximate="none"),
    "tanh": torch.tanh,
}


def torch_linear(
    in_dim: int, out_dim: int, generator: torch.Generator
) -> nn.Linear:
    """nn.Linear with torch-default bounds drawn from ``generator``."""
    lin = nn.Linear(in_dim, out_dim)
    bound = torch_linear_bound(in_dim)
    uniform_(lin.weight, bound, generator)
    uniform_(lin.bias, bound, generator)
    return lin


class DNN(nn.Module):
    def __init__(
        self,
        in_dim: int,
        hidden_units: Sequence[int],
        activation: str = "relu",
        dropout: float = 0.1,
        use_batch_norm: bool = True,
        compute_dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        if not hidden_units:
            raise ValueError("hidden_units must be non-empty")
        act = ACTIVATIONS.get(activation.lower())
        if act is None:
            raise ValueError(
                f"Unknown activation: {activation}. "
                f"Choose from {list(ACTIVATIONS)}"
            )
        g = generator if generator is not None else torch.Generator()
        self.act = act
        self.hidden_units = tuple(hidden_units)
        self.use_batch_norm = use_batch_norm
        self.compute_dtype = compute_dtype
        self.dropout = nn.Dropout(dropout) if dropout > 0 else nn.Identity()
        for i, out_dim in enumerate(hidden_units):
            setattr(self, f"dense_{i}", torch_linear(in_dim, out_dim, g))
            if use_batch_norm:
                setattr(
                    self, f"bn_{i}",
                    nn.BatchNorm1d(out_dim, eps=1e-5, momentum=0.1),
                )
            in_dim = out_dim

    @property
    def output_dim(self) -> int:
        return self.hidden_units[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Parameters stay f32 and are cast to the compute dtype per
        call, as flax's ``Dense(dtype=...)`` does; BatchNorm runs in f32."""
        cdt = self.compute_dtype
        x = x.to(cdt)
        for i in range(len(self.hidden_units)):
            lin = getattr(self, f"dense_{i}")
            x = nn.functional.linear(x, lin.weight.to(cdt), lin.bias.to(cdt))
            if self.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x.float()).to(cdt)
            x = self.dropout(self.act(x))
        return x
