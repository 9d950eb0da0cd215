"""MLP tower: Linear -> (BatchNorm) -> activation -> dropout, stacked.

Port of ``deepfm_tpu/ops/dnn.py``. Dropout draws from an explicit generator
(``Dropout``). BatchNorm follows
``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` (``BatchNorm`` below):
batch statistics in training, running averages in eval. Layers are named
``dense_{i}`` / ``bn_{i}`` as in the JAX tree; torch's Linear stores its
weight ``(out, in)``, the transpose of flax's ``(in, out)`` kernel
(``convert.params_from_jax`` transposes).
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


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d``'s parameters and buffers with flax's arithmetic.

    flax (``_compute_stats`` with ``use_fast_variance``) normalises with,
    and averages into ``var``, the biased batch variance
    max(E[x^2] - E[x]^2, 0) computed in f32, and updates the running
    averages as 0.9 * old + 0.1 * batch. ``nn.BatchNorm1d`` would carry the
    unbiased variance instead (a factor n / (n - 1) after one step) and
    compute it another way. ``momentum`` keeps torch's meaning (the weight
    of the new batch, 0.1).

    Under a mesh (``mesh``, set by the ``Trainer``) the statistics are the
    global batch's, as flax's are under GSPMD: each rank sums x and x^2
    over its rows, the sums and the row count go through one
    differentiable all-reduce over the data group
    (``parallel/collectives.py::all_reduce_sum``, whose backward sums the
    gradients over the group too; the model peers hold the same rows, so a
    sum over the world would count them m times), and every rank
    normalises with, and averages into its running statistics, the same
    mean and variance.
    """

    mesh = None  # parallel.Mesh: global batch statistics over its ranks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            n = x.shape[0]
            s1, s2 = x.sum(dim=0), (x * x).sum(dim=0)
            if self.mesh is not None and self.mesh.data_group is not None:
                from deepfm_tpu_torch.parallel.collectives import (
                    all_reduce_sum,
                )

                count = torch.full_like(s1, float(n))
                s1, s2, n = all_reduce_sum(
                    self.mesh.data_group, torch.stack([s1, s2, count]))
            mean = s1 / n
            mean2 = s2 / n
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            keep = 1.0 - self.momentum
            with torch.no_grad():
                self.running_mean.copy_(
                    keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(
                    keep * self.running_var + self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Dropout(nn.Module):
    """Inverted dropout (``nn.Dropout``'s arithmetic) whose mask is drawn
    from ``generator``: a ``torch.Generator`` on the input's device that
    the trainer owns, seeds from ``config.seed`` and carries in its resume
    checkpoint (``Trainer.dropout_generator``); PyTorch's global generator
    while none is set. The masks are PyTorch's, not the JAX package's."""

    def __init__(self, p: float) -> None:
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return x * keep * (1.0 / (1.0 - self.p))


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
        self.dropout = Dropout(dropout) if dropout > 0 else nn.Identity()
        for i, out_dim in enumerate(hidden_units):
            setattr(self, f"dense_{i}", torch_linear(in_dim, out_dim, g))
            if use_batch_norm:
                setattr(
                    self, f"bn_{i}",
                    BatchNorm(out_dim, eps=1e-5, momentum=0.1),
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
                x = getattr(self, f"bn_{i}")(x).to(cdt)
            x = self.dropout(self.act(x))
        return x
