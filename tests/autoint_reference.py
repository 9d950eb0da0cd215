"""A plain PyTorch AutoInt, written from the paper for the port's tests.

Song, Shi, Xiao, Duan, Xu, Zhang and Tang, "AutoInt: Automatic Feature
Interaction Learning via Self-Attentive Neural Networks", CIKM 2019
(arXiv:1810.11921): field embeddings (section 4.3), interacting layers
(4.4), the output layer (4.5). It imports nothing of JAX and nothing of the
port, and computes in float32 by plain tensor operations, its gradients by
autograd; call it under ``full_f32()`` on a card.

The weights ``w`` (names of this file):

* ``table`` (rows, d + 1): a categorical field f's local id i reads row
  ``offsets[f] + i``; id 0 reads nothing (the row is masked); the last
  column is a first-order weight AutoInt does not read;
* ``dense_w``, ``dense_b`` (nd, d): a numeric field's embedding
  x_m * dense_w[m] + dense_b[m] (the paper's has no dense_b);
* ``layer{l}.wq``, ``.wk``, ``.wv``, ``.wres`` (d_l, a), a = H * d', no
  biases; head h reads columns h * d' .. (h + 1) * d' - 1;
* ``head.w`` (1, F * a), ``head.b`` (1,).

The fields are the numeric ones, then the categorical ones. Layer l:

    alpha^h_mk = softmax_k <W_Q^h e_m, W_K^h e_k>    (unscaled)
    e~_m = concat_h sum_k alpha^h_mk W_V^h e_k
    e'_m = ReLU(e~_m + W_Res e_m)

and logit = head.w . (e_1 ++ ... ++ e_F) + head.b.

Rounding points, for holding a kernel's rounding: ``q`` rounds in both
directions (a layer's input and output, whose cotangent crosses the layer
in the compute type), ``qw`` the weights on their way into the products,
``qg`` the cotangent of the four projections (the backward's [dq|dk|dv|dres]
before its two products). Each is the identity by default.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("wq", "wk", "wv", "wres")


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.to(dtype).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


class _RoundGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def round_both(dtype: torch.dtype):
    """q: round to ``dtype`` and back, the value and its gradient."""
    return lambda t: _RoundBoth.apply(t, dtype)


def round_value(dtype: torch.dtype):
    """qw: round the value to ``dtype`` and back; the gradient passes."""
    return lambda t: t + (t.to(dtype).to(t.dtype) - t).detach()


def round_grad(dtype: torch.dtype):
    """qg: the value passes; its gradient is rounded to ``dtype``."""
    return lambda t: _RoundGrad.apply(t, dtype)


@contextlib.contextmanager
def full_f32():
    """float32 matrix products without TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def embed(w: dict, ids: torch.Tensor, dense: torch.Tensor,
          offsets: torch.Tensor) -> torch.Tensor:
    """(B, F, d) field embeddings: the numeric fields', then the
    categorical fields'."""
    d = w["dense_w"].shape[1]
    rows = w["table"][(ids.long() + offsets[None, :].long()).reshape(-1)]
    rows = rows.reshape(*ids.shape, d + 1)[:, :, :d] * (ids != 0)[:, :, None]
    numeric = dense[:, :, None] * w["dense_w"][None] + w["dense_b"][None]
    return torch.cat([numeric, rows], dim=1)


def interacting_layer(x: torch.Tensor, lw: dict, num_heads: int,
                      q=identity, qw=identity, qg=identity) -> torch.Tensor:
    """One interacting layer, (B, F, d_l) -> (B, F, a)."""
    bsz, f, _ = x.shape
    a = lw["wq"].shape[1]
    hd = a // num_heads
    x = q(x)
    q_, k, v, res = (qg(x @ qw(lw[n])) for n in NAMES)
    q_, k, v = (t.reshape(bsz, f, num_heads, hd) for t in (q_, k, v))
    alpha = torch.softmax(torch.einsum("bmhe,bkhe->bhmk", q_, k), dim=-1)
    ctx = torch.einsum("bhmk,bkhe->bmhe", alpha, v).reshape(bsz, f, a)
    return q(torch.relu(ctx + res))


def stack(x: torch.Tensor, w: dict, num_heads: int, num_layers: int,
          q=identity, qw=identity, qg=identity) -> torch.Tensor:
    for layer in range(num_layers):
        lw = {n: w[f"layer{layer}.{n}"] for n in NAMES}
        x = interacting_layer(x, lw, num_heads, q, qw, qg)
    return x


def logits(w: dict, ids: torch.Tensor, dense: torch.Tensor,
           offsets: torch.Tensor, num_heads: int,
           num_layers: int) -> torch.Tensor:
    """(B,) float32 logits."""
    out = stack(embed(w, ids, dense, offsets), w, num_heads, num_layers)
    return (out.reshape(out.shape[0], -1) @ w["head.w"].t())[:, 0] \
        + w["head.b"][0]


def bce(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy of the logits, the mean over the batch."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logit, labels)
