"""AutoInt (Song et al., CIKM 2019, arXiv:1810.11921): the model kind
``autoint``.

logit = head(e_1 ++ ... ++ e_F) over the last of the interacting layers
(section 4.4): per layer, with x the (B, F, d_l) input and no biases,

    q, k, v, res = x W_Q, x W_K, x W_V, x W_Res       (each (B, F, a))
    alpha^h = softmax_k(<q^h_m, k^h_k>)                (unscaled, per head)
    out = ReLU(concat_h sum_k alpha^h_mk v^h_k + res)

a = H * d' and d_1 = D, d_l = a after it. No first-order term and no DNN
(section 4.5: the output layer reads the concatenated field vectors).

Each layer's four weights are U(+-b_l) with b_l = sqrt(3 / (sqrt(d') d_l
m_l)), m_l the mean square of the layer's input (X0_MEAN_SQUARE for the
embeddings, RELU_MEAN_SQUARE after a layer): a projection's variance is
then 1 / sqrt(d'), so a head's unscaled scores have a variance near 1, and
each layer's ReLU output keeps a mean square near its input's (0.09-0.16
at Criteo's 39 fields).

The counts take each layer's four projections (2 B F d_l 4a), its scores
and context (2 B H F^2 d' each), and for the gradient dW and dx over the
four projections and the four products of the attention core (dw, ds^T q,
ds k, w^T dctx), in ``cin_backward``'s convention: the forward's products
the kernel recomputes are not counted again.
"""

from __future__ import annotations

import math

import torch

from portbench import weights
from portbench.counts import Op
from portbench.reference import ctr

NAMES = ("wq", "wk", "wv", "wres")
RELU_MEAN_SQUARE = 0.1


def _fields(config: dict) -> int:
    return config["dense_fields"] + config["sparse_fields"]


def _width(config: dict) -> int:
    return config["attention_heads"] * config["attention_head_dim"]


def _in_widths(config: dict) -> list[int]:
    return [config["embed_dim"]] + [_width(config)] * (
        config["attention_layers"] - 1)


def port_config(config: dict) -> dict:
    return {"attention": {"num_heads": config["attention_heads"],
                          "attention_dim": _width(config),
                          "num_layers": config["attention_layers"]}}


def port_names(config: dict) -> dict[str, str]:
    return {f"attention.{i}.{n}": f"attention.layer_{i}.{n}"
            for i in range(config["attention_layers"]) for n in NAMES}


def specs(config: dict) -> list[tuple[str, tuple, float, float]]:
    a, hd = _width(config), config["attention_head_dim"]
    out = []
    for i, d in enumerate(_in_widths(config)):
        ms = weights.X0_MEAN_SQUARE if i == 0 else RELU_MEAN_SQUARE
        b = math.sqrt(3.0 / (math.sqrt(hd) * d * ms))
        out += [(f"attention.{i}.{n}", (d, a), -b, b) for n in NAMES]
    return out


def dnn_width(config: dict) -> None:
    return None


def heads(config: dict) -> list[tuple[str, int, str]]:
    return [("head", _fields(config) * _width(config), "output_linear")]


def interacting(config, w, x, i: int, q=ctr.identity):
    """Layer ``i`` over x (B, F, d_i): its operands rounded through ``q``
    into the four projections, their results through ``q`` (in the
    backward, the rounding of [dq|dk|dv|dres]), the output through ``q``."""
    b, f, _ = x.shape
    h, hd = config["attention_heads"], config["attention_head_dim"]
    qx = q(x)
    qu, k, v, res = (q(qx @ q(w[f"attention.{i}.{n}"])) for n in NAMES)
    qu, k, v = (t.reshape(b, f, h, hd) for t in (qu, k, v))
    alpha = torch.softmax(torch.einsum("bmhe,bkhe->bhmk", qu, k), dim=-1)
    ctx = torch.einsum("bhmk,bkhe->bmhe", alpha, v).reshape(b, f, h * hd)
    return q(torch.relu(ctx + res))


def logit(config, w, first, x0, training: bool, q=ctr.identity):
    """The first-order term enters at weight 0: AutoInt does not read it,
    and autograd then gives its leaves a gradient of 0, as the port's step
    does."""
    x = x0
    for i in range(config["attention_layers"]):
        x = interacting(config, w, x, i, q)
    return ctr._linear(x.reshape(x.shape[0], -1), w["head.w"], w["head.b"],
                       q)[:, 0] + 0.0 * first


def layer_ops(b, f, d, h, hd, es) -> tuple[Op, Op]:
    """(forward, backward) of one layer of input width d: the forward's
    four projections and the core's two products; the backward's two
    products over the four projections (dW, dx) and the core's four. Bytes:
    x read, the weights read, out written; for the backward x and the
    cotangent read, dx and the f32 weight gradients written."""
    a = h * hd
    proj = 2 * b * f * d * 4 * a
    core = 2 * b * h * f * f * hd
    fwd = Op(proj + 2 * core, b * f * (d + a) * es + 4 * d * a * es)
    bwd = Op(2 * proj + 4 * core,
             b * f * (2 * d + a) * es + 4 * d * a * (es + 4))
    return fwd, bwd


def _layers(config: dict, b: int, es: int) -> list[tuple[Op, Op]]:
    return [layer_ops(b, _fields(config), d, config["attention_heads"],
                      config["attention_head_dim"], es)
            for d in _in_widths(config)]


def _total(ops) -> Op:
    ops = list(ops)
    return Op(sum(o.flops for o in ops), sum(o.bytes for o in ops))


def forward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    return {"attention.forward": _total(f for f, _ in _layers(config, b, es))}


def backward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    return {"attention.backward": _total(
        g for _, g in _layers(config, b, es))}
