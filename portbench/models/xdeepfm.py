"""xDeepFM (Lian et al., KDD 2018, arXiv:1803.05170): the model kind
``xdeepfm``.

logit = first order + head(CIN(x0)) + head(DNN(x0)); CIN layer k: z = W_k
(h_{k-1} outer x0) + b_k over the (H, F) pairs, h_k = ReLU(z), pooled by a
sum over d; no split. The DNN reads x0 flattened.

A CIN layer's weights are U(+-g / sqrt(H F)) with g = 8.4, so that each
layer keeps the rms of its input maps (about 0.29): the fixed point of
Var(z) = g^2 / 3 * E[h^2] * E[x^2] under a ReLU.

The CIN's counts are ``chip_smoke.py``'s ``cin_bound`` and
``cin_bwd_bound``.
"""

from __future__ import annotations

import math

import torch

from portbench import weights
from portbench.counts import Op
from portbench.reference import ctr

CIN_GAIN = 8.4


def _fields(config: dict) -> int:
    return config["dense_fields"] + config["sparse_fields"]


def port_config(config: dict) -> dict:
    return {"cin": {"layer_sizes": list(config["cin_layer_sizes"]),
                    "split_half": config.get("cin_split_half", False)}}


def port_names(config: dict) -> dict[str, str]:
    out = {}
    for i in range(len(config["cin_layer_sizes"])):
        out[f"cin.w{i}"] = f"cin.conv_{i}_kernel"
        out[f"cin.b{i}"] = f"cin.conv_{i}_bias"
    return out


def specs(config: dict) -> list[tuple[str, tuple, float, float]]:
    f = _fields(config)
    out, h = [], f
    for i, m in enumerate(config["cin_layer_sizes"]):
        b = CIN_GAIN / math.sqrt(h * f)
        out += [(f"cin.w{i}", (m, h * f), -b, b),
                (f"cin.b{i}", (m,), -weights.BIAS_BOUND, weights.BIAS_BOUND)]
        h = m
    return out


def dnn_width(config: dict) -> int:
    return _fields(config) * config["embed_dim"]


def heads(config: dict) -> list[tuple[str, int, str]]:
    return [("cin_head", sum(config["cin_layer_sizes"]), "cin_linear"),
            ("dnn_head", config["dnn_hidden_units"][-1], "dnn_linear")]


def cin(config, w, x0, q=ctr.identity):
    """(B, sum of the layer sizes): every layer's maps, summed over d."""
    b, f, d = x0.shape
    hidden, pooled = x0, []
    for i in range(len(config["cin_layer_sizes"])):
        outer = (q(hidden)[:, :, None, :] * q(x0)[:, None, :, :]).reshape(
            b, -1, d)
        z = torch.matmul(q(w[f"cin.w{i}"]), q(outer)) \
            + w[f"cin.b{i}"][None, :, None]
        hidden = torch.relu(q(z))
        pooled.append(hidden.sum(2))
    return q(torch.cat(pooled, dim=1))


def logit(config, w, first, x0, training: bool, q=ctr.identity):
    flat = x0.reshape(x0.shape[0], -1)
    deep = ctr._linear(ctr.dnn(config, w, flat, training, q),
                       w["dnn_head.w"], w["dnn_head.b"], q)[:, 0]
    second = ctr._linear(cin(config, w, x0, q), w["cin_head.w"],
                         w["cin_head.b"], q)[:, 0]
    return first + second + deep


def cin_forward(b, f, d, layer_sizes, es) -> Op:
    """Per layer the contraction (2 B M H F D) and the outer product
    (B H F D); x0, the weights and biases read, the pooled maps written."""
    flops, nbytes, h = 0, b * f * d * es, f
    for m in layer_sizes:
        flops += 2 * b * m * h * f * d + b * h * f * d
        nbytes += m * h * f * es + 4 * m
        h = m
    return Op(flops, nbytes + b * sum(layer_sizes) * es)


def cin_backward(b, f, d, layer_sizes, es) -> Op:
    """Per layer the two products the gradient needs, dW and W^T dcomp
    (2 B D M H F each), the outer product h x0 again for dW and the two
    group sums (dh and dx0); each layer's maps h are taken as kept from
    the forward, so no product of the forward is counted again. x0 and
    the cotangent read (and the pooled cotangent), each later layer's
    input maps read, dx0, dW and db written."""
    flops, h = 0, f
    nbytes = 2 * b * f * d * es + 4 * b * sum(layer_sizes)
    for i, m in enumerate(layer_sizes):
        flops += 2 * 2 * b * d * m * h * f + 2 * b * h * f * d \
            + 2 * 2 * b * h * f * d
        nbytes += m * h * f * (es + 4) + 2 * 4 * m
        if i:
            nbytes += b * h * d * es
        h = m
    return Op(flops, nbytes)


def forward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    return {"cin.forward": cin_forward(b, _fields(config), config["embed_dim"],
                                       config["cin_layer_sizes"], es)}


def backward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    return {"cin.backward": cin_backward(
        b, _fields(config), config["embed_dim"], config["cin_layer_sizes"],
        es)}
