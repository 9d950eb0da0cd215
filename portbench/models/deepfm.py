"""DeepFM (Guo et al., IJCAI 2017, arXiv:1703.04247): the model kind
``deepfm``.

logit = first order + 0.5 * sum_d[(sum_f x0)^2 - sum_f x0^2]
+ head(DNN(x0)); the DNN reads x0 flattened. The factorization machine has
no leaves of its own.
"""

from __future__ import annotations

from portbench.counts import Op
from portbench.reference import ctr


def port_config(config: dict) -> dict:
    return {}


def port_names(config: dict) -> dict[str, str]:
    return {}


def specs(config: dict) -> list[tuple[str, tuple, float, float]]:
    return []


def _x0_width(config: dict) -> int:
    return (config["dense_fields"] + config["sparse_fields"]) \
        * config["embed_dim"]


def dnn_width(config: dict) -> int:
    return _x0_width(config)


def heads(config: dict) -> list[tuple[str, int, str]]:
    return [("dnn_head", config["dnn_hidden_units"][-1], "output_linear")]


def logit(config, w, first, x0, training: bool, q=ctr.identity):
    flat = x0.reshape(x0.shape[0], -1)
    deep = ctr._linear(ctr.dnn(config, w, flat, training, q),
                       w["dnn_head.w"], w["dnn_head.b"], q)[:, 0]
    s = x0.sum(1)
    second = q(0.5 * (s * s - (x0 * x0).sum(1)).sum(1))
    return first + second + deep


def forward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    """The pairwise term: a sum over the fields, its square and the
    squares' sum (3 B F D); the embeddings read, the term written."""
    n = b * _x0_width(config)
    return {"fm.forward": Op(3 * n, n * es + b * es)}


def backward_ops(config: dict, b: int, es: int) -> dict[str, Op]:
    n = b * _x0_width(config)
    return {"fm.backward": Op(3 * n, 2 * n * es)}
