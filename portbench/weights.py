"""The cell's weights, made on the device from the seed in one draw.

Both sides get these: the port through ``port.build_model`` (its
``load_state_dict``), the reference as they are. Names are the
reference's (``reference/ctr.py`` and the model kind's file,
``models/<kind>.py``). Scales are chosen so that every part of the logit
is of order 1: the DNN's layers keep their inputs' scale and each head
reads U(+-1 / sqrt(width)); a kind scales its own leaves. Each field's
row 0 (the port's padding row) and the table's padding rows are 0.
"""

from __future__ import annotations

import math

import torch

from portbench import fields, seeds

EMB_BOUND, FO_BOUND, BIAS_BOUND = 0.5, 0.1, 0.1
X0_MEAN_SQUARE = 0.085  # E[x^2] of the field embeddings (U(+-0.5))
RELU_BN_MEAN_SQUARE = 0.5  # E[x^2] after BatchNorm and ReLU


def specs(kind, config: dict) -> list[tuple[str, tuple, float, float]]:
    """(name, shape, low, high) of every leaf and BatchNorm statistic, in
    draw order: the embedding leaves, the kind's own, the DNN's and the
    heads'; the table's columns are scaled afterwards."""
    nd, d = config["dense_fields"], config["embed_dim"]
    out = [("table", (fields.table_rows(config), d + 1), -1.0, 1.0),
           ("dense_fo_w", (nd,), -FO_BOUND, FO_BOUND),
           ("dense_fo_b", (nd,), -FO_BOUND, FO_BOUND),
           ("dense_w", (nd, d), -EMB_BOUND, EMB_BOUND),
           ("dense_b", (nd, d), -BIAS_BOUND, BIAS_BOUND)]
    out += kind.specs(config)
    width, ms = kind.dnn_width(config), X0_MEAN_SQUARE
    for i, units in enumerate(config["dnn_hidden_units"]
                              if width is not None else ()):
        b = math.sqrt(3.0 / (width * ms))
        out += [(f"dnn.w{i}", (units, width), -b, b),
                (f"dnn.b{i}", (units,), -BIAS_BOUND, BIAS_BOUND)]
        if config["dnn_batch_norm"]:
            out += [(f"bn.gamma{i}", (units,), 0.8, 1.2),
                    (f"bn.beta{i}", (units,), -BIAS_BOUND, BIAS_BOUND),
                    (f"bn.mean{i}", (units,), -BIAS_BOUND, BIAS_BOUND),
                    (f"bn.var{i}", (units,), 0.8, 1.2)]
        width, ms = units, RELU_BN_MEAN_SQUARE
    for name, n, _ in kind.heads(config):
        b = 1.0 / math.sqrt(n)
        out += [(f"{name}.w", (1, n), -b, b), (f"{name}.b", (1,), -b, b)]
    return out


def make_weights(kind, config: dict, seed: int,
                 device) -> dict[str, torch.Tensor]:
    """Every weight of the configuration, f32 on ``device``: one draw of
    U(0, 1) from the seed's "weights" stream, cut into the leaves."""
    sp = specs(kind, config)
    sizes = [math.prod(shape) for _, shape, _, _ in sp]
    g = seeds.generator(seed, "weights", device)
    flat = torch.rand(sum(sizes), generator=g, device=device)
    out = {}
    for (name, shape, lo, hi), part in zip(sp, flat.split(sizes)):
        out[name] = part.view(shape).mul_(hi - lo).add_(lo)
    d = config["embed_dim"]
    table = out["table"]
    table[:, :d].mul_(EMB_BOUND)
    table[:, d].mul_(FO_BOUND)
    table[fields.offsets(config)] = 0.0
    table[sum(fields.vocab_sizes(config)):] = 0.0
    return out
