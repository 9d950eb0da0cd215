"""Operations and bytes of a step, counted from the shapes alone, and the
least time each takes on one H100.

What every model kind shares is counted here (the embedding, the DNN,
the heads, the pair sort and the table and dense updates); a kind's own
operations come from its file (``models/<kind>.py``, passed in as
``kind``). Each operation counts its inputs read once and its outputs
written once, whatever a kernel reads again, and the least time of an
operation is the larger of its FLOPs over the dense peak of the
configuration's compute dtype and its bytes over the HBM rate. The
counts follow the algorithm, not the kernels: a later change that fuses,
splits or replaces a kernel leaves them as they are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from portbench import fields, weights

# NVIDIA H100 SXM data sheet, dense rates without sparsity (700 W).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "float8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Op:
    flops: float
    bytes: float

    def seconds(self, peak_flops: float) -> float:
        return max(self.flops / peak_flops, self.bytes / PEAK_BYTES_PER_S)


def dnn(b, width, units, es, backward: bool) -> Op:
    """Linear layers with BatchNorm and ReLU: 2 B in out a product (three
    products with the backward); activations read and written once a
    layer, weights read (and their gradients written, f32)."""
    flops = nbytes = 0
    for out in units:
        mult = 3 if backward else 1
        flops += mult * 2 * b * width * out
        nbytes += b * (width + out) * es + width * out * es
        if backward:
            nbytes += b * (width + 2 * out) * es + width * out * 4
        width = out
    return Op(flops, nbytes)


def dense_params(kind, config: dict) -> int:
    """Trained parameters outside the table (``weights.specs`` but for the
    table and the BatchNorm statistics)."""
    return sum(math.prod(shape) for name, shape, _, _ in
               weights.specs(kind, config)
               if name != "table" and not name.startswith(("bn.mean",
                                                           "bn.var")))


def step_ops(kind, config: dict, batch: int, train: bool) -> dict[str, Op]:
    """The operations of one train step (``train``) or one scoring
    forward of ``batch`` rows, by name."""
    es = DTYPE_BYTES[config["compute_dtype"]]
    mes = DTYPE_BYTES[config["moments_dtype"]]
    b, d = batch, config["embed_dim"]
    ns, nd = config["sparse_fields"], config["dense_fields"]
    f, dcol = ns + nd, d + 1
    pairs = b * ns
    units = config["dnn_hidden_units"]
    width = kind.dnn_width(config)
    heads = sum(n_in for _, n_in, _ in kind.heads(config))
    ops = {"embedding": Op(2 * b * f * d,
                           pairs * (4 + 4 * dcol) + b * nd * 4
                           + b * f * d * es + 4 * b),
           **kind.forward_ops(config, b, es)}
    if width is not None:
        ops["dnn.forward"] = dnn(b, width, units, es, False)
    if heads:
        ops["heads"] = Op(2 * b * heads * (3 if train else 1),
                          b * heads * es * (2 if train else 1) + 12 * b)
    if not train:
        return ops
    ops.update(kind.backward_ops(config, b, es))
    if width is not None:
        ops["dnn.backward"] = dnn(b, width, units, es, True)
    # the rows' cotangents written, the pairs sorted (read and written)
    ops["embedding.backward"] = Op(0, b * f * d * es + pairs * 4 * dcol)
    ops["pair_sort"] = Op(0, pairs * (8 + 4 + 2 * 4 * dcol))
    rows = fields.table_rows(config)
    ops["table_update"] = table_update(rows, dcol, mes, pairs)
    p = dense_params(kind, config)
    ops["dense_update"] = Op(0, p * (4 + 7 * 4))
    return ops


def table_update(rows: int, dcol: int, moment_bytes: int, pairs: int) -> Op:
    """The table and its two moments read and written once, the sorted
    pairs (int32 id, f32 cotangent) read once."""
    return Op(0, rows * dcol * 2 * (4 + 2 * moment_bytes)
              + pairs * (4 + 4 * dcol))


def least_seconds(ops: dict[str, Op], compute_dtype: str,
                  names=None) -> float:
    """The least time of the named operations (all by default)."""
    peak = PEAK_FLOPS[compute_dtype]
    return sum(op.seconds(peak) for n, op in ops.items()
               if names is None or n in names)
