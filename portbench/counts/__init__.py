"""Operations and bytes of a step, counted from the shapes alone, and the
least time each takes on one H100.

The CIN's counts are ``chip_smoke.py``'s ``cin_bound`` and
``cin_bwd_bound``; the rest extends them to the whole step. Each operation
counts its inputs read once and its outputs written once, whatever a
kernel reads again, and the least time of an operation is the larger of
its FLOPs over the dense peak of the configuration's compute dtype and
its bytes over the HBM rate. The counts follow the algorithm, not the
kernels: a later change that fuses, splits or replaces a kernel leaves
them as they are.
"""

from __future__ import annotations

from dataclasses import dataclass

from portbench import fields

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


def dense_params(config: dict) -> int:
    """Parameters outside the table."""
    nd, d = config["dense_fields"], config["embed_dim"]
    f = nd + config["sparse_fields"]
    n = 2 * nd + 2 * nd * d
    if config["model"] == "xdeepfm":
        h = f
        for m in config["cin_layer_sizes"]:
            n += m * h * f + m
            h = m
        n += sum(config["cin_layer_sizes"]) + 1
    width = f * d
    for out in config["dnn_hidden_units"]:
        n += width * out + out + (2 * out if config["dnn_batch_norm"] else 0)
        width = out
    return n + width + 1


def step_ops(config: dict, batch: int, train: bool) -> dict[str, Op]:
    """The operations of one train step (``train``) or one scoring
    forward of ``batch`` rows, by name."""
    es = DTYPE_BYTES[config["compute_dtype"]]
    mes = DTYPE_BYTES[config["moments_dtype"]]
    b, d = batch, config["embed_dim"]
    ns, nd = config["sparse_fields"], config["dense_fields"]
    f, dcol = ns + nd, d + 1
    pairs = b * ns
    ops = {"embedding": Op(2 * b * f * d,
                           pairs * (4 + 4 * dcol) + b * nd * 4
                           + b * f * d * es + 4 * b)}
    if config["model"] == "xdeepfm":
        ops["cin.forward"] = cin_forward(b, f, d, config["cin_layer_sizes"],
                                         es)
    else:
        ops["fm.forward"] = Op(3 * b * f * d, b * f * d * es + b * es)
    ops["dnn.forward"] = dnn(b, f * d, config["dnn_hidden_units"], es, False)
    heads = config["dnn_hidden_units"][-1] + (
        sum(config["cin_layer_sizes"]) if config["model"] == "xdeepfm" else 0)
    ops["heads"] = Op(2 * b * heads * (3 if train else 1),
                      b * heads * es * (2 if train else 1) + 12 * b)
    if not train:
        return ops
    if config["model"] == "xdeepfm":
        ops["cin.backward"] = cin_backward(b, f, d,
                                           config["cin_layer_sizes"], es)
    else:
        ops["fm.backward"] = Op(3 * b * f * d, 2 * b * f * d * es)
    ops["dnn.backward"] = dnn(b, f * d, config["dnn_hidden_units"], es, True)
    # the rows' cotangents written, the pairs sorted (read and written)
    ops["embedding.backward"] = Op(0, b * f * d * es + pairs * 4 * dcol)
    ops["pair_sort"] = Op(0, pairs * (8 + 4 + 2 * 4 * dcol))
    rows = fields.table_rows(config)
    ops["table_update"] = table_update(rows, dcol, mes, pairs)
    p = dense_params(config)
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
