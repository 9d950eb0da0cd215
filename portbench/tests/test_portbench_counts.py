"""The counts of ``portbench/counts`` and of the model kinds' files
against hand arithmetic at small shapes."""

from __future__ import annotations

import pytest

from portbench import counts
from portbench.registry import Registry

XDEEPFM = Registry().model("xdeepfm")


def test_cin_forward_by_hand():
    # B=2, F=3, D=4, layers (5, 6), bf16 (2 bytes)
    op = XDEEPFM.cin_forward(2, 3, 4, (5, 6), 2)
    flops = (2 * 2 * 5 * 3 * 3 * 4 + 2 * 3 * 3 * 4) \
        + (2 * 2 * 6 * 5 * 3 * 4 + 2 * 5 * 3 * 4)
    nbytes = 2 * 3 * 4 * 2 + (5 * 3 * 3 * 2 + 4 * 5) \
        + (6 * 5 * 3 * 2 + 4 * 6) + 2 * 11 * 2
    assert (op.flops, op.bytes) == (flops, nbytes)


def test_cin_backward_by_hand():
    # dW and W^T dcomp a layer, not the forward's product again
    op = XDEEPFM.cin_backward(2, 3, 4, (5,), 4)
    flops = 2 * 2 * 2 * 4 * 5 * 3 * 3 + 2 * 2 * 3 * 3 * 4 \
        + 2 * 2 * 2 * 3 * 3 * 4
    nbytes = 2 * 2 * 3 * 4 * 4 + 4 * 2 * 5 + 5 * 3 * 3 * 8 + 8 * 5
    assert (op.flops, op.bytes) == (flops, nbytes)
    # a second layer of 6 maps reads the first's 5 kept maps
    two = XDEEPFM.cin_backward(2, 3, 4, (5, 6), 4)
    flops2 = flops + 2 * 2 * 2 * 4 * 6 * 5 * 3 + 2 * 2 * 5 * 3 * 4 \
        + 2 * 2 * 2 * 5 * 3 * 4
    nbytes2 = nbytes + 4 * 2 * 6 + 6 * 5 * 3 * 8 + 8 * 6 + 2 * 5 * 4 * 4
    assert (two.flops, two.bytes) == (flops2, nbytes2)


def test_dnn_by_hand():
    fwd = counts.dnn(8, 6, (4, 2), 2, backward=False)
    assert fwd.flops == 2 * 8 * 6 * 4 + 2 * 8 * 4 * 2
    assert fwd.bytes == (8 * 10 * 2 + 24 * 2) + (8 * 6 * 2 + 8 * 2)
    both = counts.dnn(8, 6, (4,), 2, backward=True)
    assert both.flops == 3 * 2 * 8 * 6 * 4
    assert both.bytes == 8 * 10 * 2 + 24 * 2 + 8 * 14 * 2 + 24 * 4


def test_table_update_by_hand():
    # 256 rows of 11 columns, bf16 moments, 100 pairs
    op = counts.table_update(256, 11, 2, 100)
    assert op.flops == 0
    assert op.bytes == 256 * 11 * 2 * (4 + 4) + 100 * (4 + 44)


def test_least_time_takes_the_larger_bound():
    op = counts.Op(989e9, 3.35e9)  # 1 ms of bf16 FLOPs, 1 ms of bytes
    assert op.seconds(counts.PEAK_FLOPS["bfloat16"]) == pytest.approx(1e-3)
    op = counts.Op(989e9, 6.7e9)
    assert op.seconds(counts.PEAK_FLOPS["bfloat16"]) == pytest.approx(2e-3)


def test_step_ops_cover_the_step():
    cfg = {"model": "xdeepfm", "dense_fields": 1, "sparse_fields": 2,
           "field_cardinalities": [99, 100], "embed_dim": 3, "cin_layer_sizes": [4],
           "dnn_hidden_units": [5], "dnn_batch_norm": True,
           "compute_dtype": "bfloat16", "moments_dtype": "bfloat16"}
    train = counts.step_ops(XDEEPFM, cfg, 16, train=True)
    assert set(train) == {"embedding", "cin.forward", "dnn.forward", "heads",
                          "cin.backward", "dnn.backward",
                          "embedding.backward", "pair_sort", "table_update",
                          "dense_update"}
    score = counts.step_ops(XDEEPFM, cfg, 16, train=False)
    assert set(score) == {"embedding", "cin.forward", "dnn.forward", "heads"}
    # 100 + 101 rows (each field's row 0 too) padded to 256, 4 columns,
    # bf16 moments; 32 pairs
    assert train["table_update"].bytes == 256 * 4 * 2 * 8 + 32 * 20
    # leaves outside the table: dense fo w, b (1 each), dense w, b (3
    # each), CIN 4 x 9 + 4, its head 4 + 1, the DNN 9 x 5 + 5 + BN 10,
    # the DNN head 5 + 1
    assert counts.dense_params(XDEEPFM, cfg) == 2 + 6 + 40 + 5 + 60 + 6
    assert counts.least_seconds(train, "bfloat16") > counts.least_seconds(
        score, "bfloat16")
