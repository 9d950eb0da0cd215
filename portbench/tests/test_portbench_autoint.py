"""The AutoInt cell's files (``models/autoint.py``, its configuration, mix,
cell, kernel map and readers) at a CPU size: they load through the
registry, the counts agree with a count by hand, the kind's reference
logit agrees with the repo's plain AutoInt (``tests/autoint_reference.py``),
and the comparison refuses the control and the faults planted in the
program: half of each batch, the state left unchanged, the softmax
adjoint's row-sum term dropped and the projected residual's weight
gradient left out."""

from __future__ import annotations

import sys

import pytest
import torch
from conftest import ROOT
from portbench_helpers import SEED, run_tiny, tiny_benchmark

from portbench import check, control, counts, port, weights
from portbench.reference import ctr
from portbench.registry import MODEL_FUNCTIONS, Registry

CELL, TINY = "autoint-paper.train-b16k", "tiny-autoint.train"
PER_LAYER = ("mfu.train", "roofline.attention.train", "attention_share.train")


def tiny_registry():
    """The tiny cell listed wherever the full cell is."""
    reg = tiny_benchmark()
    for m in reg.benchmark["end_to_end"] + reg.benchmark["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(TINY)
    return reg


def test_the_cell_and_its_files_load_through_the_registry():
    reg = Registry()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    kind = reg.model(config["model"])
    assert all(callable(getattr(kind, f)) for f in MODEL_FUNCTIONS)
    mix = reg.traffic(cell["traffic"])
    assert (mix["batch"], mix["pool_rows"]) == (16384, 1 << 20)
    assert reg.generator(mix["generator"]).make_pool
    assert {m["name"] for m in reg.end_to_end(CELL)} == {
        "train_examples_per_s", "setup_s"}
    assert {m["name"] for m in reg.per_layer(CELL)} == set(PER_LAYER)
    for name in PER_LAYER:
        assert callable(reg.metric(name).read)
    assert reg.opmap("attention")["module"] == "attention"
    assert kind.dnn_width(config) is None
    assert kind.heads(config) == [("head", 39 * 64, "output_linear")]
    assert kind.port_config(config) == {"attention": {
        "num_heads": 2, "attention_dim": 64, "num_layers": 3}}
    assert config["reduced"] == []


def test_the_attention_counts_by_hand():
    # B=2, F=3, d=4 into a = 2 heads of 3, two layers, bf16 (2 bytes)
    kind = Registry().model("autoint")
    cfg = {"dense_fields": 1, "sparse_fields": 2, "embed_dim": 4,
           "attention_heads": 2, "attention_head_dim": 3,
           "attention_layers": 2}
    proj1, proj2 = 2 * 2 * 3 * 4 * 24, 2 * 2 * 3 * 6 * 24
    core = 2 * 2 * 2 * 3 * 3 * 3
    fwd = kind.forward_ops(cfg, 2, 2)["attention.forward"]
    assert fwd.flops == proj1 + proj2 + 2 * 2 * core
    assert fwd.bytes == (2 * 3 * (4 + 6) * 2 + 4 * 4 * 6 * 2) \
        + (2 * 3 * (6 + 6) * 2 + 4 * 6 * 6 * 2)
    bwd = kind.backward_ops(cfg, 2, 2)["attention.backward"]
    assert bwd.flops == 2 * (proj1 + proj2) + 2 * 4 * core
    assert bwd.bytes == (2 * 3 * (8 + 6) * 2 + 4 * 4 * 6 * 6) \
        + (2 * 3 * (12 + 6) * 2 + 4 * 6 * 6 * 6)


def test_the_paper_cells_counts_a_step():
    """12.13 MFLOP an example in the interacting layers (4.04 forward,
    8.09 for the gradient's products) at F = 39, d = 16, 2 x 32, 3 layers;
    the step's operations and the leaves outside the table."""
    reg = Registry()
    config = reg.config("autoint-paper")
    kind = reg.model("autoint")
    ops = counts.step_ops(kind, config, 16384, train=True)
    assert set(ops) == {"embedding", "attention.forward", "heads",
                        "attention.backward", "embedding.backward",
                        "pair_sort", "table_update", "dense_update"}
    assert ops["attention.forward"].flops == 4_043_520 * 16384
    assert ops["attention.backward"].flops == 8_087_040 * 16384
    # dense fields' first-order w, b (13 each) and w, b (13 x 16 each); the
    # layers' 4 x (16 + 64 + 64) x 64; the head 2496 + 1
    assert counts.dense_params(kind, config) == 26 + 416 + 36_864 + 2497


def test_the_kinds_logit_is_the_repos_reference():
    sys.path.insert(0, str(ROOT / "tests"))
    import autoint_reference as ref

    reg = tiny_registry()
    config = reg.config("tiny-autoint")
    kind = reg.model("autoint")
    w = weights.make_weights(kind, config, SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    ids = torch.stack([torch.randint(0, c + 1, (32,), generator=g)
                       for c in config["field_cardinalities"]], 1)
    dense = torch.randn(32, config["dense_fields"], generator=g)
    sizes = torch.tensor([c + 1 for c in config["field_cardinalities"]])
    theirs = {"table": w["table"], "dense_w": w["dense_w"],
              "dense_b": w["dense_b"], "head.w": w["head.w"],
              "head.b": w["head.b"]}
    for i in range(config["attention_layers"]):
        for n in ref.NAMES:
            theirs[f"layer{i}.{n}"] = w[f"attention.{i}.{n}"]
    with ctr.full_f32(), torch.no_grad():
        got = ctr.logits(kind, config, w, ids, dense, True)
        want = ref.logits(theirs, ids, dense, torch.cumsum(sizes, 0) - sizes,
                          config["attention_heads"],
                          config["attention_layers"])
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    # ReLU outputs and scores of order 1 at the kind's weight scales
    x0 = ref.embed(theirs, ids, dense, torch.cumsum(sizes, 0) - sizes)
    out = ref.stack(x0, theirs, config["attention_heads"], 1)
    assert 0.3 < (out > 0).float().mean() < 0.7


def test_a_short_cpu_run_is_correct_and_reads_no_device_metric():
    reg = tiny_registry()
    out = run_tiny(reg, TINY, trace=True)
    assert out["correct"] is True, out["checks"]
    assert not set(out["metrics"]) & set(PER_LAYER)
    out = run_tiny(reg, TINY)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}


@pytest.mark.parametrize("mode", ["control", "half_batch"])
def test_the_control_and_half_batch_fail(mode):
    reg = tiny_registry()
    spec = reg.cell(TINY)
    numbers = control.train_numbers(reg, spec, SEED, mode, "cpu")
    ok, checks = check.judge(
        {k: v for k, v in numbers.items() if k != "where"}, spec["limits"])
    assert not ok, checks


def _row_sum_dropped(monkeypatch):
    from deepfm_tpu_torch.ops.kernels import attention

    monkeypatch.setattr(attention, "softmax_backward", lambda w, dw: w * dw)


def _dwres_left_out(monkeypatch):
    from deepfm_tpu_torch.ops.kernels import attention

    plain = attention.interacting_backward_plain

    def backward(*args, **kwargs):
        dx, grads = plain(*args, **kwargs)
        return dx, {**grads, "wres": torch.zeros_like(grads["wres"])}

    monkeypatch.setattr(attention, "interacting_backward_plain", backward)


def _state_unchanged(monkeypatch):
    from deepfm_tpu_torch.training.steps import weighted_bce

    built = port.build_trainer

    def build(*args, **kwargs):
        trainer = built(*args, **kwargs)

        def step(tr, ids, dense, labels, weights):
            with torch.no_grad():
                tr.model.train()
                return weighted_bce(tr.model(ids, dense)[:, 0], labels,
                                    weights)
        trainer._step_fn = step
        return trainer

    monkeypatch.setattr(port, "build_trainer", build)


@pytest.mark.parametrize("plant", [_row_sum_dropped, _dwres_left_out,
                                   _state_unchanged])
def test_a_fault_planted_in_the_program_fails(plant, monkeypatch):
    plant(monkeypatch)
    out = run_tiny(tiny_registry(), TINY, seconds=0.2)
    assert out["correct"] is False, out["checks"]
