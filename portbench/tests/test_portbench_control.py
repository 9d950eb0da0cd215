"""The comparison refuses the control and the planted faults.

The control (the reference in float8 in the program's place) and the
half-batch fault are read as ``portbench.control`` reads them on the card;
the faults planted in the program itself drive the rest of a run, its
chip check skipped, with the timed path broken underneath."""

from __future__ import annotations

import pytest
import torch
from portbench_helpers import SEED, run_tiny, tiny_benchmark

from portbench import check, control, port

MODES = [("tiny-xdeepfm.train", "control"), ("tiny-xdeepfm.train", "half_batch"),
         ("tiny-deepfm.train", "control"), ("tiny-deepfm.train", "half_batch"),
         ("tiny-xdeepfm.score", "control"), ("tiny-xdeepfm.score", "altered")]


@pytest.mark.parametrize("cell,mode", MODES)
def test_control_and_faults_in_the_programs_place_fail(cell, mode):
    reg = tiny_benchmark()
    spec = reg.cell(cell)
    fn = (control.train_numbers if spec["entry"] == "train"
          else control.score_numbers)
    numbers = fn(reg, spec, SEED, mode, "cpu")
    numbers = {k: v for k, v in numbers.items() if k != "where"}
    ok, checks = check.judge(numbers, spec["limits"])
    assert not ok, checks


def _patch_trainer(monkeypatch, wrap):
    built = port.build_trainer

    def build(*args, **kwargs):
        trainer = built(*args, **kwargs)
        wrap(trainer)
        return trainer

    monkeypatch.setattr(port, "build_trainer", build)


@pytest.mark.parametrize("cell", ["tiny-xdeepfm.train", "tiny-deepfm.train"])
def test_a_step_that_leaves_its_state_unchanged_fails(monkeypatch, cell):
    from deepfm_tpu_torch.training.steps import weighted_bce

    def frozen(trainer):
        def step(tr, ids, dense, labels, weights):
            with torch.no_grad():
                tr.model.train()
                return weighted_bce(tr.model(ids, dense)[:, 0], labels,
                                    weights)
        trainer._step_fn = step

    _patch_trainer(monkeypatch, frozen)
    out = run_tiny(tiny_benchmark(), cell, seconds=0.2)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", ["tiny-xdeepfm.train", "tiny-deepfm.train"])
def test_a_step_on_half_its_batch_fails(monkeypatch, cell):
    def halved(trainer):
        step = trainer._train_step

        def half(ids, dense, labels, weights):
            keep = torch.ones_like(weights)
            keep[weights.shape[0] // 2:] = 0
            return step(ids, dense, labels, weights * keep)
        trainer._train_step = half

    _patch_trainer(monkeypatch, halved)
    out = run_tiny(tiny_benchmark(), cell, seconds=0.2)
    assert out["correct"] is False, out["checks"]


def test_an_altered_score_fails(monkeypatch):
    made = port.predictor

    def predictor(*args, **kwargs):
        p = made(*args, **kwargs)
        predict = p.predict

        def altered(data):
            scores = predict(data)
            bs = p.config.training.batch_size
            for lo in range(0, len(scores) - 1, bs):
                scores[lo:lo + bs] = scores[lo:lo + bs][
                    (torch.arange(min(bs, len(scores) - lo)) + 1).numpy()
                    % min(bs, len(scores) - lo)]
            return scores
        p.predict = altered
        return p

    monkeypatch.setattr(port, "predictor", predictor)
    out = run_tiny(tiny_benchmark(), "tiny-xdeepfm.score", seconds=0.2)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_metric(cuda_card):
    """The card's path end to end at a CPU-test size: every per-layer
    metric of the cell is read from the trace, and the compared numbers
    are finite. (The tiny cell's limits are the CPU's; the card's bf16
    kernels read other numbers at this size, so ``correct`` is not
    asserted here: the benchmark's own runs hold the card to its
    limits.)"""
    import math
    import time

    from portbench import run

    reg = tiny_benchmark()
    out = run.run_cell(reg, "tiny-xdeepfm.train", SEED, 0.5, True, "cuda",
                       time.time())
    assert out["device"]["busy_s"] > 0 and out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {m["name"] for m in reg.per_layer(
        "tiny-xdeepfm.train")}
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
