"""The port's trainer loop on two gloo ranks, through the CLI's
commands, on the CPU.

A small MovieLens set (``synth-data``: 30 users, 40 items, 900 ratings)
and configs/xdeepfm_movielens_cin_tuned.yaml cut to small widths (dropout
0.1 kept). One process trains "single" for 2 epochs; then two rank
processes (``tests/torch_dp_worker.py::dp_loop``) train "dp" for 2
epochs, evaluate it and "single", train "resumed" for 1 epoch and resume
it to 2, and try to resume "single" to 3 epochs. Held:

  * rank 0 writes one best checkpoint, one resume state, one results.json
    and one train.log (each epoch line once); results.json records the
    mesh (2 x 1), the replicated sparse-fused path and two devices;
  * a one-process ``evaluate`` of the two-rank checkpoint gives the val
    metrics of its best epoch and, where that epoch is the last, the test
    metrics ``train`` wrote, exactly; the two ranks' ``evaluate`` of it
    give the same metrics exactly (each rank scores its share of whole
    batches and the scores are all-gathered);
  * a checkpoint written by one process restores at two ranks: their
    ``evaluate`` of "single" equals the one process's exactly;
  * the resumed run's history equals the unbroken run's (the clock
    readings aside), on both ranks;
  * a resume into another world size is refused, naming the dropout
    generator's per-rank state.
"""

import json
import sys

import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402

from deepfm_tpu_torch.cli import evaluate_command, train_command  # noqa: E402
from deepfm_tpu_torch.cli import main as port_main  # noqa: E402

torch.set_num_threads(1)

CLOCK = ("epoch_seconds", "examples_per_sec")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    port_main(["synth-data", "--dir", str(root / "data"), "--users", "30",
               "--items", "40", "--rows", "900", "--seed", "3"])
    train_command(torch_dp_worker.loop_config(root, "single", 2))
    ranks = torch_dp_worker.spawn(2, torch_dp_worker.dp_loop, (str(root),),
                                  root / "ranks")
    return root, ranks


def _clock_free(history):
    return [{k: v for k, v in h.items() if k not in CLOCK} for h in history]


def test_rank_0_writes_one_set_of_files(runs):
    root, ranks = runs
    dp = root / "dp"
    names = sorted(p.name for p in dp.iterdir())
    assert names == ["best_model.pt", "best_model_meta.json",
                     "last_state.pt", "last_state_meta.json",
                     "results.json", "train.log"]
    log = (dp / "train.log").read_text()
    assert log.count("Epoch 1/2") == 1 and log.count("Epoch 2/2") == 1
    info = json.loads((dp / "results.json").read_text())["training_info"]
    assert info["mesh"] == {"data": 2, "model": 1}
    assert info["backward"] == "sparse_fused_replicated"
    assert info["num_devices"] == 2
    assert info["examples_per_sec_per_device"] == pytest.approx(
        info["examples_per_sec"] / 2)
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 1}] * 2


def test_one_process_evaluate_reproduces_the_two_rank_run(runs):
    root, ranks = runs
    results = json.loads((root / "dp" / "results.json").read_text())
    got = evaluate_command(torch_dp_worker.loop_config(root, "dp", 2))
    assert got["val"] == results["val_metrics"]
    info = results["training_info"]
    if info["best_epoch"] == info["total_epochs"]:
        assert got["test"] == results["test_metrics"]
    for r in ranks:
        assert r["evaluate_dp"] == got


def test_a_one_process_checkpoint_restores_at_two_ranks(runs):
    root, ranks = runs
    want = evaluate_command(torch_dp_worker.loop_config(root, "single", 2))
    for r in ranks:
        assert r["evaluate_single"] == want


def test_a_resumed_run_repeats_the_unbroken_one(runs):
    _, ranks = runs
    for r in ranks:
        assert len(r["history"]) == 2
        assert _clock_free(r["resumed_history"]) == _clock_free(r["history"])
    assert _clock_free(ranks[0]["history"]) == _clock_free(
        ranks[1]["history"])


def test_a_resume_into_another_world_size_is_refused(runs):
    _, ranks = runs
    for r in ranks:
        assert r["cross_world_resume"] is not None
        assert r["cross_world_resume"].startswith(
            "Cannot resume: checkpoint was written by 1 ranks and this run "
            "has 2. The dropout generator's state is per rank")
