"""The port's trainer loop on two gloo ranks at a (1, 2) mesh (every
table cut into two slabs, the all_to_all strategy: the routed
sparse-fused branch), through the CLI's commands, on the CPU.

The small MovieLens set of tests/test_torch_dp_loop.py and its cut
configs/xdeepfm_movielens_cin_tuned.yaml (dropout 0.1 kept), with
``mesh.model_axis=2`` and ``mesh.embedding_strategy=all_to_all``. One
process trains "single" for 2 epochs; then two rank processes
(``tests/torch_dp_worker.py::shard_loop``) train "sharded" for 2 epochs,
evaluate it and "single", train "resumed" for 1 epoch and resume it to 2,
and resume a copy of "single" to 3 epochs. Held (exactly, every one):

  * each rank holds half of every table's rows; rank 0 writes one best
    checkpoint, one resume state, one results.json and one train.log, its
    tables whole (the one-process model's shapes); results.json records
    the 1 x 2 mesh and the routed sparse-fused path;
  * a one-process ``evaluate`` of the sharded checkpoint gives the val
    metrics of its best epoch and, where that epoch is the last, the test
    metrics ``train`` wrote; the ranks' ``evaluate`` of it gives the same;
  * a checkpoint written by one process restores at (1, 2): the ranks'
    ``evaluate`` of "single" equals the one process's;
  * the resumed run's history equals the unbroken run's (the clock
    readings aside), on both ranks;
  * a resume of the one-process run at (1, 2) is taken (one data row, as
    one process has: the dropout generator carries on), and its first two
    epochs are the one process's.
"""

import json
import shutil
import sys

import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402

from deepfm_tpu_torch.cli import evaluate_command, train_command  # noqa: E402
from deepfm_tpu_torch.cli import main as port_main  # noqa: E402

torch.set_num_threads(1)

CLOCK = ("epoch_seconds", "examples_per_sec")
SHARD = torch_dp_worker.SHARD_LOOP


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_loop")
    port_main(["synth-data", "--dir", str(root / "data"), "--users", "30",
               "--items", "40", "--rows", "900", "--seed", "3"])
    single = train_command(torch_dp_worker.loop_config(root, "single", 2))
    shapes = {n: tuple(p.shape) for n, p in single.params.items()
              if n in single.table_names}
    history = single.history
    shutil.copytree(root / "single", root / "single_kept")
    ranks = torch_dp_worker.spawn(2, torch_dp_worker.shard_loop, (str(root),),
                                  root / "ranks", axes=(1, 2))
    return root, ranks, shapes, history


def _clock_free(history):
    return [{k: v for k, v in h.items() if k not in CLOCK} for h in history]


def test_rank_0_writes_one_set_of_files_with_whole_tables(runs):
    root, ranks, shapes, _ = runs
    run = root / "sharded"
    names = sorted(p.name for p in run.iterdir())
    assert names == ["best_model.pt", "best_model_meta.json",
                     "last_state.pt", "last_state_meta.json",
                     "results.json", "train.log"]
    info = json.loads((run / "results.json").read_text())["training_info"]
    assert info["mesh"] == {"data": 1, "model": 2}
    assert info["backward"] == "sparse_fused_routed"
    assert info["num_devices"] == 2
    best = torch.load(run / "best_model.pt", weights_only=True)
    resume = torch.load(run / "last_state.pt", weights_only=True)
    for name, shape in shapes.items():
        assert tuple(best[name].shape) == shape
        assert tuple(resume["model"][name].shape) == shape
        assert tuple(resume["table_opt"][name]["mu"].shape) == shape
        for r in ranks:
            assert r["slab_rows"][name] == shape[0] // 2
    assert [r["mesh"] for r in ranks] == [{"data": 1, "model": 2}] * 2


def test_one_process_evaluate_reproduces_the_sharded_run(runs):
    root, ranks, _, _ = runs
    results = json.loads((root / "sharded" / "results.json").read_text())
    got = evaluate_command(torch_dp_worker.loop_config(root, "sharded", 2))
    assert got["val"] == results["val_metrics"]
    info = results["training_info"]
    if info["best_epoch"] == info["total_epochs"]:
        assert got["test"] == results["test_metrics"]
    for r in ranks:
        assert r["evaluate_sharded"] == got


def test_a_one_process_checkpoint_restores_on_the_sharded_mesh(runs):
    root, ranks, _, _ = runs
    want = evaluate_command(torch_dp_worker.loop_config(root, "single_kept",
                                                        2))
    for r in ranks:
        assert r["evaluate_single"] == want


def test_a_resumed_sharded_run_repeats_the_unbroken_one(runs):
    _, ranks, _, _ = runs
    for r in ranks:
        assert len(r["history"]) == 2
        assert _clock_free(r["resumed_history"]) == _clock_free(r["history"])
    assert _clock_free(ranks[0]["history"]) == _clock_free(
        ranks[1]["history"])


def test_a_one_process_run_resumes_on_one_data_row(runs):
    _, ranks, _, history = runs
    for r in ranks:
        got = r["single_on_mesh_history"]
        assert len(got) == 3
        assert _clock_free(got[:2]) == _clock_free(history)
