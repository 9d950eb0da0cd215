"""The port's ``train``, ``evaluate`` and ``compare`` commands against the
JAX CLI's, on the CPU.

The port's ``synth-data`` writes a small MovieLens-format dataset (the
same files as the JAX command's); both CLIs train
``configs/xdeepfm_movielens_cin_tuned.yaml`` cut to small widths on it
for two epochs with ``device=cpu`` and ``training.resume=true``. Held:

  * the port writes the JAX run's artifacts: the best checkpoint and its
    metadata, the resume state and ``last_state_meta.json`` (the JAX
    keys), results.json (the JAX top-level, ``training_info``, history and
    metric keys) and its own train.log with its epoch lines;
  * ``evaluate`` reloads the best checkpoint and, with the same seed (the
    same eval negatives), reproduces the val metrics results.json records
    for the best epoch exactly, and its test metrics where the best epoch
    is the last (train's test evaluation runs on the last epoch's state);
  * ``compare`` prints, for a directory holding both runs, the JAX
    command's table character for character.

The two runs start from different weights (each package draws its own),
so their metric values are not compared here; tests/test_torch_trainer_loop.py
holds the loop's numbers against the JAX ``Trainer``.
"""

import json
import logging

import pytest
import torch

from deepfm_tpu.cli import main as jax_main
from deepfm_tpu_torch.cli import evaluate_command
from deepfm_tpu_torch.cli import main as port_main
from deepfm_tpu_torch.config import load_config
from deepfm_tpu_torch.utils import get_logger

torch.set_num_threads(1)

CONFIG = "configs/xdeepfm_movielens_cin_tuned.yaml"
FILES = ("u.data", "u.user", "u.item")


def _overrides(root, run):
    return [
        f"data.data_dir={root / 'data'}", "data.num_neg_train=1",
        "data.num_neg_eval=5", "data.use_native_sampler=false",
        "feature.fm_embed_dim=8", "cin.layer_sizes=[8,8]",
        "dnn.hidden_units=[16,8]", "training.num_epochs=2",
        "training.batch_size=64", "training.resume=true", "device=cpu",
        f"output_dir={root / run}",
    ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    synth = ["--users", "30", "--items", "40", "--rows", "900", "--seed", "3"]
    port_main(["synth-data", "--dir", str(root / "data"), *synth])
    jax_main(["synth-data", "--dir", str(root / "jax_data"), *synth])
    for name in FILES:
        assert (root / "data" / name).read_bytes() == (
            root / "jax_data" / name).read_bytes(), name
    port_main(["train", "--config", CONFIG, "--override",
               *_overrides(root, "port")])
    jax_main(["train", "--config", CONFIG, "--override",
              *_overrides(root, "jax")])
    return root


def _json(path):
    return json.loads(path.read_text())


def test_train_writes_the_jax_artifacts(runs):
    port, jax = runs / "port", runs / "jax"
    for name in ("best_model_meta.json", "last_state_meta.json",
                 "results.json"):
        assert (port / name).exists() and (jax / name).exists(), name
    # (the JAX CLI writes train.log only where its logger is configured
    # for the first time in the process; the port's writes one every run)
    assert (port / "best_model.pt").exists()
    assert (port / "last_state.pt").exists()
    pres, jres = _json(port / "results.json"), _json(jax / "results.json")
    assert set(pres) == set(jres)
    assert set(pres["training_info"]) == set(jres["training_info"])
    assert pres["training_info"]["total_epochs"] == 2
    assert pres["training_info"]["backward"] == "sparse_fused"
    assert [set(h) for h in pres["history"]] == [
        set(h) for h in jres["history"]]
    assert set(pres["val_metrics"]) == set(jres["val_metrics"])
    assert set(pres["test_metrics"]) == set(jres["test_metrics"])
    assert pres["config"] == {**jres["config"],
                              "output_dir": str(port)}
    pmeta = _json(port / "last_state_meta.json")
    jmeta = _json(jax / "last_state_meta.json")
    assert set(pmeta) == set(jmeta) and pmeta["epoch"] == jmeta["epoch"] == 2
    assert set(_json(port / "best_model_meta.json")) == set(
        _json(jax / "best_model_meta.json"))
    log = (port / "train.log").read_text()
    assert "Epoch 1/2" in log and "Epoch 2/2" in log
    assert "Results saved to" in log


def test_evaluate_reproduces_the_train_metrics(runs):
    config = load_config(CONFIG, _overrides(runs, "port"))
    got = evaluate_command(config)
    res = _json(runs / "port" / "results.json")
    assert got["val"] == res["val_metrics"]
    info = res["training_info"]
    if info["best_epoch"] == info["total_epochs"]:
        assert got["test"] == res["test_metrics"]
    else:  # the best epoch's own val metrics, as history recorded them
        best = res["history"][info["best_epoch"] - 1]
        assert {f"val_{k}": v for k, v in got["val"].items()} == {
            k: v for k, v in best.items() if k.startswith("val_")}


def test_compare_prints_the_jax_table(runs, capsys):
    port_main(["compare", "--dir", str(runs)])
    port_out = capsys.readouterr().out
    jax_main(["compare", "--dir", str(runs)])
    jax_out = capsys.readouterr().out
    assert port_out == jax_out
    rows = [line for line in port_out.splitlines()
            if line.startswith(("port", "jax"))]
    assert len(rows) == 2 and "xdeepfm" in rows[0]
    port_main(["compare", "--dir", str(runs / "data")])
    assert "No results.json files found" in capsys.readouterr().out


def test_each_run_logs_to_its_own_file(tmp_path):
    """A child logger fetched before its package's prints through the
    package's sink, once; each log_file takes the place of the one before,
    so two runs in one process write two logs."""
    child = get_logger("port_log_test.trainer")
    package = logging.getLogger("port_log_test")
    assert not child.handlers and child.propagate
    assert len(package.handlers) == 1 and not package.propagate
    for run in ("a", "b"):
        get_logger("port_log_test", log_file=str(tmp_path / run / "train.log"))
        child.info(f"run {run}")
    files = [h for h in package.handlers if isinstance(h, logging.FileHandler)]
    assert len(files) == 1
    for h in files:
        package.removeHandler(h)
        h.close()
    for run in ("a", "b"):
        lines = (tmp_path / run / "train.log").read_text().splitlines()
        assert len(lines) == 1 and lines[0].endswith(f"INFO: run {run}")
