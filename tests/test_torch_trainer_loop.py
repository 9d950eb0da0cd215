"""The port's trainer loop (``Trainer.train``) against the JAX package's, on
the CPU.

Both packages fit their MovieLens adapters on the same small synthetic
dataset (the JAX one with ``data.use_native_sampler=false``; the two pack
the same arrays, tests/test_torch_serving.py), the JAX ``Trainer`` is built
as tests/test_torch_train.py builds it for the sparse-fused path
(``DEEPFM_TPU_FORCE_FUSED_ADAM=1``, packed tables, the Pallas kernels in
interpret mode), its initial parameters are carried into the port's model
with ``convert.params_from_jax``, and both train at dropout 0 and f32 with
their adapters resampling the train negatives every epoch.

  * batch order: for a seed, the port's ``_chunk_plan`` yields the JAX
    ``Trainer``'s batches (ids, dense, labels and weights, the padding
    included, the chunks of a small staging budget too);
  * two epochs of DeepFM and of xDeepFM without BatchNorm: per-epoch
    train loss within the two-step parity rule's loss tolerance (rel 1e-6,
    ``LOSS_REL``), val metrics and the final test metrics within its rtol
    (1e-5, ``METRIC_REL``), and the final parameters by
    ``training/parity.py``'s rule over the run's steps (its band
    2 * lr * steps). Measured here: losses within 2.3e-7, metrics within
    1.2e-7;
  * two epochs of DeepFM with BatchNorm: the loss as above; the metrics
    within rel ``BN_METRIC_REL`` = 2e-3. A Dense bias feeding a train-mode
    BatchNorm has an exact gradient of 0 (parity.py holds it to its band
    alone): Adam walks it by up to lr a step on rounding noise, differently
    in the two packages, and the eval-mode BatchNorm subtracts running
    means that follow it, so the eval scores part by more than the train
    loss does (measured: val logloss 1.4e-4, pcoc 3.8e-4 after 2 epochs);
  * the loop's behaviour: the plateau scheduler's and the warmup-cosine
    scheduler's epoch steps (the history's learning rates) and early
    stopping (the epochs run, the best epoch) as the JAX loop takes them;
  * resume: a run stopped after epoch 1 and resumed to epoch 2 equals an
    unbroken run of 2 epochs bit for bit (history, parameters, optimizer
    and table state), dropout 0.1 included;
  * results.json and last_state_meta.json carry the JAX package's keys.
"""

import json
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import config_pair  # noqa: E402

from deepfm_tpu.data.movielens import MovieLensAdapter as JaxAdapter  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.data.synthetic import (  # noqa: E402
    generate_movielens_like as jax_generate,
)
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu_torch.convert import params_from_jax  # noqa: E402
from deepfm_tpu_torch.data.movielens import MovieLensAdapter  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.training.parity import compare_leaves  # noqa: E402
from deepfm_tpu_torch.training.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

LR = 1e-3
LOSS_REL = 1e-6
METRIC_REL = 1e-5
BN_METRIC_REL = 2e-3
TIMING = ("epoch_seconds", "examples_per_sec")
MODELS = {
    "deepfm": {},
    "xdeepfm": {"cin": {"layer_sizes": [8, 8], "split_half": True}},
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_loop")
    jax_generate(root, num_users=30, num_items=40, num_rows=900, seed=5)
    return root


def _raw(data_dir, out, model="deepfm", training=None, dnn=None):
    tr = {"batch_size": 128, "num_epochs": 2, "lr": LR,
          "scheduler": "reduce_on_plateau", "ranking_ks": [1, 5]}
    tr.update(training or {})
    return {
        "model_name": model,
        "seed": 7,
        "device": "cpu",
        "output_dir": str(out),
        "data": {"data_dir": str(data_dir), "num_neg_train": 1,
                 "num_neg_eval": 5, "use_native_sampler": False},
        "feature": {"fm_embed_dim": 8},
        "dnn": {"hidden_units": [16, 8], "dropout": 0.0, **(dnn or {})},
        "pallas": {"table_layout": "packed"},
        "training": tr,
        **MODELS[model],
    }


def _pair(data_dir, tmp_path, monkeypatch, model="deepfm", training=None,
          dnn=None):
    """A JAX trainer and a port trainer on the same data and weights."""
    monkeypatch.setenv("DEEPFM_TPU_FORCE_FUSED_ADAM", "1")
    jcfg, _ = config_pair(_raw(data_dir, tmp_path / "jax", model, training,
                               dnn))
    _, tcfg = config_pair(_raw(data_dir, tmp_path / "port", model, training,
                               dnn))
    jadapter = JaxAdapter(jcfg.data, seed=jcfg.seed)
    jschema, *jsplits = jadapter.build()
    jpacked = jax_pack_schema(jschema)
    jtrainer = JaxTrainer(jax_create_model(model, jpacked, jcfg), jpacked,
                          jcfg, *(s.pack(jpacked) for s in jsplits),
                          adapter=jadapter)
    assert jtrainer.sparse_fused
    tadapter = MovieLensAdapter(tcfg.data, seed=tcfg.seed)
    tschema, *tsplits = tadapter.build()
    tpacked = pack_schema(tschema)
    tmodel = create_model(model, tpacked, tcfg, device="cpu")
    tmodel.load_state_dict(params_from_jax(
        jtrainer.state.params, jtrainer.state.batch_stats, tpacked, tcfg))
    ttrainer = Trainer(tmodel, tpacked, tcfg,
                       *(s.pack(tpacked) for s in tsplits), adapter=tadapter)
    assert ttrainer.path == "sparse_fused"
    return jtrainer, ttrainer


def _no_timing(history):
    return [{k: v for k, v in h.items() if k not in TIMING} for h in history]


def test_chunk_plan_yields_the_jax_batches(data_dir, tmp_path, monkeypatch):
    """The same shuffles, drop and padding, and chunks of the staging
    budget (forced to 3 batches), epoch after epoch."""
    jtrainer, ttrainer = _pair(data_dir, tmp_path, monkeypatch)
    for tr in (jtrainer, ttrainer):
        monkeypatch.setattr(tr, "_budget_batches", lambda data, bs: 3)
    data = ttrainer.train_data
    jdata = jtrainer.train_data
    for shuffle, drop, bs in ((True, True, 64), (True, False, 64),
                              (False, False, 50), (True, False, 2000)):
        got = list(ttrainer._chunk_plan(data, bs, shuffle=shuffle,
                                        drop_remainder=drop))
        want = list(jtrainer._chunk_plan(jdata, bs, shuffle=shuffle,
                                         drop_remainder=drop))
        assert [c for c, _ in got] == [c for c, _ in want]
        for (_, g), (_, w) in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert got[-1][1][3].min() == 0.0  # 2000 > rows: padded, weight 0


@pytest.mark.parametrize("model,batch_norm", [
    ("deepfm", False), ("xdeepfm", False), ("deepfm", True)])
def test_two_epochs_match_jax(data_dir, tmp_path, monkeypatch, model,
                              batch_norm):
    jtrainer, ttrainer = _pair(data_dir, tmp_path, monkeypatch, model,
                               dnn={"use_batch_norm": batch_norm})
    jbest = jtrainer.train()
    tbest = ttrainer.train()
    rel = BN_METRIC_REL if batch_norm else METRIC_REL
    assert len(ttrainer.history) == len(jtrainer.history) == 2
    for got, want in zip(ttrainer.history, jtrainer.history):
        assert set(got) == set(want)
        assert got["epoch"] == want["epoch"]
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-7)
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=LOSS_REL)
        for key in want:
            if key.startswith("val_"):
                assert got[key] == pytest.approx(want[key], rel=rel), key
    for key in jbest:
        assert tbest[key] == pytest.approx(jbest[key], rel=rel), key
    jres = json.loads((tmp_path / "jax" / "results.json").read_text())
    tres = json.loads((tmp_path / "port" / "results.json").read_text())
    for key, v in jres["test_metrics"].items():
        assert tres["test_metrics"][key] == pytest.approx(v, rel=rel), key
    steps = int(jtrainer.state.step)
    assert int(ttrainer.state.step) == steps
    if not batch_norm:
        want = params_from_jax(jtrainer.state.params,
                               jtrainer.state.batch_stats,
                               ttrainer.packed_schema, ttrainer.config)
        failed = compare_leaves(dict(ttrainer.model.state_dict()), want, LR,
                                steps)["failed_leaves"]
        assert not failed, failed


@pytest.mark.parametrize("scheduler,training", [
    # val logloss as the metric: it falls epoch after epoch, which the loop
    # reads as no improvement (higher is better), so the plateau halves the
    # learning rate after epoch 4 and early stopping ends the run at 5
    ("reduce_on_plateau", {"metric": "logloss", "num_epochs": 6,
                           "early_stopping_patience": 4}),
    ("warmup_cosine", {"num_epochs": 4, "warmup_epochs": 2}),
])
def test_loop_behaviour_matches_jax(data_dir, tmp_path, monkeypatch,
                                    scheduler, training):
    jtrainer, ttrainer = _pair(data_dir, tmp_path, monkeypatch,
                               training={"scheduler": scheduler, **training})
    jtrainer.train()
    ttrainer.train()
    got, want = ttrainer.history, jtrainer.history
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    assert [h["lr"] for h in got] == pytest.approx(
        [h["lr"] for h in want], rel=1e-7)
    jres = json.loads((tmp_path / "jax" / "results.json").read_text())
    tres = json.loads((tmp_path / "port" / "results.json").read_text())
    for key in ("best_epoch", "total_epochs"):
        assert tres["training_info"][key] == jres["training_info"][key]
    lrs = [h["lr"] for h in got]
    if scheduler == "reduce_on_plateau":
        assert len(got) == 5  # stopped before num_epochs
        assert lrs[-1] == pytest.approx(lrs[0] / 2)  # the plateau stepped
    else:
        assert lrs[0] < lrs[1] and lrs[3] < lrs[2]  # warmup, then decay


def _port_trainer(data_dir, out, epochs, dropout=0.1):
    _, cfg = config_pair(_raw(data_dir, out, "xdeepfm",
                              {"num_epochs": epochs, "resume": True},
                              {"dropout": dropout}))
    adapter = MovieLensAdapter(cfg.data, seed=cfg.seed)
    schema, *splits = adapter.build()
    packed = pack_schema(schema)
    return Trainer(create_model("xdeepfm", packed, cfg, device="cpu"), packed,
                   cfg, *(s.pack(packed) for s in splits), adapter=adapter)


def _state(trainer):
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    st = trainer.state
    for name, s in st.table_opt.items():
        out[f"{name}.mu"], out[f"{name}.nu"] = s.mu.clone(), s.nu.clone()
    for name in st.opt_state.mu:
        out[f"opt.{name}.mu"] = st.opt_state.mu[name].clone()
        out[f"opt.{name}.nu"] = st.opt_state.nu[name].clone()
    out["step"] = st.step.clone()
    return out


def test_resume_equals_an_unbroken_run(data_dir, tmp_path):
    whole = _port_trainer(data_dir, tmp_path / "whole", 2)
    whole.train()
    _port_trainer(data_dir, tmp_path / "split", 1).train()
    resumed = _port_trainer(data_dir, tmp_path / "split", 2)
    resumed.train()
    assert resumed.epoch == 2
    assert _no_timing(resumed.history) == _no_timing(whole.history)
    a, b = _state(resumed), _state(whole)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    res = [json.loads((tmp_path / d / "results.json").read_text())
           for d in ("whole", "split")]
    assert res[0]["test_metrics"] == res[1]["test_metrics"]


def test_resume_refuses_another_layout(data_dir, tmp_path):
    _port_trainer(data_dir, tmp_path, 1).train()
    meta = json.loads((tmp_path / "last_state_meta.json").read_text())
    meta["table_layout"] = "logical"
    (tmp_path / "last_state_meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="Cannot resume"):
        _port_trainer(data_dir, tmp_path, 2).train()


def test_results_and_resume_meta_have_the_jax_keys(data_dir, tmp_path,
                                                   monkeypatch):
    jtrainer, ttrainer = _pair(data_dir, tmp_path, monkeypatch,
                               training={"num_epochs": 1, "resume": True})
    jtrainer.train()
    ttrainer.train()
    jres = json.loads((tmp_path / "jax" / "results.json").read_text())
    tres = json.loads((tmp_path / "port" / "results.json").read_text())
    assert set(tres) == set(jres)
    assert set(tres["training_info"]) == set(jres["training_info"])
    assert tres["training_info"]["backward"] == "sparse_fused"
    assert tres["training_info"]["kernels"] == []  # the CPU runs no kernel
    assert tres["training_info"]["mesh"] is None
    assert set(tres["history"][0]) == set(jres["history"][0])
    assert set(tres["config"]) == set(jres["config"])
    jmeta = json.loads((tmp_path / "jax" / "last_state_meta.json").read_text())
    tmeta = json.loads((tmp_path / "port" / "last_state_meta.json")
                       .read_text())
    assert set(tmeta) == set(jmeta)
    assert set(tmeta["scheduler"]) == set(jmeta["scheduler"])
    for key in ("epoch", "table_layout", "fused_table_adam", "scheduler_type",
                "patience_counter", "best_epoch"):
        assert tmeta[key] == jmeta[key], key
