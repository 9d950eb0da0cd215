"""The port's on-disk packed store (``data/store.py``), its ``synth-packed``
and ``pack-data`` commands and training from it, against the JAX
package's, on the CPU.

Held:
  * a store written by the JAX package (``write_synthetic_packed``, and
    ``save_packed`` with user ids) loads in the port with equal arrays and
    an equal schema, its splits memory-mapped;
  * ``synth-packed`` writes the JAX command's files byte for byte, and
    ``pack-data`` of a MovieLens-format dataset (the native sampler on,
    the default) the JAX command's arrays and schema, with its warning
    about freezing one draw of negatives;
  * ``train`` on ``configs/deepfm_criteo_packed.yaml`` cut to small widths
    runs from the memory-mapped store (the trainer's splits are
    ``np.memmap``s, results.json has the JAX keys), and ``Predictor``
    scores a memory-mapped split in staged chunks as it scores the same
    rows in memory;
  * a store without ``schema.json`` raises, and ``save_packed`` removes a
    stale ``user_ids.npy``.
"""

import contextlib
import json
import logging

import numpy as np
import pytest
import torch

from deepfm_tpu.cli import main as jax_main
from deepfm_tpu.config import DataConfig as JaxDataConfig
from deepfm_tpu.data import store as jstore
from deepfm_tpu.data.packing import PackedArrays as JaxPackedArrays
from deepfm_tpu_torch.cli import main as port_main
from deepfm_tpu_torch.cli import train_command
from deepfm_tpu_torch.config import DataConfig, load_config
from deepfm_tpu_torch.data import store
from deepfm_tpu_torch.data.packing import PackedArrays
from deepfm_tpu_torch.data.synthetic import build_adapter
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.training.predict import Predictor

torch.set_num_threads(1)

SPLITS = ("train", "val", "test")
ARRAYS = ("ids", "dense", "labels", "weights", "user_ids")
SYNTH = ["--rows", "3000", "--fields", "5", "--vocab", "300", "--seed", "4",
         "--chunk-rows", "1100"]
PACKED_CONFIG = "configs/deepfm_criteo_packed.yaml"


@contextlib.contextmanager
def _warnings_of(name):
    """The WARNING messages logged to ``name`` meanwhile (a handler on the
    logger itself: the package logger does not propagate to pytest's)."""
    messages = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)


def _assert_same_arrays(got, want):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _assert_same_schema(got, want):
    assert got.label_field == want.label_field
    assert list(got.fields) == list(want.fields)
    for name, f in want.fields.items():
        g = got.fields[name]
        assert (g.feature_type.value, g.vocabulary_size, g.embedding_dim,
                g.group, g.max_length, g.combiner) == (
            f.feature_type.value, f.vocabulary_size, f.embedding_dim,
            f.group, f.max_length, f.combiner), name


def test_a_jax_store_loads_in_the_port(tmp_path):
    cfg = JaxDataConfig(dataset_name="criteo_synthetic",
                        synthetic_num_rows=500, synthetic_num_fields=4,
                        synthetic_vocab_size=50)
    jstore.write_synthetic_packed(tmp_path, cfg, seed=2, chunk_rows=170)
    rng = np.random.default_rng(0)
    with_users = JaxPackedArrays(
        ids=rng.integers(0, 50, (20, 4)).astype(np.int32),
        dense=rng.normal(size=(20, 1)).astype(np.float32),
        labels=rng.integers(0, 2, 20).astype(np.float32),
        weights=np.ones(20, np.float32),
        user_ids=rng.integers(0, 9, 20).astype(np.int64))
    jstore.save_packed(with_users, tmp_path / "users")
    _assert_same_schema(store.load_schema(tmp_path / "schema.json"),
                        jstore.load_schema(tmp_path / "schema.json"))
    for split in (*SPLITS, "users"):
        got = store.load_packed(tmp_path / split)
        assert isinstance(got, PackedArrays)
        assert isinstance(got.ids, np.memmap)
        _assert_same_arrays(got, jstore.load_packed(tmp_path / split))
    adapter = build_adapter(DataConfig(dataset_name="packed",
                                       data_dir=str(tmp_path)))
    assert isinstance(adapter, store.PackedDirAdapter)
    schema, packed, train, val, test = adapter.build_packed()
    assert packed.num_slots == 4 and len(train) == 500
    assert len(val) == len(test) == 50


def test_synth_packed_writes_the_jax_files(tmp_path):
    port_main(["synth-packed", "--dir", str(tmp_path / "port"), *SYNTH])
    jax_main(["synth-packed", "--dir", str(tmp_path / "jax"), *SYNTH])
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert [str(f) for f in files if f.parent.name == "train"] == [
        "train/dense.npy", "train/ids.npy", "train/labels.npy",
        "train/weights.npy"]
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f
    train = store.load_packed(tmp_path / "port" / "train")
    assert len(train) == 3000 and train.ids.shape[1] == 5


def _ml_overrides(root, out):
    return [f"data.data_dir={root / 'ml'}", "data.num_neg_train=1",
            "data.num_neg_eval=5", f"output_dir={out}", "device=cpu"]


def test_pack_data_writes_the_jax_arrays(tmp_path):
    port_main(["synth-data", "--dir", str(tmp_path / "ml"), "--users", "30",
               "--items", "40", "--rows", "900", "--seed", "5"])
    config = "configs/deepfm_movielens.yaml"
    with _warnings_of("deepfm_tpu_torch") as warned:
        port_main(["pack-data", "--config", config, "--override",
                   *_ml_overrides(tmp_path, tmp_path / "o1"),
                   "--out", str(tmp_path / "port")])
    assert any("pack-data freezes ONE draw of train negatives" in m
               for m in warned)
    jax_main(["pack-data", "--config", config, "--override",
              *_ml_overrides(tmp_path, tmp_path / "o2"),
              "--out", str(tmp_path / "jax")])
    _assert_same_schema(store.load_schema(tmp_path / "port" / "schema.json"),
                        jstore.load_schema(tmp_path / "jax" / "schema.json"))
    for split in SPLITS:
        got = store.load_packed(tmp_path / "port" / split)
        assert got.user_ids is not None
        _assert_same_arrays(got, jstore.load_packed(tmp_path / "jax" / split))


def _packed_config(data_dir, out):
    return load_config(PACKED_CONFIG, [
        f"data.data_dir={data_dir}", f"output_dir={out}", "device=cpu",
        "training.num_epochs=1", "training.batch_size=256",
        "training.stage_budget_mb=0", "dnn.hidden_units=[16,8]",
        "feature.fm_embed_dim=8", "training.compute_dtype=float32"])


def test_train_runs_from_a_memory_mapped_store(tmp_path):
    port_main(["synth-packed", "--dir", str(tmp_path / "store"), *SYNTH])
    config = _packed_config(tmp_path / "store", tmp_path / "run")
    trainer = train_command(config)
    for split in ("train_data", "val_data", "test_data"):
        assert isinstance(getattr(trainer, split).ids, np.memmap), split
    # a budget of 0 MiB stages one batch a chunk
    assert trainer._budget_batches(trainer.train_data, 256) == 1
    res = json.loads((tmp_path / "run" / "results.json").read_text())
    assert set(res) == {"run_id", "timestamp", "config", "val_metrics",
                        "test_metrics", "training_info", "history"}
    assert res["training_info"]["backward"] == "sparse_fused"
    assert len(res["history"]) == 1
    assert np.isfinite(res["history"][0]["train_loss"])
    assert 0.0 <= res["test_metrics"]["auc"] <= 1.0


def test_predictor_stages_a_memory_mapped_split(tmp_path):
    port_main(["synth-packed", "--dir", str(tmp_path / "store"), *SYNTH])
    config = _packed_config(tmp_path / "store", tmp_path / "run")
    _, packed, train, _, _ = build_adapter(
        config.data, seed=config.seed).build_packed()
    model = create_model("deepfm", packed, config, device="cpu")
    predictor = Predictor(model, packed, config, device="cpu")
    assert predictor.budget_batches(train, 256) == 1
    in_memory = PackedArrays(*(np.array(getattr(train, k))
                               for k in ARRAYS[:4]))
    np.testing.assert_array_equal(predictor.predict(train),
                                  predictor.predict(in_memory))


def test_a_store_without_its_schema_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="schema.json not found"):
        build_adapter(DataConfig(dataset_name="packed",
                                 data_dir=str(tmp_path)))


def test_save_packed_removes_stale_user_ids(tmp_path):
    rng = np.random.default_rng(1)
    arrays = PackedArrays(
        ids=rng.integers(0, 9, (6, 2)).astype(np.int32),
        dense=np.zeros((6, 0), np.float32), labels=np.ones(6, np.float32),
        weights=np.ones(6, np.float32), user_ids=np.arange(6))
    store.save_packed(arrays, tmp_path)
    assert store.load_packed(tmp_path).user_ids is not None
    store.save_packed(PackedArrays(arrays.ids, arrays.dense, arrays.labels,
                                   arrays.weights), tmp_path)
    assert store.load_packed(tmp_path).user_ids is None
