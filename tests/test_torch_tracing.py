"""The port's spans and counters (``deepfm_tpu_torch/utils/tracing.py``).

Off, a span is one shared no-op that opens no profiler range and reads no
clock; on, each train path counts its three step phases once a step, the
epoch loop and the ``Predictor`` count their staging, waits and fetches,
under ``torch.profiler`` every ``deepfm.*`` range lies inside the span
that encloses it and is named and counted as the recorded spans, and
``train`` with ``profile.trace_dir`` keeps each epoch's spans in
``Trainer.timings["spans"]``. Tiny models on the CPU; no JAX.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.data.packing import pack_features, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.training.trainer import Trainer
from deepfm_tpu_torch.utils import tracing

B = 16
BATCHES = 4
# name, kind, vocabulary (with the reserved 0)
FIELDS = [("user", "sparse", 40), ("item", "sparse", 30), ("cat", "sparse", 5),
          ("price", "dense", 0), ("hour", "dense", 0)]
# path -> the port's training overrides (tests/test_torch_train.py's)
PATHS = {
    "plain": {"fused_table_adam": False},
    "two_pass": {"fused_backward": False},
    "sparse_fused": {},
    "lazy": {"optimizer": "lazy_adam"},
}
PHASES = ("step.forward", "step.backward", "step.update")


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with tracing off."""
    tracing.disable()
    yield
    tracing.disable()


def _arrays(packed, n, seed):
    rng = np.random.default_rng(seed)
    feats = {name: (rng.integers(0, vocab, n) if kind == "sparse"
                    else rng.normal(size=n).astype(np.float32))
             for name, kind, vocab in FIELDS}
    labels = rng.integers(0, 2, n).astype(np.float32)
    return pack_features(packed, feats, labels)


def _trainer(training=None, tmp_path=None, **extra):
    """A DeepFM trainer on ``BATCHES`` batches, one batch a staged chunk
    (a staging budget of 0 MB), with val and test splits."""
    schema = DatasetSchema(fields={
        name: FieldSchema(name, FeatureType(kind), vocab, 4, "g")
        for name, kind, vocab in FIELDS})
    packed = pack_schema(schema)
    raw = {"model_name": "deepfm", "device": "cpu",
           "dnn": {"hidden_units": [8], "dropout": 0.0},
           "training": {"batch_size": B, "scheduler": "none",
                        "stage_budget_mb": 0, "num_epochs": 1,
                        **(training or {})}, **extra}
    if tmp_path is not None:
        raw["output_dir"] = str(tmp_path)
    config = config_from_dict(raw)
    data = [_arrays(packed, B * BATCHES, seed) for seed in (1, 2, 3)]
    return Trainer(create_model("deepfm", packed, config, device="cpu"),
                   packed, config, *data)


def _raise(*args, **kwargs):
    raise AssertionError("a profiler range was opened with tracing off")


def test_off_opens_no_range_reads_no_clock_and_records_nothing(monkeypatch):
    assert tracing.span("a") is tracing.span("b")
    trainer = _trainer()
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(tracing, "_Range", _raise)
    reads = []

    class Clock:
        @staticmethod
        def perf_counter():
            reads.append(1)
            return time.perf_counter()

    monkeypatch.setattr(tracing, "time", Clock)
    before = tracing.snapshot()
    stage0 = trainer._stage_seconds
    loss, n = trainer._train_epoch()
    assert np.isfinite(loss) and n == B * BATCHES
    # the trainer's own staging timer runs on
    assert trainer._stage_seconds > stage0
    scores = trainer.predictor.predict(trainer.val_data)
    assert scores.shape == (B * BATCHES,)
    assert reads == []
    assert tracing.since(before) == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("path", list(PATHS))
def test_on_counts_each_step_phase_once_a_step(path):
    trainer = _trainer(PATHS[path])
    assert trainer.path == path
    data = trainer.train_data
    before = tracing.snapshot()
    tracing.enable()
    stage0 = trainer._stage_seconds
    trainer._train_epoch()
    snap = tracing.since(before)
    spans = snap["spans"]
    for phase in PHASES:
        assert spans[phase]["count"] == BATCHES, phase
        assert spans[phase]["seconds"] > 0
    # one chunk a batch: a plan a chunk and the one that ends the epoch,
    # a loss read before each chunk staged after the second, and the sum
    assert spans["train.plan"]["count"] == BATCHES + 1
    assert spans["train.stage"]["count"] == BATCHES
    assert spans["train.wait"]["count"] == BATCHES - 2 + 1
    # the span lies inside the trainer's staging timer, which adds only
    # its own clock reads around it
    stage_s = trainer._stage_seconds - stage0
    assert 0 < spans["train.stage"]["seconds"] <= stage_s
    assert stage_s - spans["train.stage"]["seconds"] < 0.05
    row_bytes = (data.ids.itemsize * data.ids.shape[1]
                 + data.dense.itemsize * data.dense.shape[1]
                 + data.labels.itemsize + np.dtype(np.float32).itemsize)
    assert snap["counters"] == {"train.stage_bytes": B * BATCHES * row_bytes}
    assert not [k for k in spans if k.startswith("score.")]


def test_predictor_counts_its_chunks_batches_and_bytes():
    trainer = _trainer()
    predictor, data = trainer.predictor, trainer.val_data
    # 2 chunks of 2 batches, the last batch short
    n = 3 * B + B // 2
    data = type(data)(data.ids[:n], data.dense[:n], data.labels[:n],
                      data.weights[:n])
    predictor.budget_batches = lambda data, batch_size: 2
    before = tracing.snapshot()
    tracing.enable()
    scores = predictor.predict(data)
    assert scores.shape == (n,)
    snap = tracing.since(before)
    spans = snap["spans"]
    assert spans["score.stage"]["count"] == 2 * 2
    assert spans["score.fetch"]["count"] == 2
    assert spans["score.forward"]["count"] == 4
    assert snap["counters"] == {
        "score.stage_bytes": data.ids.nbytes + data.dense.nbytes}
    tracing.disable()
    np.testing.assert_array_equal(predictor.predict(data), scores)


def test_profiler_ranges_nest_in_their_parents_and_match_the_snapshot():
    from torch.profiler import ProfilerActivity, profile

    trainer = _trainer(PATHS["sparse_fused"])
    before = tracing.snapshot()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test.epoch"):
            trainer._train_epoch()
        with tracing.span("test.predict"):
            trainer.predictor.predict(trainer.val_data)
    spans = tracing.since(before)["spans"]
    ranges: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            ranges.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert set(ranges) == set(spans)
    for name, got in ranges.items():
        assert len(got) == spans[name]["count"], name
    for name, got in ranges.items():
        if name.startswith("test."):
            continue
        parent = "test.epoch" if name.startswith(("train.", "step.")) \
            else "test.predict"
        for s, t in got:
            assert any(ps <= s and t <= pt for ps, pt in ranges[parent]), \
                (name, parent)


def test_train_with_a_trace_dir_traces_the_spans_and_turns_them_off(
        tmp_path):
    trainer = _trainer(tmp_path=tmp_path / "out",
                       profile={"trace_dir": str(tmp_path / "trace")})
    trainer.train()
    assert not tracing.enabled()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    ranges: dict[str, int] = {}
    for e in events["traceEvents"]:
        name = str(e.get("name", ""))
        if name.startswith(tracing.PREFIX):
            name = name[len(tracing.PREFIX):]
            ranges[name] = ranges.get(name, 0) + 1
    # one record an epoch, the epoch's and its val evaluation's spans,
    # which are every range of the trace
    (epoch,) = trainer.timings["spans"]
    assert {k: v["count"] for k, v in epoch["spans"].items()} == ranges
    assert {*PHASES, "train.stage", "score.forward"} <= set(ranges)
    assert ranges["step.forward"] == BATCHES
    assert set(epoch["counters"]) == {"train.stage_bytes",
                                      "score.stage_bytes"}
    line = tracing.describe(epoch)
    assert "train.stage " in line and "GB/s" in line


# ---- the attention stacks' spans (AttentionDeepFM's blocks, AutoInt's
# interacting layers)

ATTENTION_MODELS = {"attention_deepfm": 2, "autoint": 3}  # name -> layers


def _attention_trainer(model: str):
    """``model`` on ``_trainer``'s fields and batches, sparse-fused."""
    schema = DatasetSchema(fields={
        name: FieldSchema(name, FeatureType(kind), vocab, 4, "g")
        for name, kind, vocab in FIELDS})
    packed = pack_schema(schema)
    config = config_from_dict({
        "model_name": model, "device": "cpu",
        "dnn": {"hidden_units": [8], "dropout": 0.0},
        "attention": {"num_heads": 2, "attention_dim": 8,
                      "num_layers": ATTENTION_MODELS[model]},
        "training": {"batch_size": B, "scheduler": "none",
                     "stage_budget_mb": 0, "num_epochs": 1}})
    data = [_arrays(packed, B * BATCHES, seed) for seed in (1, 2, 3)]
    return Trainer(create_model(model, packed, config, device="cpu"),
                   packed, config, *data)


@pytest.mark.parametrize("model", list(ATTENTION_MODELS))
def test_attention_spans_count_a_stack_call_and_a_layer(model):
    """A train step: one ``model.attention`` (the stack's forward), one
    ``model.attention_backward`` a layer, B·F rows a layer; scoring: one
    ``model.attention`` a batch and no backward. Each range lies inside
    the step phase or the scoring span that runs it."""
    from torch.profiler import ProfilerActivity, profile

    layers = ATTENTION_MODELS[model]
    trainer = _attention_trainer(model)
    fields = len(FIELDS)
    before = tracing.snapshot()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer._train_epoch()
    snap = tracing.since(before)
    spans = snap["spans"]
    assert spans["model.attention"]["count"] == BATCHES
    assert spans["model.attention_backward"]["count"] == BATCHES * layers
    assert snap["counters"]["attention.rows"] == BATCHES * B * fields * layers
    # the plain versions launch no kernel, so no row took the tiled core
    assert "attention.tiled_core_rows" not in snap["counters"]
    ranges: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            ranges.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, parent in (("model.attention", "step.forward"),
                         ("model.attention_backward", "step.backward")):
        assert len(ranges[name]) == spans[name]["count"]
        for s, t in ranges[name]:
            assert any(ps <= s and t <= pt for ps, pt in ranges[parent]), \
                (name, parent)
    before = tracing.snapshot()
    scores = trainer.predictor.predict(trainer.val_data)
    snap = tracing.since(before)
    forwards = snap["spans"]["score.forward"]["count"]
    assert snap["spans"]["model.attention"]["count"] == forwards
    assert "model.attention_backward" not in snap["spans"]
    assert snap["counters"]["attention.rows"] == len(scores) * fields * layers
    tracing.disable()
    np.testing.assert_array_equal(trainer.predictor.predict(
        trainer.val_data), scores)


@pytest.mark.parametrize("model", list(ATTENTION_MODELS))
def test_attention_spans_off_cost_nothing(model, monkeypatch):
    """Tracing off, a train epoch and a scoring pass of an attention model
    open no range, read no clock and record nothing."""
    trainer = _attention_trainer(model)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(tracing, "_Range", _raise)
    reads = []

    class Clock:
        @staticmethod
        def perf_counter():
            reads.append(1)
            return time.perf_counter()

    monkeypatch.setattr(tracing, "time", Clock)
    before = tracing.snapshot()
    loss, n = trainer._train_epoch()
    assert np.isfinite(loss) and n == B * BATCHES
    assert trainer.predictor.predict(trainer.val_data).shape == (B * BATCHES,)
    assert reads == []
    assert tracing.since(before) == {"spans": {}, "counters": {}}
