"""The model kinds' files (``models/<kind>.py``) give the harness exactly
what it computed when it knew only xDeepFM and DeepFM: the weight specs,
the counted operations and, bit for bit, the reference's logits and
first three train steps, as ``data/pinned.json`` recorded them then."""

from __future__ import annotations

import json

import pytest
import torch
from portbench_helpers import DATA, tiny_benchmark

from portbench import counts, weights
from portbench.reference import ctr

PINNED = json.loads((DATA / "pinned.json").read_text())
CONFIGS = list(PINNED["specs"])
STEP_OPS = [(c, b, mode) for c in PINNED["step_ops"]
            for b in PINNED["step_ops"][c] for mode in ("train", "score")]
TINY = list(PINNED["logits"])


def kind_and_config(name: str):
    reg = tiny_benchmark()
    config = reg.config(name)
    return reg.model(config["model"]), config


@pytest.fixture
def one_thread():
    """The CPU's products in one thread, as the pins were recorded."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def rows(config: dict, n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ids = torch.stack([torch.randint(0, c + 1, (n,), generator=g)
                       for c in config["field_cardinalities"]], 1)
    dense = torch.randn(n, config["dense_fields"], generator=g)
    labels = torch.randint(0, 2, (n,), generator=g).float()
    return ids, dense, labels


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_specs_are_pinned(name):
    kind, config = kind_and_config(name)
    got = [[n, list(shape), lo, hi]
           for n, shape, lo, hi in weights.specs(kind, config)]
    assert got == PINNED["specs"][name]
    assert counts.dense_params(kind, config) == PINNED["dense_params"][name]


@pytest.mark.parametrize("name,batch,mode", STEP_OPS)
def test_step_ops_are_pinned(name, batch, mode):
    kind, config = kind_and_config(name)
    ops = counts.step_ops(kind, config, int(batch), train=mode == "train")
    got = [[n, op.flops, op.bytes] for n, op in ops.items()]
    assert got == PINNED["step_ops"][name][batch][mode]


@pytest.mark.parametrize("name", TINY)
def test_reference_logits_are_pinned(name, one_thread):
    kind, config = kind_and_config(name)
    w = weights.make_weights(kind, config, PINNED["seed"], "cpu")
    ids, dense, _ = rows(config, 64, 1)
    with ctr.full_f32(), torch.no_grad():
        for training in (True, False):
            for qn, q in (("identity", ctr.identity), ("fp8", ctr.fp8)):
                got = ctr.logits(kind, config, w, ids, dense, training, q)
                key = f"{'train' if training else 'eval'}.{qn}"
                want = torch.tensor(PINNED["logits"][name][key])
                assert torch.equal(got, want), key


@pytest.mark.parametrize("name", TINY)
def test_reference_train_steps_are_pinned(name, one_thread):
    kind, config = kind_and_config(name)
    w = weights.make_weights(kind, config, PINNED["seed"], "cpu")
    got = ctr.train_steps(kind, config, w,
                          [rows(config, 64, s) for s in (2, 3, 4)])
    for key, want in PINNED["train_steps"][name].items():
        assert got[key] == want, key
