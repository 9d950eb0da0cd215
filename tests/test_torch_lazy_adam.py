"""The port's lazy_adam (``training.optimizer: lazy_adam``) against the JAX
package's: the row-sparse update's functions on the same numpy inputs, and
the trainer's lazy step over two steps, on logical and packed tables.

Tolerances:
  * ``lazy_adam_table_update``: XLA on the CPU contracts ``b1*mu +
    (1-b1)*g`` and ``b2*nu + (1-b2)*g^2`` into FMAs, and the port rounds
    each op, so the moments differ by at most an ulp at the moments' scale
    (LAZY_ULPS f32 ulps of the larger magnitude) and the rows by what an
    ulp of the moments moves through Adam's normalisation (rtol 1e-5 /
    atol 1e-7 of the JAX rows); untouched rows, and rows that carry zero
    gradient and zero weight, are held bit for bit.
  * the two-step trainer parity: ``deepfm_tpu_torch/training/parity.py``,
    the rule every train path of the port is held to (the losses rel 1e-6).
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_train import (  # noqa: E402
    B,
    _assert_state_matches,
    _data,
    _jax_run,
    _port_step,
    _port_trainer,
)
from torch_port_helpers import SYNTH_SPEC, schema_pair  # noqa: E402

from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models.base import embedding_l2_loss as jax_l2  # noqa: E402
from deepfm_tpu.training import sparse_opt as jopt  # noqa: E402
from deepfm_tpu_torch.convert import train_state_from_jax  # noqa: E402
from deepfm_tpu_torch.data.packing import pack_schema  # noqa: E402
from deepfm_tpu_torch.models.base import embedding_l2_loss  # noqa: E402
from deepfm_tpu_torch.training import sparse_opt as topt  # noqa: E402
from deepfm_tpu_torch.training.telemetry import trainer_engagement  # noqa: E402

torch.set_num_threads(1)

LAZY_ULPS = 2
ROW_TOL = dict(rtol=1e-5, atol=1e-7)
LAZY = {"optimizer": "lazy_adam"}


def _update_pair(table, grad, ids, *, l2=0.0, scale=None, step=0,
                 mu=None, nu=None, lr=1e-2):
    """The same update through both packages; returns ((table, mu, nu) of
    JAX, (table, mu, nu) of the port) as numpy."""
    mu = np.zeros_like(table) if mu is None else mu
    nu = np.zeros_like(table) if nu is None else nu
    jt, js = jopt.lazy_adam_table_update(
        jnp.asarray(table), jnp.asarray(grad),
        jopt.TableSlotState(jnp.asarray(mu), jnp.asarray(nu)),
        jnp.asarray(ids, jnp.int32), lr=jnp.asarray(lr, jnp.float32),
        step=jnp.asarray(step), l2=l2,
        grad_scale=None if scale is None else jnp.asarray(scale, jnp.float32))
    tt, ts = topt.lazy_adam_table_update(
        torch.from_numpy(table.copy()), torch.from_numpy(grad),
        topt.TableSlotState(torch.from_numpy(mu.copy()),
                            torch.from_numpy(nu.copy())),
        torch.from_numpy(np.asarray(ids, np.int64)),
        lr=torch.tensor(lr, dtype=torch.float32),
        step=torch.tensor(step, dtype=torch.int32), l2=l2,
        grad_scale=None if scale is None else torch.tensor(
            scale, dtype=torch.float32))
    return ((np.asarray(jt), np.asarray(js.mu), np.asarray(js.nu)),
            (tt.numpy(), ts.mu.numpy(), ts.nu.numpy()))


def _assert_update_close(want, got):
    for w, g in zip(want[1:], got[1:]):  # the moments: ulps
        ulp = np.spacing(np.maximum(np.abs(w), np.abs(g)).astype(np.float32))
        assert (np.abs(w - g) <= LAZY_ULPS * ulp).all()
    np.testing.assert_allclose(got[0], want[0], **ROW_TOL)


@pytest.mark.parametrize("ids", [[5, 3, 5, 7, 3, 3], [0, 0, 0], [9, 1, 4],
                                 list(range(12))[::-1] + [2, 2]])
def test_dedupe_ids_matches_jax(ids):
    want = np.asarray(jopt.dedupe_ids(jnp.asarray(ids, jnp.int32), 10))
    got = topt.dedupe_ids(torch.tensor(ids), 10).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l2,scale,step", [(0.0, None, 0), (1e-3, 0.5, 0),
                                           (1e-2, 0.25, 6)])
def test_touched_rows_match_jax_and_dense_adam(l2, scale, step):
    """Distinct ids: the touched rows against JAX (and, at step 0 without
    L2 or scale, against optax.adam on the dense gradient); every other
    row unchanged."""
    import optax

    rng = np.random.default_rng(0)
    v, d, n = 32, 5, 12
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.choice(v, n, replace=False)
    grad = np.zeros((v, d), np.float32)
    grad[ids] = rng.normal(size=(n, d)).astype(np.float32)
    mu = rng.normal(size=(v, d)).astype(np.float32) * 0.1 if step else None
    nu = np.abs(rng.normal(size=(v, d))).astype(np.float32) * 0.01 \
        if step else None
    want, got = _update_pair(table, grad, ids, l2=l2, scale=scale,
                             step=step, mu=mu, nu=nu)
    _assert_update_close(want, got)
    untouched = np.setdiff1d(np.arange(v), ids)
    np.testing.assert_array_equal(got[0][untouched], table[untouched])
    if step == 0 and l2 == 0.0 and scale is None:
        tx = optax.adam(1e-2)
        upd, _ = tx.update(jnp.asarray(grad), tx.init(jnp.asarray(table)))
        dense = np.asarray(optax.apply_updates(jnp.asarray(table), upd))
        np.testing.assert_allclose(got[0][ids], dense[ids], rtol=1e-5)


def test_duplicate_ids_take_one_update_as_in_jax():
    rng = np.random.default_rng(1)
    v, d = 16, 4
    table = rng.normal(size=(v, d)).astype(np.float32)
    g_row = rng.normal(size=d).astype(np.float32)
    grad = np.zeros((v, d), np.float32)
    grad[3] = 4.0 * g_row  # the lookup's backward has summed the four
    want, got = _update_pair(table, grad, [3, 3, 3, 3])
    _assert_update_close(want, got)
    np.testing.assert_allclose(got[1][3], 0.1 * 4.0 * g_row, rtol=1e-5)
    changed = np.any(got[0] != table, axis=1)
    assert changed.tolist() == [False] * 3 + [True] + [False] * 12


def test_zero_gradient_zero_weight_row_stays_zero():
    v, d = 8, 4
    table = np.ones((v, d), np.float32)
    table[0] = 0.0
    want, got = _update_pair(table, np.zeros((v, d), np.float32), [0, 0],
                             l2=1e-3)
    np.testing.assert_array_equal(got[0][0], np.zeros(d, np.float32))
    np.testing.assert_array_equal(got[0], want[0])


def test_lazy_l2_decays_touched_rows_only():
    v, d = 8, 4
    table = np.ones((v, d), np.float32)
    want, got = _update_pair(table, np.zeros((v, d), np.float32), [2],
                             l2=0.5)
    _assert_update_close(want, got)
    assert got[0][2].max() < 1.0
    np.testing.assert_array_equal(np.delete(got[0], 2, axis=0),
                                  np.delete(table, 2, axis=0))


@pytest.mark.parametrize("layout", ["logical", "packed"])
def test_table_ids_for_batch_match_jax(layout):
    """Logical ids, and physical ids (id // pack) on packed tables."""
    jschema, tschema = schema_pair(SYNTH_SPEC)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    ids = np.random.default_rng(2).integers(
        0, 12, (6, tpacked.num_slots)).astype(np.int32)
    want = jopt.table_ids_for_batch(jpacked, jnp.asarray(ids),
                                    packed_tables=layout == "packed")
    trainer = _port_trainer(tpacked, LAZY, pallas={"table_layout": layout})
    assert trainer.model.table_layout == layout
    got = topt.table_ids_for_batch(trainer.model.embedding,
                                   torch.from_numpy(ids))
    assert set(got) == set(want) == {"table_w8", "table_w16"}
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_embedding_l2_loss_excludes_the_tables_as_in_jax():
    _, jarr, tpacked, _ = _data()
    trainer = _port_trainer(tpacked, LAZY)
    params = {n: p.detach() for n, p in trainer.params.items()}
    tree = {"embedding": {n.split(".", 1)[1]: jnp.asarray(p.numpy())
                          for n, p in params.items()
                          if n.startswith("embedding.")}}
    for exclude in (False, True):
        want = float(jax_l2(tree, 1e-3, exclude_tables=exclude))
        got = float(embedding_l2_loss(params, 1e-3, exclude_tables=exclude))
        assert got == pytest.approx(want, rel=1e-6)
    full = float(embedding_l2_loss(params, 1.0))
    tables = sum(float(torch.sum(p ** 2)) for n, p in params.items()
                 if "table_w" in n)
    assert full - float(embedding_l2_loss(params, 1.0, True)) == \
        pytest.approx(tables, rel=1e-5)


LAZY_CASES = [("deepfm", "logical", 1.0), ("deepfm", "logical", 0.0),
              ("deepfm", "packed", 1.0), ("xdeepfm", "packed", 1.0),
              ("fm", "logical", 1.0)]


@pytest.mark.parametrize("model,layout,clip", LAZY_CASES)
def test_two_lazy_steps_match_jax(model, layout, clip, tmp_path,
                                  monkeypatch):
    """Two lazy steps in both packages (the clip active at 1.0), each taken
    by the port from the JAX state before it: parameters, BN statistics
    and the f32 table moments after each step against
    the JAX state after it, in the tables' own layout. Each step starts
    from the JAX state because an element whose gradient cancels to ~1e-9
    against its lazy L2 takes an Adam step that differs by up to lr
    (within the band), and a second step carried on from it moves a
    16-element BN bias leaf past rtol; the step from a shared state is
    what the parity rule holds."""
    pallas = {"table_layout": layout}
    jtrainer, jstates, jlosses = _jax_run(
        "plain", clip, tmp_path, monkeypatch, optimizer="lazy_adam",
        model=model, pallas=pallas)
    assert jtrainer.lazy_tables
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {**LAZY, "gradient_clip_norm": clip},
                            model, pallas)
    assert trainer.path == "lazy" and trainer.lazy_tables
    assert trainer.model.table_layout == jtrainer._table_layout == layout
    for s in trainer.state.table_opt.values():
        assert s.mu.dtype == s.nu.dtype == torch.float32
    for k in range(2):
        train_state_from_jax(jstates[k], trainer)
        assert _port_step(trainer, tarr) == pytest.approx(jlosses[k],
                                                          rel=1e-6)
        assert int(trainer.state.step) == k + 1
        _assert_state_matches(trainer, jstates[k + 1], tpacked, steps=1)


def test_lazy_padding_rows_stay_exactly_zero():
    """Row 0 of every field (padding / OOV) has zero weight and zero
    gradient, so the lazy update leaves it at zero."""
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(tpacked, {**LAZY, "gradient_clip_norm": 1.0})
    for _ in range(3):
        _port_step(trainer, tarr)
    for group in tpacked.lookup_groups:
        table = trainer.params[f"embedding.table_w{group.width}"].detach()
        for off in np.unique(group.local_offsets):
            assert torch.all(table[int(off)] == 0.0)
    assert trainer_engagement(trainer)["backward"] == "lazy_adam"


def _loop_trainer(tmp, epochs, optimizer="lazy_adam"):
    from deepfm_tpu_torch.config import config_from_dict
    from deepfm_tpu_torch.data.packing import pack_features
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer
    from torch_port_helpers import random_features

    _, tschema = schema_pair(SYNTH_SPEC)
    tpacked = pack_schema(tschema)
    feats = random_features(SYNTH_SPEC, 4 * B, seed=8)
    labels = np.random.default_rng(9).integers(0, 2, 4 * B).astype(np.float32)
    arr = pack_features(tpacked, feats, labels)
    config = config_from_dict({
        "device": "cpu", "output_dir": str(tmp), "seed": 5,
        "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
        "training": {"batch_size": B, "optimizer": optimizer,
                     "scheduler": "none", "num_epochs": epochs,
                     "resume": True, "early_stopping_patience": 10},
    })
    model = create_model("deepfm", tpacked, config, device="cpu")
    return Trainer(model, tpacked, config, train_data=arr, val_data=arr,
                   test_data=arr)


def test_lazy_resume_equals_an_unbroken_run(tmp_path):
    """A run resumed after epoch 1 ends where an unbroken run ends, bit for
    bit (parameters and the table moments the checkpoint carries)."""
    whole = _loop_trainer(tmp_path / "whole", 2)
    whole.train()
    _loop_trainer(tmp_path / "split", 1).train()
    resumed = _loop_trainer(tmp_path / "split", 2)
    resumed.train()
    assert resumed.epoch == 2 and resumed.path == "lazy"
    for name, p in whole.params.items():
        assert torch.equal(resumed.params[name], p), name
    for name, s in whole.state.table_opt.items():
        r = resumed.state.table_opt[name]
        assert r.mu.dtype == torch.float32
        assert torch.equal(r.mu, s.mu) and torch.equal(r.nu, s.nu), name
    res = json.loads((tmp_path / "split" / "results.json").read_text())
    assert res["training_info"]["backward"] == "lazy_adam"


def test_resume_refuses_another_optimizer(tmp_path):
    _loop_trainer(tmp_path, 1).train()
    with pytest.raises(ValueError, match="optimizer lazy_adam"):
        _loop_trainer(tmp_path, 2, optimizer="adamw").train()
