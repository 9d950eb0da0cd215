"""The port's model-sharded train step on four gloo ranks at (2, 2),
against the JAX package's ``Trainer`` on ``build_mesh(2, 2)`` and against
the port's own one-process step at the same global batch; and on two
ranks at (1, 2), against one process bit for bit.

Rank processes (``tests/torch_dp_worker.py``: spawned, gloo through a
file, no JAX) take ``STEPS`` steps of every case below on their data
index's halves of the same global batches of 32 rows, each rank holding
its slab of every table, from the initial state of the JAX trainer; the
JAX trainer takes the same steps on four of this process's 8 virtual CPU
devices. Cases: DeepFM on every path and strategy, both layouts: the
sparse-fused replicated branch (psum) and routed branch (all_to_all),
two-pass (the exchange, plain and routed, and "auto": the slab's dense
gradient all-reduced over the data group), lazy, and the plain chain with
Adam and with SGD. The fused paths run the JAX package with
``DEEPFM_TPU_FORCE_FUSED_ADAM=1`` (its Pallas kernels in interpret
mode), on packed tables where its sparse-fused gate wants them, as
tests/test_torch_dp_step.py does.

Tolerances (the JAX package's own, tests/test_parallel.py:111-159 and
tests/test_routed_fused.py:145-210):
  * SGD: parameters and BatchNorm statistics within atol 2e-5 of JAX's;
  * Adam, clip 0: ``training/parity.py``'s rule (rtol 1e-5 / atol 1e-7
    for all but 0.1 % of a leaf's elements, every element within
    2 * lr * steps; a zero-gradient leaf to the band alone); psq rel
    1e-5;
  * Adam, clip 1.0 (one step): rtol 1e-4 / atol 1e-6 on every leaf with a
    gradient, the band on the zero-gradient ones;
  * losses rel 1e-5;
  * the replicas: bit for bit after every step (``Trainer.check_replicas``:
    replicated leaves over the world, slabs, their moments and psq over
    the data group) and in the returned states.
The port's (2, 2) run against its one process takes the same rules. At
(1, 2), f32, clip 0, every slab, table moment, dense leaf and BatchNorm
statistic equals the one-process run's bit for bit (one data row: every
sum but the clip norm's table terms is the one process's, in its order,
and clip 0 leaves the norm unused); ``table_psq`` (the slabs' sums over
the model group) within rel 1e-5. Three planted faults must each be
refused by the replica check or the comparison with one process: the
dense all-reduce over the world instead of the data group, the slab
update without its -j * rows shift, and model peers given different rows.
"""

import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402
from test_torch_dp_step import _batches, _load  # noqa: E402
from test_torch_train import (  # noqa: E402
    LR,
    _assert_state_matches,
    _port_trainer,
    _raw,
)

from deepfm_tpu.config import config_from_dict as jax_config  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    train_state_from_jax,
)
from deepfm_tpu_torch.parallel import is_table_path  # noqa: E402
from deepfm_tpu_torch.training.parity import (  # noqa: E402
    compare_leaves,
    zero_gradient_reference,
)

torch.set_num_threads(1)

AXES = (2, 2)
STEPS = 2
SGD_ATOL = 2e-5
LOSS_REL = 1e-5
PSQ_REL = 1e-5
CLIP_TOL = {"rtol": 1e-4, "atol": 1e-6}
CLIP0 = {"gradient_clip_norm": 0.0}
TWO_PASS = {"fused_backward": False, **CLIP0}
PACKED = {"table_layout": "packed"}
# case -> (port training, port pallas, strategy, JAX layout, JAX fused
# kernels forced, path)
CASES = {
    "sparse_fused_psum_logical": (CLIP0, {}, "psum", "packed", True,
                                  "sparse_fused"),
    "sparse_fused_psum_packed": (CLIP0, PACKED, "psum", "packed", True,
                                 "sparse_fused"),
    "sparse_fused_routed_logical": (CLIP0, {}, "all_to_all", "packed", True,
                                    "sparse_fused"),
    "sparse_fused_routed_packed": (CLIP0, PACKED, "all_to_all", "packed",
                                   True, "sparse_fused"),
    "sparse_fused_routed_clip": ({}, PACKED, "all_to_all", "packed", True,
                                 "sparse_fused"),
    "two_pass_psum_logical": (TWO_PASS, {}, "psum", "logical", True,
                              "two_pass"),
    "two_pass_psum_packed": (TWO_PASS, PACKED, "psum", "packed", True,
                             "two_pass"),
    "two_pass_routed_logical": (TWO_PASS, {}, "all_to_all", "logical", True,
                                "two_pass"),
    "two_pass_routed_packed": (TWO_PASS, PACKED, "all_to_all", "packed",
                               True, "two_pass"),
    "two_pass_auto": (TWO_PASS, {}, "auto", "logical", True, "two_pass"),
    "lazy_psum": ({"optimizer": "lazy_adam", **CLIP0}, {}, "psum",
                  "logical", False, "lazy"),
    "lazy_routed_packed": ({"optimizer": "lazy_adam", **CLIP0}, PACKED,
                           "all_to_all", "packed", False, "lazy"),
    "adam_plain": ({"fused_table_adam": False, **CLIP0}, {}, "psum",
                   "logical", False, "plain"),
    "sgd_plain": ({"optimizer": "sgd"}, {}, "all_to_all", "logical", False,
                  "plain"),
}
ONE_STEP = {"sparse_fused_routed_clip"}
# planted fault -> the case it runs on
FAULTS = {"world_reduce": "sparse_fused_psum_logical",
          "no_shift": "sparse_fused_psum_logical",
          "peer_rows": "two_pass_psum_logical"}


def _raw_of(name, **extra):
    training, pallas, strategy, *_ = CASES[name]
    return _raw(training, "deepfm", pallas=pallas,
                mesh={"embedding_strategy": strategy, "model_axis": 2},
                **extra)


def _steps(name):
    return 1 if name in ONE_STEP else STEPS


def _jax_run(name, jpacked, jax_batches, tmp, monkeypatch):
    """The JAX trainer's states (host copies) and losses on a (2, 2)
    mesh."""
    training, _, strategy, layout, force, path = CASES[name]
    if force:
        monkeypatch.setenv("DEEPFM_TPU_FORCE_FUSED_ADAM", "1")
    else:
        monkeypatch.delenv("DEEPFM_TPU_FORCE_FUSED_ADAM", raising=False)
    config = jax_config(_raw(training, "deepfm", output_dir=str(tmp),
                             pallas={"table_layout": layout},
                             mesh={"embedding_strategy": strategy,
                                   "model_axis": 2}))
    mesh = jax_build_mesh(*AXES, devices=jax.devices()[:4])
    trainer = JaxTrainer(jax_create_model("deepfm", jpacked, config,
                                          mesh=mesh),
                         jpacked, config, jax_batches[0], jax_batches[0],
                         jax_batches[0], mesh=mesh)
    assert trainer.sparse_fused is (path == "sparse_fused")
    assert trainer.lazy_tables is (path == "lazy")
    assert trainer.fused_tables is (path in ("sparse_fused", "two_pass"))
    states, losses = [jax.device_get(trainer.state)], []
    state = trainer.state
    for arr in jax_batches[:_steps(name)]:
        batch = trainer._put_batch(arr.ids, arr.dense, arr.labels,
                                   np.ones(len(arr.labels), np.float32))
        state, loss = trainer._train_step(state, *batch)
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return states, losses


def _holder(name, tpacked):
    """A one-process port trainer of the case (a container of states)."""
    training, pallas, *_ = CASES[name]
    return _port_trainer(tpacked, training, "deepfm", pallas)


def _whole(ranks, name, m=AXES[1]):
    """The whole state of data index 0 (ranks 0..m-1): each table, its
    moments (and plain-chain leaves) the concatenation of the slabs in
    model order."""
    states = [ranks[j][name]["state"] for j in range(m)]
    out = {"model": {}, "table_opt": {}, "table_psq":
           dict(states[0]["table_psq"])}
    for k, v in states[0]["model"].items():
        out["model"][k] = (torch.cat([s["model"][k] for s in states])
                           if is_table_path(k) else v)
    for k, (mu, _) in states[0]["table_opt"].items():
        out["table_opt"][k] = tuple(
            torch.cat([s["table_opt"][k][i] for s in states])
            for i in range(2))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_shard_step")
    jpacked, jax_b, tpacked, port_b = _batches()
    out = {"tpacked": tpacked, "jax": {}, "one": {}}
    cases = []
    with pytest.MonkeyPatch.context() as mp:
        for name in CASES:
            states, losses = _jax_run(name, jpacked, jax_b, tmp / name, mp)
            out["jax"][name] = (states, losses)
            holder = _holder(name, tpacked)
            train_state_from_jax(states[0], holder)
            init = torch_dp_worker.port_state(holder)
            batches = port_b[:_steps(name)]
            cases.append({"name": name, "raw": _raw_of(name, device="cpu"),
                          "packed": tpacked, "init": init,
                          "batches": batches})
            one = [float(holder._train_step(*b)) for b in batches]
            out["one"][name] = (holder.path, one,
                                torch_dp_worker.port_state(holder))
    by_name = {c["name"]: c for c in cases}
    faults = [{**by_name[case], "name": fault, "fault": fault}
              for fault, case in FAULTS.items()]
    ranks = torch_dp_worker.spawn(4, torch_dp_worker.run_steps,
                                  (cases + faults,), tmp / "ranks",
                                  axes=AXES)
    out["sharded"] = [{r["name"]: r for r in rank} for rank in ranks]
    exact = [c for c in cases if c["raw"]["training"].get(
        "gradient_clip_norm") == 0.0]
    ranks = torch_dp_worker.spawn(2, torch_dp_worker.run_steps, (exact,),
                                  tmp / "ranks_1x2", axes=(1, 2))
    out["exact"] = [{r["name"]: r for r in rank} for rank in ranks]
    return out


def _compare(got_trainer, want_trainer, steps):
    want = dict(want_trainer.model.state_dict())
    got = dict(got_trainer.model.state_dict())
    for name, s in (want_trainer.state.table_opt or {}).items():
        mine = got_trainer.state.table_opt[name]
        for m in ("mu", "nu"):
            want[f"{name}.{m}"] = getattr(s, m).float()
            got[f"{name}.{m}"] = getattr(mine, m).float()
    return compare_leaves(got, want, LR, steps, zero_gradient=(
        got_trainer.model.zero_gradient_leaves))["failed_leaves"]


def _clip_check(trainer, want: dict, steps):
    """CLIP_TOL on every leaf with a gradient, the band on the rest."""
    zero = trainer.model.zero_gradient_leaves
    for leaf, w in want.items():
        got = trainer.model.state_dict()[leaf].numpy()
        if zero_gradient_reference(leaf, zero) or "running_" in leaf:
            assert np.abs(got - np.asarray(w)).max() <= 2 * LR * steps, leaf
        else:
            np.testing.assert_allclose(got, np.asarray(w), err_msg=leaf,
                                       **CLIP_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_on_a_2x2_mesh(runs, name):
    tpacked = runs["tpacked"]
    jstates, jlosses = runs["jax"][name]
    got = runs["sharded"][0][name]
    assert got["path"] == CASES[name][5]
    assert got["losses"] == pytest.approx(jlosses, rel=LOSS_REL)
    whole = _whole(runs["sharded"], name)
    trainer = _load(_holder(name, tpacked), whole)
    want = params_from_jax(jstates[-1].params, jstates[-1].batch_stats,
                           tpacked, trainer.config)
    if name == "sgd_plain":
        for leaf, w in want.items():
            np.testing.assert_allclose(
                whole["model"][leaf].numpy(), np.asarray(w),
                atol=SGD_ATOL, rtol=0, err_msg=leaf)
    elif name in ONE_STEP:
        _clip_check(trainer, want, _steps(name))
    else:
        _assert_state_matches(trainer, jstates[-1], tpacked,
                              steps=_steps(name))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_one_process(runs, name):
    tpacked = runs["tpacked"]
    path, losses, state = runs["one"][name]
    got = runs["sharded"][0][name]
    assert got["path"] == path == CASES[name][5]
    assert got["losses"] == pytest.approx(losses, rel=LOSS_REL)
    whole = _whole(runs["sharded"], name)
    mine = _load(_holder(name, tpacked), whole)
    one = _load(_holder(name, tpacked), state)
    if name == "sgd_plain":
        for leaf, w in state["model"].items():
            np.testing.assert_allclose(whole["model"][leaf].numpy(),
                                       w.numpy(), atol=SGD_ATOL, rtol=0,
                                       err_msg=leaf)
    else:
        assert not _compare(mine, one, _steps(name))
    for n, v in state["table_psq"].items():
        assert float(whole["table_psq"][n]) == pytest.approx(float(v),
                                                             rel=PSQ_REL)


@pytest.mark.parametrize("name", list(CASES))
def test_slabs_agree_over_each_data_group_and_the_rest_over_the_world(
        runs, name):
    ranks = [r[name] for r in runs["sharded"]]
    assert all(r["replica_refusal"] is None for r in ranks)
    m = AXES[1]
    for rank, r in enumerate(ranks):
        assert r["losses"] == ranks[0]["losses"]
        peer = ranks[rank % m]  # the same model column, data index 0
        first = ranks[0]
        for part in ("model", "table_psq"):
            for leaf, t in r["state"][part].items():
                want = (peer if is_table_path(leaf) else first)["state"]
                assert torch.equal(t, want[part][leaf]), (rank, leaf)
        for leaf, pair in r["state"]["table_opt"].items():
            for i in range(2):
                assert torch.equal(pair[i],
                                   peer["state"]["table_opt"][leaf][i])


@pytest.mark.parametrize("name", [n for n in CASES
                                  if CASES[n][0].get("gradient_clip_norm")
                                  == 0.0])
def test_one_data_row_equals_one_process_bit_for_bit(runs, name):
    _, losses, state = runs["one"][name]
    got = runs["exact"][0][name]
    assert got["losses"] == losses
    whole = _whole(runs["exact"], name, m=2)
    for leaf, w in state["model"].items():
        assert torch.equal(whole["model"][leaf], w), leaf
    for leaf, (mu, nu) in state["table_opt"].items():
        assert torch.equal(whole["table_opt"][leaf][0], mu), leaf
        assert torch.equal(whole["table_opt"][leaf][1], nu), leaf
    for n, v in state["table_psq"].items():
        assert float(whole["table_psq"][n]) == pytest.approx(float(v),
                                                             rel=PSQ_REL)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_refused(runs, fault):
    tpacked = runs["tpacked"]
    case = FAULTS[fault]
    ranks = [r[fault] for r in runs["sharded"]]
    _, losses, state = runs["one"][case]
    refused_by_replicas = any(r["replica_refusal"] is not None
                              for r in ranks)
    mine = _load(_holder(case, tpacked), _whole(runs["sharded"], fault))
    one = _load(_holder(case, tpacked), state)
    refused_by_one_process = bool(_compare(mine, one, STEPS)) or (
        ranks[0]["losses"] != pytest.approx(losses, rel=LOSS_REL))
    assert refused_by_replicas or refused_by_one_process
