"""The port's data-parallel train step on two gloo ranks, against the JAX
package's ``Trainer`` on a (2, 1) mesh and against the port's own
one-process step at the same global batch.

Two rank processes (``tests/torch_dp_worker.py``: spawned, gloo through a
file, no JAX) take ``STEPS`` steps of every case below on their halves of
the same global batches of 32 rows, from the initial state of the JAX
trainer; the JAX trainer takes the same steps on ``build_mesh(2, 1)``
over two of this process's 8 virtual CPU devices. Cases: DeepFM on every
path (sparse-fused on logical and packed tables, two-pass on both, lazy,
the plain chain with Adam and with SGD) and xDeepFM sparse-fused. The
fused paths run the JAX package with ``DEEPFM_TPU_FORCE_FUSED_ADAM=1``
(its Pallas kernels in interpret mode), on packed tables where its
sparse-fused gate wants them, as tests/test_torch_train.py does.

Tolerances:
  * SGD (the plain chain): parameters and BatchNorm statistics within
    atol 2e-5 of JAX's, the JAX package's own sharded-against-one-device
    step test (tests/test_parallel.py);
  * Adam, clip 0: ``training/parity.py``'s rule, which
    tests/test_torch_train.py holds the one-device step to (rtol 1e-5 /
    atol 1e-7 for all but 0.1 % of a leaf's elements, every element
    within 2 * lr * steps; a zero-gradient leaf to the band alone); psq
    rel 1e-5;
  * losses rel 1e-5 (tests/test_parallel.py's);
  * the replicas: the two ranks' states equal bit for bit after every
    step (the all-gathered fingerprint of ``Trainer.check_replicas``, and
    the returned states compared with ``torch.equal``).
The port's two ranks against its one process take the same rules. Three
planted faults must be refused: rank 1 keeping its own dense gradients
(the replica check), the pairs not all-gathered and BatchNorm on per-rank
statistics (both the comparison with one process). BatchNorm's global
statistics, output and gradients are held against one process on the
whole batch (rtol 1e-6 / atol 1e-7: only the order of two partial sums
differs).
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import torch_dp_worker  # noqa: E402
from test_torch_train import (  # noqa: E402
    B,
    LR,
    _assert_state_matches,
    _port_trainer,
    _raw,
)
from torch_port_helpers import (  # noqa: E402
    SYNTH_SPEC,
    random_features,
    schema_pair,
)

from deepfm_tpu.config import config_from_dict as jax_config  # noqa: E402
from deepfm_tpu.data.packing import pack_features as jax_pack  # noqa: E402
from deepfm_tpu.data.packing import pack_schema as jax_pack_schema  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict  # noqa: E402
from deepfm_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    train_state_from_jax,
)
from deepfm_tpu_torch.data.packing import pack_features, pack_schema  # noqa: E402
from deepfm_tpu_torch.models import create_model  # noqa: E402
from deepfm_tpu_torch.ops.dnn import BatchNorm  # noqa: E402
from deepfm_tpu_torch.parallel import build_mesh, check_batch  # noqa: E402
from deepfm_tpu_torch.training.parity import compare_leaves  # noqa: E402
from deepfm_tpu_torch.training.sparse_opt import TableSlotState  # noqa: E402
from deepfm_tpu_torch.training.trainer import Trainer  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
STEPS = 2
SEEDS = (3, 8)  # one global batch a step
SGD_ATOL = 2e-5
LOSS_REL = 1e-5
BN_TOL = {"rtol": 1e-6, "atol": 1e-7}
CLIP0 = {"gradient_clip_norm": 0.0}
# case -> (model, port training, port pallas, JAX training, JAX layout,
# JAX fused kernels forced, path)
CASES = {
    "sgd_plain": ("deepfm", {"optimizer": "sgd"}, {},
                  {"optimizer": "sgd"}, "logical", False, "plain"),
    "adam_plain": ("deepfm", {"fused_table_adam": False, **CLIP0}, {},
                   {"fused_table_adam": False, **CLIP0}, "logical", False,
                   "plain"),
    "sparse_fused_logical": ("deepfm", CLIP0, {}, CLIP0, "packed", True,
                             "sparse_fused"),
    "sparse_fused_packed": ("deepfm", CLIP0, {"table_layout": "packed"},
                            CLIP0, "packed", True, "sparse_fused"),
    "two_pass_logical": ("deepfm", {"fused_backward": False, **CLIP0}, {},
                         {"fused_backward": False, **CLIP0}, "logical", True,
                         "two_pass"),
    "two_pass_packed": ("deepfm", {"fused_backward": False, **CLIP0},
                        {"table_layout": "packed"},
                        {"fused_backward": False, **CLIP0}, "packed", True,
                        "two_pass"),
    "lazy": ("deepfm", {"optimizer": "lazy_adam", **CLIP0}, {},
             {"optimizer": "lazy_adam", **CLIP0}, "logical", False, "lazy"),
    "xdeepfm_sparse_fused": ("xdeepfm", CLIP0, {}, CLIP0, "packed", True,
                             "sparse_fused"),
}
# planted fault -> what must refuse it
FAULTS = {"skip_reduce": "replicas", "skip_gather": "one_process",
          "local_bn": "one_process"}


def _batches():
    """The global batches of the steps, in both packages' arrays."""
    jschema, tschema = schema_pair(SYNTH_SPEC)
    jpacked, tpacked = jax_pack_schema(jschema), pack_schema(tschema)
    jax_b, port_b = [], []
    for seed in SEEDS:
        feats = random_features(SYNTH_SPEC, B, seed=seed)
        labels = np.random.default_rng(seed + 1).integers(0, 2, B).astype(
            np.float32)
        ja = jax_pack(jpacked, feats, labels)
        ta = pack_features(tpacked, feats, labels)
        jax_b.append(ja)
        port_b.append((ta.ids, ta.dense, ta.labels, np.ones(B, np.float32)))
    return jpacked, jax_b, tpacked, port_b


def _jax_dp_run(name, jpacked, jax_batches, tmp, monkeypatch):
    """The JAX trainer's states (host copies) and losses on a (2, 1) mesh."""
    model, _, _, jax_tr, layout, force, path = CASES[name]
    if force:
        monkeypatch.setenv("DEEPFM_TPU_FORCE_FUSED_ADAM", "1")
    else:
        monkeypatch.delenv("DEEPFM_TPU_FORCE_FUSED_ADAM", raising=False)
    config = jax_config(_raw(jax_tr, model, output_dir=str(tmp),
                             pallas={"table_layout": layout}))
    mesh = jax_build_mesh(WORLD, 1, devices=jax.devices()[:WORLD])
    trainer = JaxTrainer(jax_create_model(model, jpacked, config, mesh=mesh),
                         jpacked, config, jax_batches[0], jax_batches[0],
                         jax_batches[0], mesh=mesh)
    assert trainer.sparse_fused is (path == "sparse_fused")
    assert trainer.lazy_tables is (path == "lazy")
    assert trainer.fused_tables is (path in ("sparse_fused", "two_pass"))
    states, losses = [jax.device_get(trainer.state)], []
    state = trainer.state
    for arr in jax_batches:
        batch = trainer._put_batch(arr.ids, arr.dense, arr.labels,
                                   np.ones(B, np.float32))
        state, loss = trainer._train_step(state, *batch)
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return states, losses


def _port_raw(name):
    model, port_tr, pallas, *_ = CASES[name]
    return _raw(port_tr, model, device="cpu", pallas=pallas)


def _holder(name, tpacked):
    """A one-process port trainer of the case (a container of states)."""
    model, port_tr, pallas, *_ = CASES[name]
    return _port_trainer(tpacked, port_tr, model, pallas)


def _load(trainer, state):
    """A rank's returned state into a one-process trainer."""
    trainer.model.load_state_dict(state["model"])
    if state["table_opt"]:
        trainer.state.table_opt = {n: TableSlotState(mu, nu)
                                   for n, (mu, nu) in state["table_opt"].items()}
    if state["table_psq"]:
        trainer.state.table_psq = dict(state["table_psq"])
    return trainer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_step")
    jpacked, jax_b, tpacked, port_b = _batches()
    out = {"tpacked": tpacked, "jax": {}, "one": {}, "init": {}}
    cases = []
    with pytest.MonkeyPatch.context() as mp:
        for name in CASES:
            states, losses = _jax_dp_run(name, jpacked, jax_b,
                                         tmp / name, mp)
            out["jax"][name] = (states, losses)
            holder = _holder(name, tpacked)
            train_state_from_jax(states[0], holder)
            init = torch_dp_worker.port_state(holder)
            out["init"][name] = init
            cases.append({"name": name, "raw": _port_raw(name),
                          "packed": tpacked, "init": init,
                          "batches": port_b})
            # the port in one process, on the whole global batches
            one = [float(holder._train_step(*b)) for b in port_b]
            out["one"][name] = (holder.path, one,
                                torch_dp_worker.port_state(holder))
    for fault in FAULTS:
        cases.append({**cases[list(CASES).index("sparse_fused_logical")],
                      "name": fault, "fault": fault})
    rng = np.random.default_rng(21)
    out["bn_x"] = rng.normal(1.0, 2.0, (B, 6)).astype(np.float32)
    out["bn_w"] = rng.normal(size=(B, 6)).astype(np.float32)
    steps = torch_dp_worker.spawn(WORLD, torch_dp_worker.run_steps,
                                  (cases,), tmp / "ranks")
    out["dp"] = [{r["name"]: r for r in rank} for rank in steps]
    out["bn"] = torch_dp_worker.spawn(
        WORLD, torch_dp_worker.batchnorm_global, (out["bn_x"], out["bn_w"]),
        tmp / "bn")
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


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_jax_on_a_2x1_mesh(runs, name):
    tpacked = runs["tpacked"]
    jstates, jlosses = runs["jax"][name]
    got = runs["dp"][0][name]
    assert got["path"] == CASES[name][6]
    assert got["losses"] == pytest.approx(jlosses, rel=LOSS_REL)
    trainer = _load(_holder(name, tpacked), got["state"])
    if name == "sgd_plain":
        want = params_from_jax(jstates[-1].params, jstates[-1].batch_stats,
                               tpacked, trainer.config)
        for leaf, w in want.items():
            np.testing.assert_allclose(
                got["state"]["model"][leaf].numpy(), np.asarray(w),
                atol=SGD_ATOL, rtol=0, err_msg=leaf)
    else:
        _assert_state_matches(trainer, jstates[-1], tpacked, steps=STEPS)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_one_process(runs, name):
    tpacked = runs["tpacked"]
    path, losses, state = runs["one"][name]
    got = runs["dp"][0][name]
    assert got["path"] == path == CASES[name][6]
    assert got["losses"] == pytest.approx(losses, rel=LOSS_REL)
    mine = _load(_holder(name, tpacked), got["state"])
    one = _load(_holder(name, tpacked), state)
    if name == "sgd_plain":
        for leaf, w in state["model"].items():
            np.testing.assert_allclose(got["state"]["model"][leaf].numpy(),
                                       w.numpy(), atol=SGD_ATOL, rtol=0,
                                       err_msg=leaf)
    else:
        assert not _compare(mine, one, STEPS)
    for n, v in state["table_psq"].items():
        assert float(got["state"]["table_psq"][n]) == pytest.approx(
            float(v), rel=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_replicas_hold_the_same_bits(runs, name):
    r0, r1 = runs["dp"][0][name], runs["dp"][1][name]
    assert r0["replica_refusal"] is None and r1["replica_refusal"] is None
    assert r0["losses"] == r1["losses"]
    for part in ("model", "table_psq"):
        for leaf, t in r0["state"][part].items():
            assert torch.equal(t, r1["state"][part][leaf]), leaf
    for leaf, (mu, nu) in r0["state"]["table_opt"].items():
        assert torch.equal(mu, r1["state"]["table_opt"][leaf][0]), leaf
        assert torch.equal(nu, r1["state"]["table_opt"][leaf][1]), leaf


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_are_refused(runs, fault):
    tpacked = runs["tpacked"]
    got = runs["dp"][0][fault]
    _, losses, state = runs["one"]["sparse_fused_logical"]
    refused_by_replicas = (got["replica_refusal"] is not None
                           and runs["dp"][1][fault]["replica_refusal"]
                           is not None)
    mine = _load(_holder("sparse_fused_logical", tpacked), got["state"])
    one = _load(_holder("sparse_fused_logical", tpacked), state)
    refused_by_one_process = bool(_compare(mine, one, STEPS)) or (
        got["losses"] != pytest.approx(losses, rel=LOSS_REL))
    if FAULTS[fault] == "replicas":
        assert refused_by_replicas, got["replica_refusal"]
        assert "the ranks' replicas differ in step 1" in got[
            "replica_refusal"]
    else:
        assert refused_by_one_process


def test_batchnorm_takes_the_global_statistics(runs):
    x, w = runs["bn_x"], runs["bn_w"]
    bn = BatchNorm(x.shape[1], eps=1e-5, momentum=0.1)
    xs = torch.from_numpy(x).requires_grad_()
    y = bn(xs)
    (y * torch.from_numpy(w)).sum().backward()
    half = B // WORLD
    for rank, got in enumerate(runs["bn"]):
        rows = slice(rank * half, (rank + 1) * half)
        for key, want in (("out", y.detach()[rows]),
                          ("x_grad", xs.grad[rows]),
                          ("running_mean", bn.running_mean),
                          ("running_var", bn.running_var),
                          ("scale_grad", bn.weight.grad),
                          ("bias_grad", bn.bias.grad)):
            np.testing.assert_allclose(got[key].numpy(), want.numpy(),
                                       err_msg=key, **BN_TOL)
    # the same running statistics on both ranks, bit for bit
    assert torch.equal(runs["bn"][0]["running_var"],
                       runs["bn"][1]["running_var"])


def test_model_axis_above_1_is_refused():
    """No longer refused (ROADMAP item 10(b)): a model axis above 1 builds
    the (data, model) mesh, rank r at data index r // m and model index
    r % m (the JAX mesh's model-inner device order)."""
    for data_axis in (1, -1):
        mesh = build_mesh(data_axis, 2, n=2, device="cpu")
        assert (mesh.data, mesh.model, mesh.size) == (1, 2, 2)
        assert (mesh.data_index, mesh.model_index) == (0, 0)
    for rank, want in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        mesh = dataclasses.replace(build_mesh(2, 2, n=4, device="cpu"),
                                   rank=rank)
        assert (mesh.data_index, mesh.model_index) == want


def test_a_batch_the_ranks_do_not_divide_is_refused_before_data(
        monkeypatch):
    from deepfm_tpu_torch import cli

    def no_data(config):
        raise AssertionError("data built before the batch was checked")

    monkeypatch.setattr(cli, "_build_data", no_data)
    monkeypatch.setattr(cli, "build_runtime",
                        lambda config: build_mesh(2, 1, n=2, device="cpu"))
    config = config_from_dict(_raw({"batch_size": 31}, device="cpu"))
    for command in (cli.train_command, cli.evaluate_command):
        with pytest.raises(ValueError, match=r"batch_size 31 is not "
                                             r"divisible by the mesh's data "
                                             r"axis 2"):
            command(config)


def test_a_batch_the_ranks_do_not_divide_is_refused():
    mesh = build_mesh(2, 1, n=2, device="cpu")
    with pytest.raises(ValueError, match=r"batch_size 31 is not divisible "
                                         r"by the mesh's data axis 2"):
        check_batch(mesh, 31)
    _, _, tpacked, _ = _batches()
    config = config_from_dict(_raw({"batch_size": 31}, device="cpu"))
    model = create_model("deepfm", tpacked, config, device="cpu")
    with pytest.raises(ValueError, match=r"batch_size 31 .* data axis 2"):
        Trainer(model, tpacked, config, mesh=mesh)
