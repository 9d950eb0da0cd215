"""Two settings the JAX CLI acts on, held in the port against the JAX
package on the CPU.

* ``mesh``: ``deepfm_tpu_torch/parallel/mesh.py::resolve_mesh`` refuses
  exactly where the JAX package's ``build_runtime`` / ``build_mesh`` /
  ``build_hybrid_mesh`` refuse (with the same words) and resolves the same
  shape where they do not, over a table of axes, slices and device counts
  (this process has 8 CPU devices, tests/conftest.py); on one rank the
  ``train`` command refuses ``configs/deepfm_criteo_multichip.yaml``
  before it builds any data, and on two it forms the 1x2 mesh and goes on
  to build the data; ``check_multihost`` with and without a
  coordinator and ``allow_single_process``, from explicit environments:
  torchrun's starts the process group (``init_process_group`` replaced
  by a recorder), a coordinator named only by the JAX package's variables
  is refused (no JAX distributed probe runs).
* ``profile.debug_nans``: on each ``Trainer`` path (plain, two-pass,
  sparse-fused, lazy) a planted NaN raises ``FloatingPointError`` before
  the step updates a parameter; a clean run with it set equals one
  without it bit for bit; unset, a step reads nothing more back to the
  host (every host read counted). JAX with ``jax_debug_nans`` raises on
  the same planted fault.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_train import B, _data, _port_trainer  # noqa: E402

from deepfm_tpu.config import config_from_dict as jax_config  # noqa: E402
from deepfm_tpu.models import create_model as jax_create_model  # noqa: E402
from deepfm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from deepfm_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from deepfm_tpu_torch import cli  # noqa: E402
from deepfm_tpu_torch.config import config_from_dict, load_config  # noqa: E402
from deepfm_tpu_torch.parallel import (  # noqa: E402
    check_multihost,
    mesh as tmesh,
    multiprocess_env_configured,
    resolve_mesh,
)

torch.set_num_threads(1)

# (data_axis, model_axis, num_slices, n_devices)
MESH_CASES = [
    (-1, 1, 1, 1), (4, 1, 1, 1), (-1, -1, 1, 1), (1, 2, 1, 1),
    (-1, 2, 1, 1), (0, 0, 1, 1), (1, 0, 1, 1), (-1, 1, 2, 1),
    (-1, 2, 2, 1), (-1, 1, 1, 2), (2, 1, 1, 4), (-1, -1, 1, 4),
    (-1, 2, 1, 8), (2, 4, 1, 8), (3, -1, 1, 8), (-1, 16, 1, 8),
    (8, 0, 1, 8), (-1, 1, 2, 8), (-1, 2, 2, 8), (4, 2, 2, 8),
    (2, 2, 2, 8), (-1, 3, 2, 8), (-1, 1, 3, 8), (-1, 0, 2, 8),
    (-1, 2, 1, 2),
]


def _jax_runtime(d, m, s, n):
    """What the JAX package's ``build_runtime`` does on ``n`` of the
    process's devices: None (no mesh), the mesh's (data, model) or the
    ValueError's message."""
    devices = jax.devices()[:n]
    assert len(devices) == n
    if n == 1 and m in (1, -1):
        return None
    try:
        if s > 1:
            mesh = jax_mesh.build_hybrid_mesh(s, d, m, devices=devices)
        else:
            mesh = jax_mesh.build_mesh(d, m, devices=devices)
    except ValueError as e:
        return str(e)
    return (mesh.shape["data"], mesh.shape["model"])


def _mesh_config(d, m, s, **mesh):
    return config_from_dict({"mesh": {"data_axis": d, "model_axis": m,
                                      "num_slices": s, **mesh}})


@pytest.mark.parametrize("d,m,s,n", MESH_CASES)
def test_resolve_mesh_refuses_where_jax_does(d, m, s, n):
    want = _jax_runtime(d, m, s, n)
    try:
        got = resolve_mesh(_mesh_config(d, m, s), n)
    except ValueError as e:
        got = str(e)
    assert got == want


def test_train_refuses_the_multichip_config_before_building_data(
        monkeypatch, tmp_path):
    def no_data(config):
        raise AssertionError("data built before the mesh was checked")

    monkeypatch.setattr(cli, "_build_data", no_data)
    config = load_config("configs/deepfm_criteo_multichip.yaml",
                         ["device=cpu", f"output_dir={tmp_path}"])
    want = _jax_runtime(config.mesh.data_axis, config.mesh.model_axis,
                        config.mesh.num_slices, 1)
    assert want == "mesh 0x2 != 1 available devices"
    for command in (cli.train_command, cli.evaluate_command,
                    cli._restore_predictor):
        with pytest.raises(ValueError, match=r"ROADMAP queue 1 item 10") \
                as info:
            command(config)
        assert str(info.value).startswith(want)
    # a mesh of one device passes: the default data_axis -1, and model -1
    for mesh in ({}, {"model_axis": -1, "data_axis": 4}):
        ok = config_from_dict({"device": "cpu", "mesh": mesh,
                               "output_dir": str(tmp_path)})
        with pytest.raises(AssertionError, match="data built"):
            cli.train_command(ok)
    # over two ranks the same config forms a 1x2 mesh (the model axis
    # row-shards the tables, ROADMAP item 10(b)) and reaches the data
    monkeypatch.setattr(tmesh, "world_size", lambda: 2)
    mesh = cli.build_runtime(config)
    assert (mesh.data, mesh.model, mesh.world) == (1, 2, 2)
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    for command in (cli.train_command, cli.evaluate_command):
        with pytest.raises(AssertionError, match="data built"):
            command(config)


# (environment, names a coordinator in the JAX package's rule)
JAX_ENVS = [
    ({}, False),
    ({"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"}, True),
    ({"COORDINATOR_ADDRESS": "h:1"}, True),
    ({"MEGASCALE_COORDINATOR_ADDRESS": "h:1"}, True),
    ({"OMPI_MCA_orte_hnp_uri": "x"}, True),
    ({"TPU_WORKER_HOSTNAMES": "localhost"}, False),
    ({"TPU_WORKER_HOSTNAMES": "a,b"}, True),
    ({"SLURM_JOB_NUM_NODES": "1"}, False),
    ({"SLURM_JOB_NUM_NODES": "2"}, True),
    ({"SLURM_JOB_NUM_NODES": "many"}, False),
    ({"TPU_WORKER_ID": "0", "CLOUD_TPU_TASK_ID": "0"}, False),
]


@pytest.mark.parametrize("env,coordinator", JAX_ENVS)
def test_coordinator_signals_match_jax(env, coordinator):
    assert jax_mesh._multiprocess_env_configured(env) is coordinator
    assert multiprocess_env_configured(env) is coordinator


@pytest.mark.parametrize("world,coordinator", [("1", False), ("2", True),
                                               ("x", False)])
def test_torchrun_world_size_is_a_coordinator(world, coordinator):
    assert multiprocess_env_configured({"WORLD_SIZE": world}) is coordinator


def _warnings():
    messages = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: messages.append(record.getMessage())
    logging.getLogger("deepfm_tpu_torch").addHandler(handler)
    return messages, handler


# torchrun's environment for rank 1 of 4
TORCHRUN = {"WORLD_SIZE": "4", "RANK": "1", "LOCAL_RANK": "1",
            "MASTER_ADDR": "h", "MASTER_PORT": "1"}


@pytest.mark.parametrize("allow", [False, True])
@pytest.mark.parametrize("env", [{}, {"JAX_COORDINATOR_ADDRESS": "h:1"},
                                 TORCHRUN])
def test_check_multihost(env, allow, monkeypatch):
    started = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: started.append((a, k)))
    messages, handler = _warnings()
    try:
        # multihost off: nothing is checked or started, whatever the
        # environment
        assert check_multihost(config_from_dict({
            "device": "cpu", "mesh": {"allow_single_process": allow}}),
            env) is False
        config = config_from_dict({"device": "cpu", "mesh": {
            "multihost": True, "allow_single_process": allow}})
        if env == TORCHRUN:  # a coordinator: the process group starts
            assert check_multihost(config, env) is True
            (args, kwargs), = started
            assert args == ("gloo",)  # the ranks run on the CPU
            assert kwargs["init_method"] == "tcp://h:1"
            assert (kwargs["rank"], kwargs["world_size"]) == (1, 4)
        elif env:  # a coordinator torch cannot start from
            with pytest.raises(RuntimeError, match=(
                    r"names a coordinator, but not torchrun's "
                    r"MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE")):
                check_multihost(config, env)
        elif not allow:  # the JAX CLI's refusal
            with pytest.raises(RuntimeError, match=(
                    r"^mesh\.multihost=true but no coordinator could be "
                    r"found .*set mesh\.allow_single_process=true")):
                check_multihost(config, env)
        else:  # the JAX CLI's warn-and-continue
            assert check_multihost(config, env) is False
            assert messages == [
                "mesh.multihost=true but no coordinator is configured; "
                "running single-process (mesh.allow_single_process=true)"]
    finally:
        logging.getLogger("deepfm_tpu_torch").removeHandler(handler)
    if env or not allow:
        assert not messages
    if env != TORCHRUN:
        assert not started


def test_serving_commands_check_multihost(monkeypatch):
    # as the JAX CLI, which checks multihost before every command: the
    # serving prologue refuses mesh.multihost without a coordinator and a
    # coordinator torch cannot start from; launched as several ranks, the
    # serving commands refuse a mesh the ranks cannot form, by the JAX
    # package's words, before any data is built
    monkeypatch.setattr(cli, "_build_data", lambda config: 1 / 0)
    for name in (*tmesh.COORDINATOR_ENV, "WORLD_SIZE", "SLURM_JOB_NUM_NODES",
                 "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(name, raising=False)
    config = config_from_dict({"device": "cpu", "mesh": {"multihost": True}})
    with pytest.raises(RuntimeError, match=(
            r"^mesh\.multihost=true but no coordinator could be found")):
        cli._restore_predictor(config)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h:1")
    with pytest.raises(RuntimeError, match="names a coordinator, but not "
                       "torchrun's MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE"):
        cli._restore_predictor(config)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setattr(tmesh, "world_size", lambda: 3)
    two = config_from_dict({"device": "cpu", "mesh": {"model_axis": 2}})
    want = _jax_runtime(-1, 2, 1, 3)
    assert want == "mesh 1x2 != 3 available devices"
    for command in (cli._restore_predictor,
                    lambda c: cli.predict_command(c, "in", "out"),
                    lambda c: cli.recommend_command(c, 1, 5, False),
                    lambda c: cli.serve_command(c, "127.0.0.1", 0)):
        with pytest.raises(ValueError, match=r"ROADMAP queue 1 item 10") \
                as info:
            command(two)
        assert str(info.value).startswith(want)


def test_export_checks_the_runtime_on_its_serving_mesh(monkeypatch,
                                                       tmp_path):
    # as the JAX CLI, which checks multihost before every command: export
    # refuses multihost without a coordinator, and its 1x1 serving mesh
    # takes the multichip config on to the data
    monkeypatch.setattr(cli, "_build_data", lambda config: 1 / 0)
    for name in (*tmesh.COORDINATOR_ENV, "WORLD_SIZE", "SLURM_JOB_NUM_NODES",
                 "TPU_WORKER_HOSTNAMES"):
        monkeypatch.delenv(name, raising=False)
    out = str(tmp_path / "model.pt2")
    config = config_from_dict({"device": "cpu", "mesh": {"multihost": True},
                               "output_dir": str(tmp_path)})
    with pytest.raises(RuntimeError, match="no coordinator could be found"):
        cli.export_command(config, out, "cpu", None)
    multichip = load_config("configs/deepfm_criteo_multichip.yaml",
                            ["device=cpu", f"output_dir={tmp_path}"])
    with pytest.raises(ZeroDivisionError):
        cli.export_command(multichip, out, "cpu", None)


# ---------------------------------------------------------------------------
# profile.debug_nans
# ---------------------------------------------------------------------------

# path -> the port's training overrides (tests/test_torch_train.py's PATHS)
NAN_PATHS = {
    "plain": {"fused_table_adam": False},
    "two_pass": {"fused_backward": False},
    "sparse_fused": {},
    "lazy": {"optimizer": "lazy_adam"},
}
HOST_READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__float__",
              "__int__", "__index__")


def _trainer(path, debug_nans, clip=1.0, lr=1e-3):
    _, _, tpacked, tarr = _data()
    trainer = _port_trainer(
        tpacked, {**NAN_PATHS[path], "gradient_clip_norm": clip, "lr": lr},
        profile={"debug_nans": debug_nans})
    assert trainer.path == path
    return trainer, tarr


def _step(trainer, tarr, dense=None):
    return trainer._train_step(tarr.ids, tarr.dense if dense is None
                               else dense, tarr.labels,
                               np.ones(B, np.float32))


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("path", list(NAN_PATHS))
def test_debug_nans_raises_at_the_planted_nan(path):
    trainer, tarr = _trainer(path, True)
    _step(trainer, tarr)
    dense = tarr.dense.copy()
    dense[3, 0] = np.nan
    before = _params(trainer)
    with pytest.raises(FloatingPointError,
                       match=r"non-finite loss and gradients at step 2"):
        _step(trainer, tarr, dense)
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, before[name]), name  # raised before the update
    assert int(trainer.state.step) == 1
    # without the setting the same step goes through, its loss not finite
    plain, _ = _trainer(path, False)
    _step(plain, tarr)
    assert not np.isfinite(float(_step(plain, tarr, dense)))


@pytest.mark.parametrize("path", ["sparse_fused", "lazy"])
def test_debug_nans_raises_after_an_infinite_learning_rate(path):
    trainer, tarr = _trainer(path, True, lr=float("inf"))
    _step(trainer, tarr)  # finite loss and gradients; the update is not
    with pytest.raises(FloatingPointError, match=r"at step 2$"):
        _step(trainer, tarr)


@pytest.mark.parametrize("path,clip", [(p, 1.0) for p in NAN_PATHS]
                         + [("lazy", 0.0), ("plain", 0.0)])
def test_debug_nans_changes_no_bit(path, clip):
    runs = []
    for debug_nans in (False, True):
        trainer, tarr = _trainer(path, debug_nans, clip=clip)
        losses = [float(_step(trainer, tarr)) for _ in range(2)]
        runs.append((losses, trainer.model.state_dict()))
    (l0, s0), (l1, s1) = runs
    assert l0 == l1
    assert s0.keys() == s1.keys()
    for name in s0:
        assert torch.equal(s0[name], s1[name]), name


@pytest.mark.parametrize("path", list(NAN_PATHS))
def test_debug_nans_unset_reads_nothing_back(path, monkeypatch):
    counts = {}

    def counting(name, fn):
        def wrapper(self, *args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(self, *args, **kwargs)
        return wrapper

    reads = {}
    for debug_nans in (False, True):
        trainer, tarr = _trainer(path, debug_nans)
        _step(trainer, tarr)
        counts.clear()
        with monkeypatch.context() as m:
            for name in HOST_READS:
                m.setattr(torch.Tensor, name,
                          counting(name, getattr(torch.Tensor, name)))
            m.setattr(torch, "isfinite",
                      counting("isfinite", torch.isfinite))
            _step(trainer, tarr)
        reads[debug_nans] = dict(counts)
    # set: one isfinite and one read more; unset: the check never runs
    assert reads[True] == {**reads[False], "isfinite": 1,
                           "tolist": reads[False].get("tolist", 0) + 1}
    assert "isfinite" not in reads[False]


def test_jax_debug_nans_raises_on_the_same_fault(tmp_path):
    jpacked, jarr, _, _ = _data()
    config = jax_config({
        "model_name": "deepfm", "output_dir": str(tmp_path),
        "dnn": {"hidden_units": [16, 8], "dropout": 0.0},
        "training": {"batch_size": B, "scheduler": "none",
                     "fused_table_adam": False}})
    trainer = JaxTrainer(jax_create_model("deepfm", jpacked, config),
                         jpacked, config, jarr, jarr, jarr)
    dense = np.array(jarr.dense)
    dense[3, 0] = np.nan
    batch = (jnp.asarray(jarr.ids), jnp.asarray(dense),
             jnp.asarray(jarr.labels), jnp.ones((B,), jnp.float32))
    previous = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            trainer._train_step(trainer.state, *batch)
    finally:
        jax.config.update("jax_debug_nans", previous)
