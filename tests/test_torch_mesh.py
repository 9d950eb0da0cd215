"""The port's mesh and runtime (``deepfm_tpu_torch/parallel/mesh.py``)
against the JAX package's, on the CPU.

* ``build_mesh`` / ``build_hybrid_mesh`` over n ranks give the (data,
  model) axes of the JAX functions over n of this process's 8 virtual CPU
  devices (tests/conftest.py), and raise the JAX functions' ValueError
  word for word where they raise; a model axis above 1 places the tables
  "rows over model".
* ``initialize_distributed``'s guard: without a coordinator it returns
  False and leaves the runtime alone (as the JAX function does, probe or
  not); a coordinator named only by the JAX package's variables is
  refused; torchrun's starts a process group with the backend rule's
  backend (``init_process_group`` replaced by a recorder); and a real
  one-rank gloo group starts through a file and yields a mesh of one rank
  whose collectives are identities.
* The backend rule: NCCL when every local rank has a card, gloo when they
  share one or run on the CPU.
* The launch guard: a kernel's tensors off the current CUDA device raise
  (``ops/kernels/build.py::check_current``, the current device patched).
"""

import sys

import jax
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, "tests")

from deepfm_tpu.parallel import mesh as jax_mesh  # noqa: E402
from deepfm_tpu_torch.parallel import (  # noqa: E402
    AXIS_DATA,
    AXIS_MODEL,
    build_hybrid_mesh,
    build_mesh,
    initialize_distributed,
    placement,
)
from deepfm_tpu_torch.parallel import collectives  # noqa: E402
from deepfm_tpu_torch.parallel.mesh import backend_rule  # noqa: E402

torch.set_num_threads(1)

# (data_axis, model_axis, num_slices, n)
CASES = [
    (-1, 1, 1, 1), (1, 1, 1, 1), (-1, 1, 1, 2), (2, 1, 1, 2), (-1, -1, 1, 4),
    (4, 1, 1, 4), (3, 1, 1, 4), (0, 1, 1, 8), (-1, 1, 1, 8), (8, 0, 1, 8),
    (2, 4, 1, 8), (-1, 2, 1, 8), (3, -1, 1, 8), (-1, 16, 1, 8),
    (-1, 1, 2, 8), (8, 1, 2, 8), (4, 1, 2, 8), (-1, 2, 2, 8), (2, 2, 2, 8),
    (-1, 1, 3, 8), (-1, 3, 2, 8), (-1, 1, 4, 4), (-1, 1, 1, 3),
]


def _jax(d, m, s, n):
    devices = jax.devices()[:n]
    try:
        mesh = (jax_mesh.build_hybrid_mesh(s, d, m, devices=devices)
                if s > 1 else jax_mesh.build_mesh(d, m, devices=devices))
    except ValueError as e:
        return str(e)
    return mesh.shape[AXIS_DATA], mesh.shape[AXIS_MODEL]


@pytest.mark.parametrize("d,m,s,n", CASES)
def test_meshes_match_jax(d, m, s, n):
    want = _jax(d, m, s, n)
    try:
        mesh = (build_hybrid_mesh(s, d, m, n=n, device="cpu") if s > 1
                else build_mesh(d, m, n=n, device="cpu"))
    except ValueError as e:
        assert str(e) == want
        return
    assert (mesh.data, mesh.model) == want
    assert mesh.shape == {AXIS_DATA: want[0], AXIS_MODEL: want[1]}
    assert mesh.size == mesh.world == n
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert mesh.device == torch.device("cpu")
    # a mesh of another size than the world's describes a shape: no groups
    assert mesh.data_group is mesh.model_group is mesh.world_group is None
    assert placement(mesh, "dnn.dense_0.weight") == "replicated"
    assert placement(mesh, "embedding.table_w16") == (
        "rows over model" if want[1] > 1 else "replicated")


# (environment, what initialize_distributed does: None = returns False)
ENVS = [
    ({}, None),
    ({"WORLD_SIZE": "1", "RANK": "0", "MASTER_ADDR": "h",
      "MASTER_PORT": "1"}, None),
    ({"TPU_WORKER_HOSTNAMES": "localhost"}, None),
    ({"JAX_COORDINATOR_ADDRESS": "h:1"}, "refused"),
    ({"WORLD_SIZE": "2"}, "refused"),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
      "MASTER_PORT": "29500"}, "started"),
]


@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("env,outcome", ENVS)
def test_initialize_distributed_guard(env, outcome, probe, monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    if outcome == "refused":
        with pytest.raises(RuntimeError, match="torchrun's"):
            initialize_distributed(probe, env=env, device="cpu")
    else:
        started = initialize_distributed(probe, env=env, device="cpu")
        assert started is (outcome == "started")
    assert not dist.is_initialized()
    if outcome == "started":
        (args, kwargs), = calls
        assert args == ("gloo",)
        assert kwargs["init_method"] == "tcp://h:29500"
        assert (kwargs["rank"], kwargs["world_size"]) == (1, 2)
        assert kwargs["timeout"].total_seconds() > 0
    else:
        assert not calls


def test_a_one_rank_group_gives_a_mesh_of_one(tmp_path):
    assert not dist.is_initialized()
    try:
        assert initialize_distributed(
            env={}, device="cpu", init_method=f"file://{tmp_path}/store",
            rank=0, world_size=1)
        assert initialize_distributed(env={}, device="cpu")  # already up
        mesh = build_mesh(device="cpu")
        assert (mesh.data, mesh.model, mesh.rank, mesh.world) == (1, 1, 0, 1)
        assert mesh.backend == "gloo"
        t = torch.arange(6.0).reshape(3, 2)
        assert collectives.all_gather_rows(mesh, t) is t
        assert collectives.all_reduce_(mesh, t) is t
        assert collectives.all_reduce_sum(mesh, t) is t
        collectives.barrier(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("device,local,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 4, "gloo"), ("cuda", 2, 1, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 8, "nccl"),
])
def test_backend_rule(device, local, cards, backend):
    got, why = backend_rule(device, local, cards)
    assert got == backend
    if backend == "gloo" and device == "cuda":
        assert "NCCL refuses two ranks on one device" in why


@pytest.mark.parametrize("current,index", [(0, 0), (1, 1), (0, 1), (1, 0)])
def test_a_kernel_launch_off_the_current_device_raises(current, index,
                                                        monkeypatch):
    """Every kernel wrapper asks ``build.check_current`` (directly, or
    through ``build.launch_device``) before it launches: tensors on
    another card than the rank's current one raise."""
    from deepfm_tpu_torch.ops.kernels import build

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    if current == index:
        build.check_current(index)
    else:
        with pytest.raises(RuntimeError, match=(
                f"a kernel's tensors are on cuda:{index}, but this "
                f"process's current device is cuda:{current}")):
            build.check_current(index)
