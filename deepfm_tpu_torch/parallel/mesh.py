"""Resolution of the ``mesh`` config section, without a runtime.

The port's copy of the resolution half of ``deepfm_tpu/parallel/mesh.py``
(``build_mesh`` and ``build_hybrid_mesh``: their axis arithmetic and their
refusals, with the JAX package's words) and of ``deepfm_tpu/cli.py``'s
``build_runtime`` (one device and a model axis of 1 or -1 need no mesh)
and ``maybe_init_multihost``. Nothing here starts ``torch.distributed``:
the port drives one device until ROADMAP queue 1 item 10 adds the
multi-device runtime on top of these functions. So the CLI resolves the
mesh for one device, and a config that asks for more is refused by the
JAX package's own rule rather than trained on one card without a word.
"""

from __future__ import annotations

import logging
from typing import Mapping

from deepfm_tpu_torch.config import ExperimentConfig

logger = logging.getLogger("deepfm_tpu_torch")

# environment variables that name a coordinator (``_multiprocess_env_
# configured`` of the JAX package), plus torchrun's WORLD_SIZE > 1
COORDINATOR_ENV = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "OMPI_MCA_orte_hnp_uri",
)


def mesh_shape(data_axis: int, model_axis: int, n: int) -> tuple[int, int]:
    """(data, model) of ``build_mesh`` over ``n`` devices: an axis of -1 (or
    any size <= 0) takes the devices left over; the product must be
    ``n``."""
    if model_axis <= 0 and data_axis <= 0:
        data_axis, model_axis = n, 1
    elif model_axis <= 0:
        model_axis = n // data_axis
    elif data_axis <= 0:
        data_axis = n // model_axis
    if data_axis * model_axis != n:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} != {n} available devices"
        )
    return data_axis, model_axis


def hybrid_mesh_shape(num_slices: int, data_axis: int, model_axis: int,
                      n: int) -> tuple[int, int]:
    """(data, model) of ``build_hybrid_mesh`` for ``num_slices`` > 1 (one
    slice is ``mesh_shape``'s): the model axis stays inside one slice and
    the data axis spans them."""
    if n % num_slices != 0:
        raise ValueError(f"{n} devices not divisible by {num_slices} slices")
    per_slice = n // num_slices
    if model_axis <= 0:
        model_axis = 1
    if per_slice % model_axis != 0:
        raise ValueError(
            f"per-slice device count {per_slice} not divisible by "
            f"model axis {model_axis} (the model axis cannot span DCN)"
        )
    ici_data = per_slice // model_axis
    if data_axis > 0 and data_axis != ici_data * num_slices:
        raise ValueError(
            f"mesh {data_axis}x{model_axis} != {n} devices over "
            f"{num_slices} slices"
        )
    return ici_data * num_slices, model_axis


def resolve_mesh(config: ExperimentConfig,
                 n_devices: int) -> tuple[int, int] | None:
    """The (data, model) mesh ``config.mesh`` asks for on ``n_devices``
    devices, or None for a single device without a mesh (``build_runtime``:
    one device and a model axis of 1 or -1, whatever the data axis says).
    Raises ``ValueError`` where ``build_mesh`` / ``build_hybrid_mesh``
    would."""
    m = config.mesh
    if n_devices == 1 and m.model_axis in (1, -1):
        return None
    if m.num_slices > 1:
        return hybrid_mesh_shape(m.num_slices, m.data_axis, m.model_axis,
                                 n_devices)
    return mesh_shape(m.data_axis, m.model_axis, n_devices)


def multiprocess_env_configured(env: Mapping[str, str]) -> bool:
    """True when ``env`` names a coordinator: one of ``COORDINATOR_ENV``,
    two or more TPU worker hosts, more than one SLURM node (the JAX
    package's signals), or torchrun's ``WORLD_SIZE`` above 1."""
    if any(env.get(name) for name in COORDINATOR_ENV):
        return True
    hosts = env.get("TPU_WORKER_HOSTNAMES", "")
    if len([h for h in hosts.split(",") if h.strip()]) > 1:
        return True
    for name in ("SLURM_JOB_NUM_NODES", "WORLD_SIZE"):
        try:
            if int(env.get(name, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def check_multihost(config: ExperimentConfig, env: Mapping[str, str]) -> None:
    """``maybe_init_multihost`` without a runtime to start.

    ``mesh.multihost: false`` does nothing. With ``multihost: true``, a
    coordinator in ``env`` is refused (the port has no multi-process
    runtime until ROADMAP queue 1 item 10), and no coordinator is refused
    with the JAX package's message unless ``mesh.allow_single_process``,
    which logs its warning and goes on. There is no probe of a TPU
    metadata server.
    """
    if not config.mesh.multihost:
        return
    if multiprocess_env_configured(env):
        raise RuntimeError(
            "mesh.multihost=true and the environment names a coordinator, "
            "but the port runs one process on one device: the multi-process "
            "runtime waits for ROADMAP queue 1 item 10"
        )
    if not config.mesh.allow_single_process:
        raise RuntimeError(
            "mesh.multihost=true but no coordinator could be found (no "
            "coordinator env vars). Refusing the silent single-process "
            "fallback — set mesh.allow_single_process=true to run anyway."
        )
    logger.warning(
        "mesh.multihost=true but no coordinator is configured; "
        "running single-process (mesh.allow_single_process=true)"
    )
