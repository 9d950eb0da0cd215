"""The distributed runtime and the device mesh, on ``torch.distributed``.

Port of ``deepfm_tpu/parallel/mesh.py`` (``initialize_distributed``,
``build_mesh``, ``build_hybrid_mesh``, ``AXIS_DATA`` / ``AXIS_MODEL``) and
of ``deepfm_tpu/cli.py``'s ``maybe_init_multihost`` and ``build_runtime``
(``resolve_mesh``, ``check_multihost``).

The JAX package runs one process per host and a mesh over every device
it sees; the port runs one process per device (a rank), launched by
``python -m torch.distributed.run --nproc-per-node N``, which names the
coordinator in each rank's environment: ``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``. ``initialize_distributed``
starts the process group from there. A ``Mesh`` is a small record of the
(data, model) axes over the ranks and of this rank's place in them; the
collectives that act on it are ``parallel/collectives.py``'s.

The mesh is the JAX package's ``(data, model)`` grid over the ranks
(ROADMAP queue 1 items 10(a) and 10(b)), model the inner axis
(``mesh_utils.create_device_mesh((dp, m))``): rank r sits at data index
``r // m`` and model index ``r % m``. The m ranks of one data row hold the
same batch rows and run the same dense computation on them; the m ranks of
one model column hold the same slab of every embedding table
(``parallel/sharding.py``). Each rank's ``Mesh`` carries the ``Group`` of
its data row (``model_group``: the ranks that share its rows and hold the
other slabs), of its model column (``data_group``: the ranks that hold its
slab, over which the batch is split) and of the world; a group of one rank
is None, so that no collective runs on it (``parallel/collectives.py``).

The backend rule: NCCL when every local rank has a card of its own; gloo
when the local ranks share a card (NCCL refuses two ranks on one device)
or run on the CPU (``parallel/collectives.py`` says which tensors each
backend takes). Rank 0 logs the rule it applied.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Mapping

import torch

from deepfm_tpu_torch.config import ExperimentConfig

logger = logging.getLogger("deepfm_tpu_torch")

AXIS_DATA = "data"
AXIS_MODEL = "model"

# environment variables that name a coordinator (``_multiprocess_env_
# configured`` of the JAX package), plus torchrun's WORLD_SIZE > 1
COORDINATOR_ENV = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "OMPI_MCA_orte_hnp_uri",
)
# what torchrun sets for every rank, and what the port starts from
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
# how long the rendezvous and each collective may wait for the other
# ranks before the rank raises
TIMEOUT_S = 600
# the running process group's timeout, which the mesh's groups take
_TIMEOUT_S: list[float | None] = [None]


@dataclass(frozen=True)
class Group:
    """Ranks that take part in one collective: ``ranks`` in the order the
    collective concatenates them, this process's global ``rank`` at
    position ``index`` of them, and the process group's ``handle`` (None:
    the default group, which spans the world). ``backend`` and ``device``
    are the mesh's."""

    ranks: tuple[int, ...]
    rank: int
    index: int
    handle: Any
    backend: str
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh over the ranks and this rank's place in it:
    ``world`` ranks, this one ``rank`` (``local_rank`` on its host) on
    ``device``; ``backend`` is the process group's ("nccl" or "gloo"; None
    for a mesh of one rank without a process group). The groups
    (``Group``, None where they hold one rank or the mesh only describes
    a shape): ``world_group``, ``data_group`` (this rank's model column:
    its slab's holders, the batch split over them) and ``model_group``
    (its data row: its batch rows' holders, one slab each)."""

    data: int
    model: int
    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str | None
    world_group: Group | None = None
    data_group: Group | None = None
    model_group: Group | None = None

    @property
    def shape(self) -> dict[str, int]:
        """{"data": ..., "model": ...}, as a JAX mesh's ``shape``."""
        return {AXIS_DATA: self.data, AXIS_MODEL: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        """This rank's row of the mesh: which share of the batch it takes."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's column of the mesh: which slab of the tables it
        holds."""
        return self.rank % self.model


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
    """(data, model) of ``build_hybrid_mesh``: the model axis stays inside
    one slice and the data axis spans them (with one slice, the JAX
    function checks its own arithmetic before it calls ``build_mesh``)."""
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


def backend_rule(device_type: str, local_world: int,
                 cards: int) -> tuple[str, str]:
    """(backend, why) for ``local_world`` ranks on a host with ``cards``
    cards: NCCL when every local rank has a card of its own, gloo when
    they share one or run on the CPU."""
    if device_type != "cuda":
        return "gloo", "the ranks run on the CPU"
    if cards >= local_world:
        return "nccl", (f"each of the {local_world} local ranks has a card "
                        f"of its own ({cards} cards)")
    return "gloo", (f"{local_world} local ranks share {cards} card(s), and "
                    "NCCL refuses two ranks on one device")


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of local rank ``local_rank``: the CPU when ``device``
    is the CPU, else ``cuda:(local_rank % device_count)``."""
    from deepfm_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(probe: bool = False, *,
                           env: Mapping[str, str] | None = None,
                           device: str | torch.device = "cuda",
                           init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None,
                           timeout_s: float = TIMEOUT_S) -> bool:
    """Start this rank's process group; True when it runs (or already
    ran), False when nothing names a coordinator.

    With no explicit ``init_method`` (plus ``rank`` and ``world_size``)
    and no coordinator in ``env`` (``multiprocess_env_configured``), the
    runtime is not touched and the call returns False: the JAX package's
    guard, which never waits for a coordinator that does not exist. The
    JAX ``probe`` asks a TPU pod's metadata server for one; a GPU host has
    none (torchrun names the coordinator in each rank's environment), so
    ``probe`` changes nothing here. Otherwise the coordinator is torchrun's
    (``TORCHRUN_ENV``; a coordinator named only by the JAX package's
    variables is refused, since torch cannot start from them), the rank
    takes its device (``rank_device``, set as the current CUDA device
    before anything launches) and the process group starts with
    ``backend_rule``'s backend. The rendezvous and every collective wait
    at most ``timeout_s`` for the other ranks, then raise.
    """
    import torch.distributed as dist

    del probe  # no metadata server to ask (see above)
    env = os.environ if env is None else env
    if dist.is_initialized():
        return True
    if init_method is None:
        if not multiprocess_env_configured(env):
            return False
        missing = [k for k in TORCHRUN_ENV if not env.get(k)]
        if missing:
            raise RuntimeError(
                "the environment names a coordinator, but not torchrun's "
                f"{'/'.join(missing)}: launch the ranks with python -m "
                "torch.distributed.run (the port runs one process per "
                "device)")
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    if rank is None or world_size is None:
        raise ValueError("an explicit init_method needs rank and world_size")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(device, local_rank)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend, why = backend_rule(dev.type, local_world, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    _TIMEOUT_S[0] = timeout_s
    if rank == 0:
        logger.info("torch.distributed: %d ranks, backend %s (%s)",
                    world_size, backend, why)
    return True


def group_timeout_s() -> float:
    """How long a collective of the running process group waits for the
    other ranks before it raises: ``TIMEOUT_S``, or what the group was
    started with."""
    return _TIMEOUT_S[0] or TIMEOUT_S


def world_size() -> int:
    """The number of ranks (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_groups(data: int, model: int, rank: int, backend: str,
                device: torch.device,
                timeout_s: float | None = None) -> dict[str, Group | None]:
    """The world, data and model ``Group`` of ``rank`` on a (data, model)
    mesh of the running process group. Every rank creates the process
    group of every data row, then of every model column, in that order
    (``dist.new_group`` must be called by every rank, for every group);
    a group that spans the world takes the default group, and a group of
    one rank is None."""
    import torch.distributed as dist

    world = data * model
    rows = [tuple(range(i * model, (i + 1) * model)) for i in range(data)]
    cols = [tuple(range(j, world, model)) for j in range(model)]
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    handles = {}
    for ranks in rows + cols:
        if 1 < len(ranks) < world:
            handles[ranks] = dist.new_group(list(ranks), **kw)

    def group(ranks):
        if len(ranks) == 1:
            return None
        return Group(ranks=ranks, rank=rank, index=ranks.index(rank),
                     handle=handles.get(ranks), backend=backend,
                     device=device)

    return {"world_group": group(tuple(range(world))),
            "data_group": group(cols[rank % model]),
            "model_group": group(rows[rank // model])}


def _mesh(data: int, model: int, n: int | None,
          device: str | torch.device) -> Mesh:
    import torch.distributed as dist

    up = dist.is_initialized()
    rank = dist.get_rank() if up else 0
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    world = world_size() if n is None else n
    dev = rank_device(device, local_rank)
    backend = dist.get_backend() if up else None
    groups = {}
    if up and world == world_size():
        groups = mesh_groups(data, model, rank, backend, dev, _TIMEOUT_S[0])
    return Mesh(data=data, model=model, rank=rank, world=world,
                local_rank=local_rank, device=dev, backend=backend,
                **groups)


def build_mesh(data_axis: int = -1, model_axis: int = 1,
               n: int | None = None,
               device: str | torch.device = "cuda") -> Mesh:
    """The ("data", "model") mesh over ``n`` ranks (default: the world
    size): an axis of -1 takes the ranks left over, and the product must
    be ``n`` (``mesh_shape``, the JAX function's words). ``device`` is the
    config's; the rank takes its own card of it (``rank_device``). Every
    rank must build the mesh, since it creates the process groups of the
    mesh's rows and columns (``mesh_groups``). A mesh over another ``n``
    than the world's describes a shape only: it has no groups, and no
    collective may run on it."""
    data, model = mesh_shape(data_axis, model_axis,
                             world_size() if n is None else n)
    return _mesh(data, model, n, device)


def build_hybrid_mesh(num_slices: int, data_axis: int = -1,
                      model_axis: int = 1, n: int | None = None,
                      device: str | torch.device = "cuda") -> Mesh:
    """``build_mesh`` over ``num_slices`` host groups
    (``hybrid_mesh_shape``): the data axis spans them, slice index
    outermost, which is the rank order torchrun gives."""
    data, model = hybrid_mesh_shape(num_slices, data_axis, model_axis,
                                    world_size() if n is None else n)
    return _mesh(data, model, n, device)


def check_multihost(config: ExperimentConfig,
                    env: Mapping[str, str]) -> bool:
    """``maybe_init_multihost``: True when the process group runs.

    ``mesh.multihost: false`` does nothing here (a torchrun launch still
    starts, ``cli.build_runtime``). With ``multihost: true`` a coordinator
    in ``env`` starts the process group (``initialize_distributed``), and
    no coordinator is refused with the JAX package's message unless
    ``mesh.allow_single_process``, which logs its warning and goes on.
    """
    if not config.mesh.multihost:
        return False
    if initialize_distributed(probe=True, env=env, device=config.device):
        return True
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
    return False
