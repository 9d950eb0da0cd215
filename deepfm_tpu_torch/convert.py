"""Carry a JAX parameter tree, or a whole JAX train state, over to the port.

``params_from_jax`` takes the JAX package's ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays (``jax.device_get`` of the state)
and returns a ``state_dict`` for the port's model of the same config.
Names map 1:1 (the key path joined with dots) except for layout: flax
``Dense`` kernels are ``(in, out)`` and become torch ``(out, in)``
weights, and BatchNorm's ``scale``/``bias`` and ``mean``/``var`` become
``weight``/``bias`` and ``running_mean``/``running_var``. Tables in the
TPU's packed ``(phys, 128)`` layout are unpacked to the port's logical
``(pad128(rows), d+1)`` layout (``unpack_table``, the port's copy of
``deepfm_tpu/utils/layout.py``).

``train_state_from_jax`` carries a JAX ``TrainState`` (step, the dense
Adam moments and count and the learning rate inside the optax state, the
table moments in their dtype, the carried ``table_psq``) into the port's
``Trainer``, so both packages can take the next step from the same state.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.ops.embedding import pad_rows

LANES = 128


def unpack_table(packed: np.ndarray, dcol: int, pack: int,
                 logical_rows: int) -> np.ndarray:
    """(phys, 128) packed storage -> (logical_rows, dcol) logical table:
    logical row r lives in physical row r // pack, lanes
    [(r % pack) * dcol, (r % pack + 1) * dcol)."""
    packed = np.asarray(packed)
    out = np.zeros((logical_rows, dcol), packed.dtype)
    n = min(logical_rows, packed.shape[0] * pack)
    for k in range(pack):
        rows = np.arange(k, n, pack)
        out[rows] = packed[rows // pack, k * dcol : (k + 1) * dcol]
    return out


def _tables(packed_schema: PackedSchema) -> dict[str, dict]:
    """name -> logical and packed geometry of each fused table."""
    out = {}
    for g in packed_schema.lookup_groups:
        dcol = g.width + 1
        pack = LANES // dcol
        out[f"table_w{g.width}"] = {
            "dcol": dcol, "pack": pack,
            "logical": (pad_rows(g.total_rows), dcol),
            "packed": (pad_rows(-(-g.total_rows // pack)), LANES),
        }
    return out


def logical_table(name: str, value: Any,
                  packed_schema: PackedSchema) -> np.ndarray:
    """A table leaf (or a leaf shaped like one, e.g. its Adam moments) in
    the logical layout, unpacked if it is in the packed one. Keeps the
    dtype (bf16 moments stay bf16)."""
    arr = np.asarray(value)
    spec = _tables(packed_schema)[name]
    if arr.shape == spec["logical"]:
        return arr
    if arr.shape == spec["packed"] and spec["pack"] > 1:
        return unpack_table(arr, spec["dcol"], spec["pack"],
                            spec["logical"][0])
    raise ValueError(
        f"embedding/{name} has shape {arr.shape}: neither the logical "
        f"{spec['logical']} nor the packed {spec['packed']} layout"
    )


def _leaves(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _leaves(value, path)
        else:
            yield path, value


def _tensor(value: Any) -> torch.Tensor:
    """A JAX leaf as a torch tensor of the same dtype (bf16 included)."""
    arr = np.array(value)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def torch_name(path: tuple) -> str:
    """The port's parameter name of a JAX params key path."""
    *mods, leaf = path
    if leaf == "kernel":
        leaf = "weight"
    elif leaf == "scale" and mods and mods[-1].startswith("bn_"):
        leaf = "weight"
    return ".".join((*mods, leaf))


def torch_leaf(path: tuple, value: Any,
               packed_schema: PackedSchema) -> tuple[str, torch.Tensor]:
    """(port name, tensor) of one JAX params leaf or of a leaf shaped like
    one (an Adam moment): kernels transposed, tables made logical."""
    if path[0] == "embedding" and path[-1].startswith("table_w"):
        value = logical_table(path[-1], value, packed_schema)
    t = _tensor(value)
    if path[-1] == "kernel" and t.dim() == 2:
        t = t.t().contiguous()
    return torch_name(path), t


def params_from_jax(
    params: Mapping,
    batch_stats: Mapping | None,
    packed_schema: PackedSchema,
    config: ExperimentConfig,
) -> dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` trees -> the port's ``state_dict``
    (any model of the registry: embedding, cin, dnn and the heads)."""
    del config  # the trees carry every name the port needs
    sd = {}
    for path, value in _leaves(params):
        name, t = torch_leaf(path, value, packed_schema)
        sd[name] = t.float()
    for path, value in _leaves(batch_stats or {}):
        *mods, stat = path
        prefix = ".".join(mods)
        sd[f"{prefix}.running_{stat}"] = _tensor(value).float()
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return sd


def _find(obj: Any, fields: tuple[str, ...]) -> Any:
    """The first named tuple of an optax state (nested tuples, named tuples
    and dicts) that has all ``fields``."""
    if set(fields) <= set(getattr(obj, "_fields", ())):
        return obj
    children = (obj.values() if isinstance(obj, Mapping)
                else obj if isinstance(obj, tuple) else ())
    for child in children:
        hit = _find(child, fields)
        if hit is not None:
            return hit
    return None


def _moments(tree: Mapping, packed_schema: PackedSchema,
             device) -> dict[str, torch.Tensor]:
    """A moment tree of optax (MaskedNode leaves dropped) by port name."""
    out = {}
    for path, value in _leaves(tree):
        if not hasattr(value, "shape"):  # optax.MaskedNode: a masked leaf
            continue
        name, t = torch_leaf(path, value, packed_schema)
        out[name] = t.to(device)
    return out


def train_state_from_jax(jax_state: Any, trainer) -> None:
    """Load a JAX ``TrainState`` (``jax.device_get`` of it) into ``trainer``
    (``deepfm_tpu_torch.training.trainer.Trainer``) in place: the model's
    parameters and BatchNorm statistics, the step, the learning rate, the
    dense optimizer's moments and count, the table moments in their dtype
    and the carried ``table_psq``. The two trainers must take the same
    path (both fused, or both the plain chain)."""
    model, packed = trainer.model, trainer.packed_schema
    dev = trainer.device
    model.load_state_dict(params_from_jax(
        jax_state.params, jax_state.batch_stats, packed, trainer.config))
    st = trainer.state
    st.step = torch.tensor(int(np.asarray(jax_state.step)),
                           dtype=torch.int32, device=dev)
    opt = st.opt_state
    hyper = _find(jax_state.opt_state, ("hyperparams",))
    opt.lr = torch.tensor(float(np.asarray(
        hyper.hyperparams["learning_rate"])), dtype=torch.float32, device=dev)
    adam = _find(jax_state.opt_state, ("count", "mu", "nu"))
    if adam is not None:
        opt.count = torch.tensor(int(np.asarray(adam.count)),
                                 dtype=torch.int32, device=dev)
        opt.mu = _moments(adam.mu, packed, dev)
        opt.nu = _moments(adam.nu, packed, dev)
    else:
        trace = _find(jax_state.opt_state, ("trace",))
        opt.mu = _moments(trace.trace, packed, dev)
    if jax_state.table_opt is not None and st.table_opt is not None:
        from deepfm_tpu_torch.training.sparse_opt import TableSlotState

        st.table_opt = {
            f"embedding.{name}": TableSlotState(
                mu=_tensor(logical_table(name, s.mu, packed)).to(dev),
                nu=_tensor(logical_table(name, s.nu, packed)).to(dev),
            )
            for name, s in jax_state.table_opt.items()
        }
    if jax_state.table_psq is not None and st.table_psq is not None:
        st.table_psq = {
            f"embedding.{name}": torch.tensor(
                float(np.asarray(v)), dtype=torch.float32, device=dev)
            for name, v in jax_state.table_psq.items()
        }
