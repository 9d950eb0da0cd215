"""Carry a JAX parameter tree, or a whole JAX train state, over to the port.

``params_from_jax`` takes the JAX package's ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays (``jax.device_get`` of the state)
and returns a ``state_dict`` for the port's model of the same config.
Names map 1:1 (the key path joined with dots) except for layout: flax
``Dense`` kernels are ``(in, out)`` and become torch ``(out, in)``
weights, and BatchNorm's ``scale``/``bias`` and ``mean``/``var`` become
``weight``/``bias`` and ``running_mean``/``running_var``. Embedding tables
(and leaves shaped like them: their Adam moments) come out in the layout of
the port's model, packed ``(phys, 128)`` or logical ``(pad128(rows), d+1)``
(``models.tables_packed``), and are converted only where the JAX tree holds
the other one (``utils/layout.py``): a packed JAX table stays packed.

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
from deepfm_tpu_torch.models import tables_packed
from deepfm_tpu_torch.utils.layout import (
    pack_table,
    table_specs,
    unpack_table,
)

__all__ = [
    "layout_table",
    "logical_table",
    "params_from_jax",
    "torch_leaf",
    "torch_name",
    "train_state_from_jax",
    "unpack_table",
]


def layout_table(name: str, value: Any, packed_schema: PackedSchema,
                 to_packed: bool) -> np.ndarray:
    """A table leaf (or a leaf shaped like one, e.g. its Adam moments) in
    the packed layout (``to_packed``) or the logical one, converted if it
    is in the other. Keeps the dtype (bf16 moments stay bf16). A table too
    wide to pack (128 // (d+1) == 1) has one layout."""
    arr = np.asarray(value)
    spec = table_specs(packed_schema)[name]
    logical, packed = spec["logical_shape"], spec["packed_shape"]
    if spec["pack"] <= 1 and arr.shape == logical:
        return arr
    if arr.shape == (packed if to_packed else logical):
        return arr
    if arr.shape == logical:
        return pack_table(arr, spec["dcol"], spec["pack"], packed[0])
    if arr.shape == packed:
        return unpack_table(arr, spec["dcol"], spec["pack"], logical[0])
    raise ValueError(
        f"embedding/{name} has shape {arr.shape}: neither the logical "
        f"{logical} nor the packed {packed} layout"
    )


def logical_table(name: str, value: Any,
                  packed_schema: PackedSchema) -> np.ndarray:
    """``layout_table`` into the logical layout."""
    return layout_table(name, value, packed_schema, to_packed=False)


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


def torch_leaf(path: tuple, value: Any, packed_schema: PackedSchema,
               to_packed: bool = False) -> tuple[str, torch.Tensor]:
    """(port name, tensor) of one JAX params leaf or of a leaf shaped like
    one (an Adam moment): kernels transposed, tables in the packed
    (``to_packed``) or the logical layout."""
    if path[0] == "embedding" and path[-1].startswith("table_w"):
        value = layout_table(path[-1], value, packed_schema, to_packed)
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
    (any model of the registry: embedding, cin, dnn and the heads), its
    tables in the layout the port's ``create_model`` builds for
    ``config``."""
    to_packed = config is not None and tables_packed(config)
    sd = {}
    for path, value in _leaves(params):
        name, t = torch_leaf(path, value, packed_schema, to_packed)
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


def _moments(tree: Mapping, packed_schema: PackedSchema, device,
             to_packed: bool) -> dict[str, torch.Tensor]:
    """A moment tree of optax (MaskedNode leaves dropped) by port name."""
    out = {}
    for path, value in _leaves(tree):
        if not hasattr(value, "shape"):  # optax.MaskedNode: a masked leaf
            continue
        name, t = torch_leaf(path, value, packed_schema, to_packed)
        out[name] = t.to(device)
    return out


def train_state_from_jax(jax_state: Any, trainer) -> None:
    """Load a JAX ``TrainState`` (``jax.device_get`` of it) into ``trainer``
    (``deepfm_tpu_torch.training.trainer.Trainer``) in place: the model's
    parameters and BatchNorm statistics, the step, the learning rate, the
    dense optimizer's moments and count, the table moments in their dtype
    and the carried ``table_psq``, every table-shaped leaf in the layout of
    the trainer's model. The two trainers must take the same path (both
    fused, or both the plain chain)."""
    model, packed = trainer.model, trainer.packed_schema
    dev = trainer.device
    to_packed = model.table_layout == "packed"
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
        opt.mu = _moments(adam.mu, packed, dev, to_packed)
        opt.nu = _moments(adam.nu, packed, dev, to_packed)
    else:
        trace = _find(jax_state.opt_state, ("trace",))
        opt.mu = _moments(trace.trace, packed, dev, to_packed)
    if jax_state.table_opt is not None and st.table_opt is not None:
        from deepfm_tpu_torch.training.sparse_opt import TableSlotState

        st.table_opt = {
            f"embedding.{name}": TableSlotState(
                mu=_tensor(layout_table(name, s.mu, packed, to_packed)).to(dev),
                nu=_tensor(layout_table(name, s.nu, packed, to_packed)).to(dev),
            )
            for name, s in jax_state.table_opt.items()
        }
    if jax_state.table_psq is not None and st.table_psq is not None:
        st.table_psq = {
            f"embedding.{name}": torch.tensor(
                float(np.asarray(v)), dtype=torch.float32, device=dev)
            for name, v in jax_state.table_psq.items()
        }
