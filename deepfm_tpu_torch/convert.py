"""Carry a JAX parameter tree over to the port's modules.

``params_from_jax`` takes the JAX package's ``params`` and ``batch_stats``
trees as nested dicts of numpy arrays (``jax.device_get`` of the trained
state) and returns a ``state_dict`` for the port's model of the same
config. Names map 1:1 except for layout: flax ``Dense`` kernels are
``(in, out)`` and become torch ``(out, in)`` weights, and BatchNorm's
``scale``/``bias`` and ``mean``/``var`` become ``weight``/``bias`` and
``running_mean``/``running_var``. Only the logical table layout is
supported; packed ``(phys, 128)`` tables raise.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.ops.embedding import pad_rows


def _t(x: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _embedding(emb: Mapping, packed: PackedSchema) -> dict[str, torch.Tensor]:
    out = {}
    widths = {g.width: g for g in packed.lookup_groups}
    for name, value in emb.items():
        arr = np.asarray(value)
        if name.startswith("table_w"):
            group = widths[int(name[len("table_w"):])]
            logical = (pad_rows(group.total_rows), group.width + 1)
            if arr.shape != logical:
                raise NotImplementedError(
                    f"embedding/{name} has shape {arr.shape}, not the logical "
                    f"{logical}: packed-layout tables are not ported yet "
                    "(restore them with pallas.table_layout=logical)"
                )
        out[f"embedding.{name}"] = _t(arr)
    return out


def _dense(prefix: str, layer: Mapping) -> dict[str, torch.Tensor]:
    return {
        f"{prefix}.weight": _t(layer["kernel"]).t().contiguous(),
        f"{prefix}.bias": _t(layer["bias"]),
    }


def params_from_jax(
    params: Mapping,
    batch_stats: Mapping | None,
    packed_schema: PackedSchema,
    config: ExperimentConfig,
) -> dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` trees -> the port's ``state_dict``
    (only xDeepFM's sub-trees: embedding, cin, dnn, cin_linear,
    dnn_linear)."""
    sd = _embedding(params["embedding"], packed_schema)
    for name, value in params.get("cin", {}).items():
        sd[f"cin.{name}"] = _t(value)
    stats = (batch_stats or {}).get("dnn", {})
    n_dnn = len(config.dnn.hidden_units) if "dnn" in params else 0
    for i in range(n_dnn):
        sd.update(_dense(f"dnn.dense_{i}", params["dnn"][f"dense_{i}"]))
        if config.dnn.use_batch_norm:
            bn = params["dnn"][f"bn_{i}"]
            sd[f"dnn.bn_{i}.weight"] = _t(bn["scale"])
            sd[f"dnn.bn_{i}.bias"] = _t(bn["bias"])
            sd[f"dnn.bn_{i}.running_mean"] = _t(stats[f"bn_{i}"]["mean"])
            sd[f"dnn.bn_{i}.running_var"] = _t(stats[f"bn_{i}"]["var"])
            sd[f"dnn.bn_{i}.num_batches_tracked"] = torch.tensor(0)
    for head in ("cin_linear", "dnn_linear"):
        if head in params:
            sd.update(_dense(head, params[head]))
    return sd
