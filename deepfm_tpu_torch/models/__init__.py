"""CTR model registry and factory (port of ``deepfm_tpu/models/__init__.py``).

This slice serves xDeepFM. The other models of the JAX registry come with
later slices; asking for one raises and names the slice.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.config import ConfigError, ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.models.xdeepfm import xDeepFM

MODEL_REGISTRY: dict[str, type[CTRModel]] = {"xdeepfm": xDeepFM}

# models of the JAX registry that are not ported yet -> the slice that
# brings each one
LATER_SLICES = {
    "deepfm": "the DeepFM training slice",
    "attention_deepfm": "the AttentionDeepFM slice",
    "lr": "the baselines slice",
    "fm": "the baselines slice",
    "dnn": "the baselines slice",
}


def resolve_table_layout(config: ExperimentConfig) -> bool:
    """Resolve ``pallas.table_layout``; returns False (logical), the only
    layout of the port. "auto" means logical: the JAX package resolves it
    through its backend, and the port has no JAX backend to ask."""
    layout = config.pallas.table_layout
    if layout not in ("auto", "packed", "logical"):
        raise ConfigError(
            f"pallas.table_layout must be auto|packed|logical, got {layout!r}"
        )
    if layout == "packed":
        raise NotImplementedError(
            "pallas.table_layout=packed is not ported yet: the packed table "
            "layout comes with the packed-densify kernel in a later slice; "
            "use auto or logical"
        )
    return False


def create_model(
    name: str,
    schema: DatasetSchema | PackedSchema,
    config: ExperimentConfig,
    device: str | torch.device = "cuda",
    seed: int | None = None,
) -> CTRModel:
    """Instantiate a model by registry name, initialised from ``seed``
    (default ``config.seed``) and moved to ``device``."""
    if name not in MODEL_REGISTRY:
        if name in LATER_SLICES:
            raise NotImplementedError(
                f"model {name!r} is not ported yet: it comes with "
                f"{LATER_SLICES[name]}"
            )
        raise ValueError(
            f"Unknown model: {name}. Choose from {list(MODEL_REGISTRY)}"
        )
    dev = resolve_device(device)
    packed = schema if isinstance(schema, PackedSchema) else pack_schema(schema)
    resolve_table_layout(config)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    return MODEL_REGISTRY[name](packed, config, generator=gen).to(dev)


__all__ = [
    "CTRModel",
    "MODEL_REGISTRY",
    "create_model",
    "resolve_table_layout",
    "xDeepFM",
]
