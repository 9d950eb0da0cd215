"""CTR model registry and factory (port of ``deepfm_tpu/models/__init__.py``).

The port has every model of the JAX registry: DeepFM, xDeepFM and
AttentionDeepFM, and the ablation baselines ``lr``, ``fm`` and ``dnn``
(``models/baselines.py``), each trained by ``training/trainer.py`` and
served by ``serving.py``.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.config import ConfigError, ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.models.attention_deepfm import AttentionDeepFM
from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.models.baselines import DNNOnly, FM, LogisticRegression
from deepfm_tpu_torch.models.deepfm import DeepFM
from deepfm_tpu_torch.models.xdeepfm import xDeepFM

MODEL_REGISTRY: dict[str, type[CTRModel]] = {
    "deepfm": DeepFM,
    "xdeepfm": xDeepFM,
    "attention_deepfm": AttentionDeepFM,
    # ablation baselines (models/baselines.py)
    "lr": LogisticRegression,
    "fm": FM,
    "dnn": DNNOnly,
}


def resolve_table_layout(config: ExperimentConfig) -> bool:
    """Resolve ``pallas.table_layout`` to packed (True) or logical. "auto"
    means logical: the JAX package asks its backend and packs only on a
    TPU, and the port has no TPU to ask. "packed" and "logical" are honored
    on every device, so a config fully determines the parameter shapes."""
    layout = config.pallas.table_layout
    if layout not in ("auto", "packed", "logical"):
        raise ConfigError(
            f"pallas.table_layout must be auto|packed|logical, got {layout!r}"
        )
    return layout == "packed"


def tables_packed(config: ExperimentConfig) -> bool:
    """The layout ``create_model`` builds: packed when the config asks for
    it, unless ``pallas.use_embedding_kernel`` installs the row-gather
    kernel, which forces logical tables (``create_model`` of the JAX
    package)."""
    return (resolve_table_layout(config)
            and not config.pallas.use_embedding_kernel)


def create_model(
    name: str,
    schema: DatasetSchema | PackedSchema,
    config: ExperimentConfig,
    device: str | torch.device = "cuda",
    seed: int | None = None,
) -> CTRModel:
    """Instantiate a model by registry name, initialised from ``seed``
    (default ``config.seed``) and moved to ``device``. The tables' layout
    and lookup follow ``tables_packed`` and
    ``pallas.use_embedding_kernel``."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model: {name}. Choose from {list(MODEL_REGISTRY)}"
        )
    dev = resolve_device(device)
    packed = schema if isinstance(schema, PackedSchema) else pack_schema(schema)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    return MODEL_REGISTRY[name](
        packed, config, generator=gen, packed_tables=tables_packed(config),
        gather_kernel=config.pallas.use_embedding_kernel,
    ).to(dev)


__all__ = [
    "AttentionDeepFM",
    "CTRModel",
    "DNNOnly",
    "DeepFM",
    "FM",
    "LogisticRegression",
    "MODEL_REGISTRY",
    "create_model",
    "resolve_table_layout",
    "tables_packed",
    "xDeepFM",
]
