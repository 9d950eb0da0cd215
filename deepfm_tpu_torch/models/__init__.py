"""CTR model registry and factory (port of ``deepfm_tpu/models/__init__.py``).

The port has every model of the JAX registry: DeepFM, xDeepFM and
AttentionDeepFM, and the ablation baselines ``lr``, ``fm`` and ``dnn``
(``models/baselines.py``), each trained by ``training/trainer.py`` and
served by ``serving.py``; and one of its own, ``autoint``
(``models/autoint.py``), trained by the same ``Trainer`` and scored by
``Predictor``.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.config import ConfigError, ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.models.attention_deepfm import AttentionDeepFM
from deepfm_tpu_torch.models.autoint import AutoInt
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
    # the port's own (not in the JAX package)
    "autoint": AutoInt,
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


def tables_packed(config: ExperimentConfig, mesh=None) -> bool:
    """The layout ``create_model`` builds: packed when the config asks for
    it, unless ``pallas.use_embedding_kernel`` installs the row-gather
    kernel, which forces logical tables (``create_model`` of the JAX
    package), or a model-sharded ``mesh`` takes ``embedding_strategy:
    auto``, which the JAX package runs on logical tables (GSPMD cannot
    split the packed gather: ``parallel.sharding.slabs_without_exchange``)."""
    from deepfm_tpu_torch.parallel.sharding import slabs_without_exchange

    if slabs_without_exchange(mesh, config.mesh.embedding_strategy):
        return False
    return (resolve_table_layout(config)
            and not config.pallas.use_embedding_kernel)


def create_model(
    name: str,
    schema: DatasetSchema | PackedSchema,
    config: ExperimentConfig,
    device: str | torch.device = "cuda",
    seed: int | None = None,
    mesh=None,
) -> CTRModel:
    """Instantiate a model by registry name, initialised from ``seed``
    (default ``config.seed``) and moved to ``device``. The tables' layout
    and lookup follow ``tables_packed`` and
    ``pallas.use_embedding_kernel``.

    Under a ``mesh`` (``parallel.Mesh``) the model goes to the rank's
    device, ``mesh.device``. At a model axis of 1 the paths that look the
    tables up inside the loss graph (two-pass, lazy, plain) get the sparse
    gradient exchange around that lookup for ``mesh.embedding_strategy``
    (``parallel/embedding_shard.py``; "auto" keeps the plain lookup, whose
    dense gradient the step all-reduces); the sparse-fused path gathers
    the pairs itself and keeps the default lookup, as in the JAX package.
    Above 1 the model is built whole from the seed, exactly as one process
    builds it, every rank's whole parameters are checked to hold the same
    bits, and each rank keeps its slab of every table
    (``FeatureEmbedding.shard_tables``) and takes the strategy's lookup on
    every path."""
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model: {name}. Choose from {list(MODEL_REGISTRY)}"
        )
    dev = mesh.device if mesh is not None else resolve_device(device)
    packed = schema if isinstance(schema, PackedSchema) else pack_schema(schema)
    gen = torch.Generator().manual_seed(config.seed if seed is None else seed)
    model = MODEL_REGISTRY[name](
        packed, config, generator=gen,
        packed_tables=tables_packed(config, mesh),
        gather_kernel=config.pallas.use_embedding_kernel,
    )
    from deepfm_tpu_torch.parallel.sharding import check_replicated, sharded
    from deepfm_tpu_torch.training.trainer import sparse_fused_eligible

    model = model.to(dev)
    if sharded(mesh):
        # fingerprinted on the rank's device: a CPU hash of bench.py's
        # 10.4M-row table takes seconds
        check_replicated(mesh, dict(model.named_parameters()),
                         "the whole parameters built from the seed")
        model.embedding.shard_tables(mesh)
    if mesh is not None and (sharded(mesh)
                             or not sparse_fused_eligible(config, packed)):
        from deepfm_tpu_torch.parallel import (
            make_lookup_fn,
            make_packed_lookup_factory,
        )

        strategy = config.mesh.embedding_strategy
        model.embedding.install_lookups(
            make_lookup_fn(mesh, strategy,
                           config.pallas.use_embedding_kernel),
            make_packed_lookup_factory(mesh, strategy))
    return model


__all__ = [
    "AttentionDeepFM",
    "AutoInt",
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
