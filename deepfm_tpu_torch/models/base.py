"""Base CTR model: shared embedding engine + model-specific heads.

Port of ``deepfm_tpu/models/base.py``: a shared ``FeatureEmbedding``
produces the three views, subclasses combine them into a raw logit
(B, 1), cast to f32; ``predict`` takes its sigmoid.
"""

from __future__ import annotations

import torch
from torch import nn

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.ops.embedding import FeatureEmbedding
from deepfm_tpu_torch.training.optim import leaf_order


def compute_dtype_of(config: ExperimentConfig) -> torch.dtype:
    if config.training.compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


class CTRModel(nn.Module):
    """Base class: embedding -> subclass heads -> raw logit (B, 1).
    ``packed_tables`` and ``gather_kernel`` are the embedding's table layout
    and lookup, as ``create_model`` resolves them from the config."""

    def __init__(
        self,
        packed: PackedSchema,
        config: ExperimentConfig,
        generator: torch.Generator | None = None,
        packed_tables: bool = False,
        gather_kernel: bool = False,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.packed = packed
        self.config = config
        self.embedding = FeatureEmbedding(
            packed,
            fm_embed_dim=config.feature.fm_embed_dim,
            compute_dtype=compute_dtype_of(config),
            generator=g,
            packed_tables=packed_tables,
            gather_kernel=gather_kernel,
        )
        self._build_components(g)

    @property
    def table_layout(self) -> str:
        """"packed" or "logical": the layout a checkpoint of this model
        records (``Trainer._table_layout`` of the JAX package)."""
        return "packed" if self.embedding.packed_tables else "logical"

    @property
    def zero_gradient_leaves(self) -> dict[str, str]:
        """Leaves this architecture gives an exact gradient of 0 beyond
        those ``training/parity.py`` knows by name (name -> the leaf whose
        gradient sets its scale); none for most models."""
        return {}

    def _build_components(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def _forward_components(
        self,
        first_order: torch.Tensor,
        field_embeddings: torch.Tensor,
        flat_embeddings: torch.Tensor,
    ) -> torch.Tensor:
        raise NotImplementedError

    def forward(
        self,
        ids: torch.Tensor,
        dense: torch.Tensor,
        rows_override: dict[str, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        """Raw logit (B, 1) in f32. Train/eval behaviour (dropout, batch
        statistics) follows ``self.training``; ``rows_override`` feeds
        pre-gathered table rows (``ops.embedding.gather_group_rows``)."""
        first_order, field_embeddings, flat_embeddings = self.embedding(
            ids, dense, rows_override
        )
        logit = self._forward_components(
            first_order, field_embeddings, flat_embeddings
        )
        return logit.float()

    def predict(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """Probabilities in [0, 1] — sigmoid over the raw logit."""
        return torch.sigmoid(self(ids, dense))


def embedding_l2_loss(params: dict[str, torch.Tensor], l2_reg: float,
                      exclude_tables: bool = False) -> torch.Tensor:
    """``l2_reg`` times the sum of squared embedding parameters (names
    ``embedding.*``), summed leaf by leaf in the JAX tree's leaf order.

    ``exclude_tables`` skips the fused lookup tables (``table_w*``,
    ``fo_table*``): the lazy_adam path applies their L2 row-wise inside
    the sparse update instead of as a loss term over the whole table.
    """
    names = [n for n in params if n.startswith("embedding.") and not (
        exclude_tables
        and n.split(".")[-1].startswith(("table_w", "fo_table")))]
    sq = sum(torch.sum(torch.square(params[n])) for n in leaf_order(names))
    return l2_reg * sq
