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


def compute_dtype_of(config: ExperimentConfig) -> torch.dtype:
    if config.training.compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


class CTRModel(nn.Module):
    """Base class: embedding -> subclass heads -> raw logit (B, 1)."""

    def __init__(
        self,
        packed: PackedSchema,
        config: ExperimentConfig,
        generator: torch.Generator | None = None,
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
        )
        self._build_components(g)

    def _build_components(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def _forward_components(
        self,
        first_order: torch.Tensor,
        field_embeddings: torch.Tensor,
        flat_embeddings: torch.Tensor,
    ) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """Raw logit (B, 1) in f32. Train/eval behaviour (dropout, batch
        statistics) follows ``self.training``."""
        first_order, field_embeddings, flat_embeddings = self.embedding(
            ids, dense
        )
        logit = self._forward_components(
            first_order, field_embeddings, flat_embeddings
        )
        return logit.float()

    def predict(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        """Probabilities in [0, 1] — sigmoid over the raw logit."""
        return torch.sigmoid(self(ids, dense))
