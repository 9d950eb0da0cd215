"""Ablation baselines: LR, FM and DNN-only CTR models.

Port of ``deepfm_tpu/models/baselines.py``. Each is a strict ablation of
DeepFM on the same shared embedding engine:

  lr:  logit = first_order + bias           (the "wide" half alone)
  fm:  logit = first_order + FM(field_emb)  (linear + pairwise)
  dnn: logit = Linear(DNN(flat))            (the "deep" half alone, with
                                             no first-order term)

No baseline runs a kernel of its own: the table kernels of the train step
serve them as they serve DeepFM, and the DNN is plain matmuls.
"""

from __future__ import annotations

import torch
from torch import nn

from deepfm_tpu_torch.models.base import CTRModel, compute_dtype_of
from deepfm_tpu_torch.ops.dnn import DNN, torch_linear
from deepfm_tpu_torch.ops.fm import fm_interaction


class LogisticRegression(CTRModel):
    """First-order (wide) model: per-feature scalar weights + bias."""

    def _build_components(self, generator: torch.Generator) -> None:
        self.bias = nn.Parameter(torch.zeros(1))

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        return first_order + self.bias[None, :].to(first_order.dtype)


class FM(CTRModel):
    """Factorization machine: first-order + pairwise interactions."""

    def _build_components(self, generator: torch.Generator) -> None:
        pass

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        return first_order + fm_interaction(field_embeddings)


class DNNOnly(CTRModel):
    """Deep half alone: an MLP over the flat embeddings, no first-order
    term (the wide half would confound the wide/deep decomposition)."""

    def _build_components(self, generator: torch.Generator) -> None:
        cfg = self.config
        self.dnn = DNN(
            in_dim=self.packed.schema.total_embedding_dim,
            hidden_units=cfg.dnn.hidden_units,
            activation=cfg.dnn.activation,
            dropout=cfg.dnn.dropout,
            use_batch_norm=cfg.dnn.use_batch_norm,
            compute_dtype=compute_dtype_of(cfg),
            generator=generator,
        )
        self.output_linear = torch_linear(self.dnn.output_dim, 1, generator)

    @property
    def zero_gradient_leaves(self) -> dict[str, str]:
        """A dense field's bias ``dense_b{d}`` shifts its DNN input columns
        by a constant, which the first train-mode BatchNorm removes: its
        exact gradient is 0 (its scale: ``dense_w{d}``'s)."""
        if not self.config.dnn.use_batch_norm:
            return {}
        return {n: n.replace("dense_b", "dense_w")
                for n, _ in self.named_parameters()
                if n.startswith("embedding.dense_b")}

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        cdt = compute_dtype_of(self.config)
        lin = self.output_linear
        return torch.nn.functional.linear(
            self.dnn(flat_embeddings).to(cdt), lin.weight.to(cdt),
            lin.bias.to(cdt),
        )
