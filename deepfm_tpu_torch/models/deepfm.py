"""DeepFM: first-order + FM second-order + DNN tower.

Port of ``deepfm_tpu/models/deepfm.py``:
logit = first_order + FM(field_embeddings) + output_linear(DNN(flat)).
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.models.base import CTRModel, compute_dtype_of
from deepfm_tpu_torch.ops.dnn import DNN, torch_linear
from deepfm_tpu_torch.ops.fm import fm_interaction


class DeepFM(CTRModel):
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

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        cdt = compute_dtype_of(self.config)
        lin = self.output_linear
        dnn_out = torch.nn.functional.linear(
            self.dnn(flat_embeddings).to(cdt), lin.weight.to(cdt),
            lin.bias.to(cdt),
        )
        return first_order + fm_interaction(field_embeddings) + dnn_out
