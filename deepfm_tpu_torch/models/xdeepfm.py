"""xDeepFM: first-order + CIN (explicit) + DNN (implicit) interactions.

Port of ``deepfm_tpu/models/xdeepfm.py``:
logit = first_order + Linear(CIN(field_embeddings)) + Linear(DNN(flat)).
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.models.base import CTRModel, compute_dtype_of
from deepfm_tpu_torch.ops.cin import CIN
from deepfm_tpu_torch.ops.dnn import DNN, torch_linear


class xDeepFM(CTRModel):  # noqa: N801 — the model's published name
    def _build_components(self, generator: torch.Generator) -> None:
        cfg = self.config
        cdt = compute_dtype_of(cfg)
        self.cin = CIN(
            num_fields=self.packed.num_fields,
            layer_sizes=cfg.cin.layer_sizes,
            split_half=cfg.cin.split_half,
            compute_dtype=cdt,
            use_kernel=cfg.pallas.use_cin_kernel,
            bf16_operands=cfg.pallas.cin_bf16_operands,
            generator=generator,
        )
        self.dnn = DNN(
            in_dim=self.packed.schema.total_embedding_dim,
            hidden_units=cfg.dnn.hidden_units,
            activation=cfg.dnn.activation,
            dropout=cfg.dnn.dropout,
            use_batch_norm=cfg.dnn.use_batch_norm,
            compute_dtype=cdt,
            generator=generator,
        )
        self.cin_linear = torch_linear(self.cin.output_dim, 1, generator)
        self.dnn_linear = torch_linear(self.dnn.output_dim, 1, generator)

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        cdt = compute_dtype_of(self.config)

        def head(lin, x):
            return torch.nn.functional.linear(
                x.to(cdt), lin.weight.to(cdt), lin.bias.to(cdt)
            )

        cin_out = head(self.cin_linear, self.cin(field_embeddings))
        dnn_out = head(self.dnn_linear, self.dnn(flat_embeddings))
        return first_order + cin_out + dnn_out
