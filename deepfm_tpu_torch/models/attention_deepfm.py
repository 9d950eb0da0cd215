"""AttentionDeepFM: FM + field self-attention + DNN.

Port of ``deepfm_tpu/models/attention_deepfm.py``:
logit = first_order + FM(field_embeddings)
      + output_linear(DNN(concat[flatten(Attn(field_embeddings)), flat])).
The DNN's input width is F*d + the schema's total embedding width.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.models.base import CTRModel, compute_dtype_of
from deepfm_tpu_torch.ops.attention import MultiHeadSelfAttention
from deepfm_tpu_torch.ops.dnn import DNN, torch_linear
from deepfm_tpu_torch.ops.fm import fm_interaction


class AttentionDeepFM(CTRModel):
    def _build_components(self, generator: torch.Generator) -> None:
        cfg = self.config
        cdt = compute_dtype_of(cfg)
        d = cfg.feature.fm_embed_dim
        self.attention = MultiHeadSelfAttention(
            embed_dim=d,
            num_heads=cfg.attention.num_heads,
            attention_dim=cfg.attention.attention_dim,
            num_layers=cfg.attention.num_layers,
            use_residual=cfg.attention.use_residual,
            compute_dtype=cdt,
            use_kernel=cfg.pallas.use_attention_kernel,
            generator=generator,
        )
        self.dnn = DNN(
            in_dim=self.packed.num_fields * d
            + self.packed.schema.total_embedding_dim,
            hidden_units=cfg.dnn.hidden_units,
            activation=cfg.dnn.activation,
            dropout=cfg.dnn.dropout,
            use_batch_norm=cfg.dnn.use_batch_norm,
            compute_dtype=cdt,
            generator=generator,
        )
        self.output_linear = torch_linear(self.dnn.output_dim, 1, generator)

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        cdt = compute_dtype_of(self.config)
        attn = self.attention(field_embeddings)
        dnn_input = torch.cat(
            [attn.reshape(attn.shape[0], -1).to(cdt), flat_embeddings.to(cdt)],
            dim=1,
        )
        lin = self.output_linear
        dnn_out = torch.nn.functional.linear(
            self.dnn(dnn_input).to(cdt), lin.weight.to(cdt), lin.bias.to(cdt),
        )
        return first_order + fm_interaction(field_embeddings) + dnn_out
