"""AutoInt: field self-attention with a projected residual (Song et al.,
CIKM 2019, arXiv:1810.11921); the port's own model, not in the JAX
package.

logit = output_linear(flatten(InteractingStack(field_embeddings))): the
shared embedding's (B, F, d) field embeddings (section 4.3) through
``attention.num_layers`` interacting layers of ``attention.num_heads``
heads and width ``attention.attention_dim`` (section 4.4), flattened to
F·a and read by one Linear (section 4.5). No first-order term and no DNN:
the tables' first-order column and the dense fields' first-order weights
get no gradient, as in the port's ``dnn`` baseline. The shared embedding
gives a numeric field the embedding v_m·x_m + b_m; the paper's has no b_m.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.models.base import CTRModel, compute_dtype_of
from deepfm_tpu_torch.ops.attention import InteractingStack
from deepfm_tpu_torch.ops.dnn import torch_linear


class AutoInt(CTRModel):
    def _build_components(self, generator: torch.Generator) -> None:
        cfg = self.config
        att = cfg.attention
        self.attention = InteractingStack(
            embed_dim=cfg.feature.fm_embed_dim,
            num_heads=att.num_heads,
            attention_dim=att.attention_dim,
            num_layers=att.num_layers,
            compute_dtype=compute_dtype_of(cfg),
            use_kernel=cfg.pallas.use_attention_kernel,
            generator=generator,
        )
        self.output_linear = torch_linear(
            self.packed.num_fields * att.attention_dim, 1, generator)

    def _forward_components(self, first_order, field_embeddings,
                            flat_embeddings):
        cdt = compute_dtype_of(self.config)
        out = self.attention(field_embeddings)
        lin = self.output_linear
        return torch.nn.functional.linear(
            out.reshape(out.shape[0], -1), lin.weight.to(cdt),
            lin.bias.to(cdt))
