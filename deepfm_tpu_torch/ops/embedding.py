"""Fused feature-embedding engine: one module, three views, few big gathers.

Port of ``deepfm_tpu/ops/embedding.py`` (``FeatureEmbedding`` on the
logical table layout). One forward produces

  first_order      (B, 1)        — sum of per-field scalar weights
  field_embeddings (B, F, fm_d)  — per-field embeddings projected to fm_d
  flat_embeddings  (B, total_d)  — raw per-field embeddings concatenated

and keeps the JAX package's layout decisions:

  * all table-backed fields of one embedding width share one fused
    ``(pad128(rows), d+1)`` table with per-field row offsets, so a batch
    does one gather per width group;
  * the table's last column is the field's first-order weight;
  * each field's row 0 is padding/OOV: it is initialised to zero and the
    gathered rows are multiplied by ``(local_id != 0)``;
  * sequence fields pool their slots through a static 0/1 matrix, dividing
    by the valid-slot count for the mean combiner;
  * dense fields are a broadcast multiply-add over a (n, d) weight block.

The gather is plain torch indexing: the JAX package's default gather is
XLA's own, not a Pallas kernel. The packed table layout belongs to a later
slice (models/__init__.py raises for it).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.ops.init import uniform_, xavier_bound

ROW_PAD = 128


def pad_rows(rows: int, multiple: int = ROW_PAD) -> int:
    return -(-rows // multiple) * multiple


def table_row_scale(
    emb_width: int, vocab_sizes: list[int], padded_rows: int
) -> np.ndarray:
    """(padded_rows, emb_width + 1) xavier bounds of a fused table.

    Embedding columns get sqrt(6 / (d + (v-1))), the first-order column
    sqrt(6 / (1 + (v-1))), per field of vocabulary v; every field's row 0
    and the padding tail get 0 (JAX ``make_table_init``).
    """
    starts = np.zeros(len(vocab_sizes) + 1, np.int64)
    np.cumsum(vocab_sizes, out=starts[1:])
    scale = np.zeros((padded_rows, emb_width + 1), np.float32)
    for fi, v in enumerate(vocab_sizes):
        lo, hi = int(starts[fi]) + 1, int(starts[fi + 1])
        scale[lo:hi, :emb_width] = np.sqrt(6.0 / (emb_width + max(v - 1, 1)))
        scale[lo:hi, emb_width] = np.sqrt(6.0 / (1 + max(v - 1, 1)))
    return scale


class FeatureEmbedding(nn.Module):
    """Shared embedding engine emitting the three standard views.

    Parameters carry the JAX tree's names (``table_w{d}``, ``proj_w{d}``,
    ``dense_fo_w``, ``dense_fo_b``, ``dense_w{d}``, ``dense_b{d}``,
    ``dense_proj_w{d}``) so ``convert.params_from_jax`` maps them 1:1.
    """

    def __init__(
        self,
        packed: PackedSchema,
        fm_embed_dim: int = 16,
        compute_dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.packed = packed
        self.fm_embed_dim = fm_d = fm_embed_dim
        self.compute_dtype = compute_dtype

        for gi, group in enumerate(packed.lookup_groups):
            d = group.width
            vocabs = [packed.schema.fields[n].vocabulary_size
                      for n in group.field_names]
            rows = pad_rows(group.total_rows)
            scale = torch.from_numpy(table_row_scale(d, vocabs, rows))
            table = uniform_(torch.empty(rows, d + 1), 1.0, g) * scale
            setattr(self, f"table_w{d}", nn.Parameter(table))
            self.register_buffer(
                f"_offsets_{gi}",
                torch.from_numpy(group.local_offsets.astype(np.int64)),
                persistent=False,
            )
            nf = len(group.field_names)
            if group.slot_end - group.slot_start != nf:
                pool = np.zeros((group.slot_end - group.slot_start, nf),
                                np.float32)
                pool[np.arange(len(group.slot_field)), group.slot_field] = 1.0
                divide = np.asarray(
                    [1.0 if (seq and comb == "mean") else 0.0
                     for seq, comb in zip(group.is_sequence, group.combiners)],
                    np.float32,
                )
                self.register_buffer(
                    f"_pool_{gi}", torch.from_numpy(pool), persistent=False
                )
                self.register_buffer(
                    f"_divide_{gi}", torch.from_numpy(divide),
                    persistent=False,
                )
            if d != fm_d:
                proj = uniform_(torch.empty(nf, d, fm_d), xavier_bound(d, fm_d), g)
                setattr(self, f"proj_w{d}", nn.Parameter(proj))

        if packed.num_dense > 0:
            self.dense_fo_w = nn.Parameter(
                uniform_(torch.empty(packed.num_dense), xavier_bound(1, 1), g)
            )
            self.dense_fo_b = nn.Parameter(torch.zeros(packed.num_dense))
        for group in packed.dense_groups:
            d = group.width
            nf = len(group.field_names)
            setattr(self, f"dense_w{d}", nn.Parameter(
                uniform_(torch.empty(nf, d), xavier_bound(1, d), g)
            ))
            setattr(self, f"dense_b{d}", nn.Parameter(torch.zeros(nf, d)))
            if d != fm_d:
                setattr(self, f"dense_proj_w{d}", nn.Parameter(
                    uniform_(torch.empty(nf, d, fm_d), xavier_bound(d, fm_d), g)
                ))

    def forward(
        self, ids: torch.Tensor, dense: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ids (B, num_slots) int, dense (B, num_dense) float -> three views."""
        packed = self.packed
        cdt = self.compute_dtype
        field_raw: dict[str, torch.Tensor] = {}
        field_proj: dict[str, torch.Tensor] = {}
        fo_parts: list[torch.Tensor] = []

        for gi, group in enumerate(packed.lookup_groups):
            d = group.width
            table = getattr(self, f"table_w{d}")
            ids_g = ids[:, group.slot_start : group.slot_end].long()
            mask = (ids_g != 0).to(cdt)  # (B, S_g)
            local = ids_g + getattr(self, f"_offsets_{gi}")[None, :]
            raw = table[local].to(cdt) * mask[:, :, None]  # (B, S_g, d+1)
            emb = raw[:, :, :d]
            fo_vals = raw[:, :, d]

            if group.slot_end - group.slot_start == len(group.field_names):
                pooled, fo_pooled = emb, fo_vals
            else:
                pool = getattr(self, f"_pool_{gi}").to(cdt)  # (S_g, nf)
                divide = getattr(self, f"_divide_{gi}").to(cdt)
                pooled = torch.einsum("bsd,sf->bfd", emb, pool)
                fo_pooled = fo_vals @ pool
                counts = mask @ pool
                denom = torch.clamp(counts, min=1.0) * divide + (1.0 - divide)
                pooled = pooled / denom[:, :, None]
                fo_pooled = fo_pooled / denom
            fo_parts.append(fo_pooled.sum(dim=1))

            if d != self.fm_embed_dim:
                proj = getattr(self, f"proj_w{d}").to(cdt)
                projected = torch.einsum("bfd,fdk->bfk", pooled, proj)
            else:
                projected = pooled
            for mi, name in enumerate(group.field_names):
                field_raw[name] = pooled[:, mi, :]
                field_proj[name] = projected[:, mi, :]

        if packed.num_dense > 0:
            x = dense.to(cdt)
            fo_parts.append(
                x @ self.dense_fo_w.to(cdt) + self.dense_fo_b.to(cdt).sum()
            )
        for group in packed.dense_groups:
            d = group.width
            w = getattr(self, f"dense_w{d}").to(cdt)
            b = getattr(self, f"dense_b{d}").to(cdt)
            x = dense[:, group.col_start : group.col_end].to(cdt)  # (B, nf)
            emb = x[:, :, None] * w[None] + b[None]
            if d != self.fm_embed_dim:
                proj = getattr(self, f"dense_proj_w{d}").to(cdt)
                projected = torch.einsum("bfd,fdk->bfk", emb, proj)
            else:
                projected = emb
            for mi, name in enumerate(group.field_names):
                field_raw[name] = emb[:, mi, :]
                field_proj[name] = projected[:, mi, :]

        first_order = torch.stack(fo_parts, dim=0).sum(dim=0)[:, None]
        field_embeddings = torch.stack(
            [field_proj[n] for n in packed.field_order], dim=1
        )
        flat_embeddings = torch.cat(
            [field_raw[n] for n in packed.field_order], dim=-1
        )
        return first_order, field_embeddings, flat_embeddings
