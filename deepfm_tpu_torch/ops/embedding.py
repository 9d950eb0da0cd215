"""Fused feature-embedding engine: one module, three views, few big gathers.

Port of ``deepfm_tpu/ops/embedding.py`` (``FeatureEmbedding`` on both
table layouts). One forward produces

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

Table layouts (``models/__init__.py`` resolves ``pallas.table_layout``):

  * logical: each table is ``(pad128(rows), d+1)``;
  * packed: ``pack = 128 // (d+1)`` logical rows side by side in each
    128-float row of a ``(pad128(ceil(rows / pack)), 128)`` table, dead
    lanes 0 (``utils/layout.py``); a group whose ``pack`` would be 1 stays
    logical. A packed table is initialised as the logical one of the same
    seed and packed, so both layouts hold the same logical weights.

The lookup seam (``lookup_fn`` in the JAX module) takes one of three
gathers, each with a kernel for its backward:

  * logical, the default: plain torch indexing (the JAX default is XLA's
    own gather), the gradient densified by ``densify_rows_grad``
    (``ops/kernels/grad.py::sparse_grad_lookup``);
  * logical, ``pallas.use_embedding_kernel``: the row-gather kernel
    (``ops/kernels/gather.py::row_gather_lookup``), the same backward;
  * packed: plain indexing into a strided view, the gradient densified
    straight into the packed layout (``ops/kernels/packed_grad.py``).

Under a mesh, ``create_model`` installs the mesh's lookup
(``parallel/embedding_shard.py``) in place of the table's with
``install_lookups``: at a model axis of 1 the same forward with the sparse
gradient exchange as its backward (every rank's all-gathered (id,
cotangent) pairs, densified); above 1 the psum or all-to-all lookup over
the rank's slab of each table (``shard_tables``: each rank keeps rows
[j * R / m, (j + 1) * R / m) of a table of R rows), under the exchange
into the slab, or under "auto" the slab's own densify.

A CPU table takes the kernels' plain versions. For a serving export
with ``--quantize int8`` (``utils/export.py``), ``quantize_tables`` swaps
the f32 tables for per-row int8 ones (``QuantizedTables``), whose lookup
gathers int8 rows and scales them in f32: the JAX package's ``qlookup``.
The f32 ``table_w*`` parameters are deleted, so an exported program holds
only the int8 tables and their scales (the JAX package passes ``qlookup``
to ``create_model`` as ``lookup_fn`` and lets XLA drop the unused f32
tables; ``torch.export`` keeps every registered parameter).

The trainer's sparse-fused path gathers the rows itself
(``gather_group_rows``, through the installed lookup's forward on a
sharded table) and hands them back through ``rows_override``, so autograd
yields the per-occurrence cotangents and never the dense table gradient.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.ops.init import uniform_, xavier_bound
from deepfm_tpu_torch.ops.kernels.gather import row_gather_lookup
from deepfm_tpu_torch.ops.kernels.grad import sparse_grad_lookup
from deepfm_tpu_torch.ops.kernels.packed_grad import packed_lookup, packed_rows
from deepfm_tpu_torch.utils.layout import LANES, pack_table

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


class QuantizedTables(nn.Module):
    """Per-row symmetric int8 tables of a serving model: buffers
    ``q_w{d}`` (rows, d+1) int8 and ``scale_w{d}`` (rows,) f32, built from
    ``{d+1: (q, scale)}`` (``utils/export.py::quantize_embedding_tables``).
    A row is gathered as int8, widened to f32 and multiplied by its
    scale."""

    def __init__(self, qtabs: dict[int, tuple[np.ndarray, np.ndarray]]):
        super().__init__()
        for dcol, (q, scale) in qtabs.items():
            self.register_buffer(f"q_w{dcol - 1}", torch.from_numpy(q))
            self.register_buffer(f"scale_w{dcol - 1}",
                                 torch.from_numpy(scale))

    def forward(self, d: int, flat_ids: torch.Tensor) -> torch.Tensor:
        q = getattr(self, f"q_w{d}")
        scale = getattr(self, f"scale_w{d}")
        return q[flat_ids].to(torch.float32) * scale[flat_ids][:, None]


class FeatureEmbedding(nn.Module):
    """Shared embedding engine emitting the three standard views.

    Parameters carry the JAX tree's names (``table_w{d}``, ``proj_w{d}``,
    ``dense_fo_w``, ``dense_fo_b``, ``dense_w{d}``, ``dense_b{d}``,
    ``dense_proj_w{d}``) so ``convert.params_from_jax`` maps them 1:1.
    ``packed_tables`` stores the tables packed; ``gather_kernel`` gathers
    logical tables with the row-gather kernel (``create_model`` never sets
    both, as the JAX package's does not).
    """

    def __init__(
        self,
        packed: PackedSchema,
        fm_embed_dim: int = 16,
        compute_dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
        packed_tables: bool = False,
        gather_kernel: bool = False,
    ) -> None:
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.packed = packed
        self.fm_embed_dim = fm_d = fm_embed_dim
        self.compute_dtype = compute_dtype
        self.packed_tables = packed_tables
        self.gather_kernel = gather_kernel
        # table name -> logical rows per physical row (1: logical layout)
        self.table_pack: dict[str, int] = {}
        # int8 serving tables in place of table_w* (``quantize_tables``)
        self.quantized: QuantizedTables | None = None
        # table name -> the lookup installed in place of the layout's own
        # (``install_lookups``: the mesh's lookup and gradient exchange)
        self.lookup_fns: dict = {}
        # table name -> the whole table's (physical) rows; the model-axis
        # slab each table holds, (model index, model axis), once
        # ``shard_tables`` has cut them (None: whole tables)
        self.table_rows: dict[str, int] = {}
        self.shard: tuple[int, int] | None = None

        for gi, group in enumerate(packed.lookup_groups):
            d = group.width
            vocabs = [packed.schema.fields[n].vocabulary_size
                      for n in group.field_names]
            rows = pad_rows(group.total_rows)
            scale = torch.from_numpy(table_row_scale(d, vocabs, rows))
            table = uniform_(torch.empty(rows, d + 1), 1.0, g) * scale
            pack = LANES // (d + 1) if packed_tables else 1
            if pack > 1:
                phys = pad_rows(-(-group.total_rows // pack))
                table = pack_table(table, d + 1, pack, phys)
            self.table_pack[f"table_w{d}"] = max(pack, 1)
            self.table_rows[f"table_w{d}"] = table.shape[0]
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

    def local_ids(self, gi: int, ids: torch.Tensor) -> torch.Tensor:
        """(B, S_g) logical row ids of width group ``gi`` in its fused
        table."""
        group = self.packed.lookup_groups[gi]
        ids_g = ids[:, group.slot_start : group.slot_end].long()
        return ids_g + getattr(self, f"_offsets_{gi}")[None, :]

    def quantize_tables(
        self, qtabs: dict[int, tuple[np.ndarray, np.ndarray]]
    ) -> None:
        """Serve from per-row int8 tables ``{d+1: (q, scale)}`` of the
        logical shape: the f32 ``table_w*`` parameters are deleted and
        every lookup reads ``QuantizedTables``."""
        widths = [group.width for group in self.packed.lookup_groups]
        for d, group in zip(widths, self.packed.lookup_groups):
            q, scale = qtabs[d + 1]
            rows = pad_rows(group.total_rows)
            if q.shape != (rows, d + 1) or scale.shape != (rows,):
                raise ValueError(
                    f"table_w{d}: int8 table {q.shape} and scales "
                    f"{scale.shape} do not match the logical ({rows}, {d + 1})")
        for d in widths:
            delattr(self, f"table_w{d}")
        self.quantized = QuantizedTables(qtabs)

    def shard_tables(self, mesh) -> None:
        """Keep the rank's model-axis slab of every table
        (``parallel/sharding.py::slab_bounds``; a model axis that does not
        divide a table's rows is refused)."""
        from deepfm_tpu_torch.parallel.sharding import slab_bounds

        for name in self.table_pack:
            lo, hi = slab_bounds(mesh, self.table_rows[name])
            whole = getattr(self, name).detach()
            setattr(self, name, nn.Parameter(whole[lo:hi].clone()))
        self.shard = (mesh.model_index, mesh.model)

    def slab_of(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole table-shaped tensor (a table or its
        moment); ``whole`` itself on whole tables."""
        if self.shard is None:
            return whole
        j, m = self.shard
        per = whole.shape[0] // m
        return whole[j * per:(j + 1) * per]

    def install_lookups(self, lookup_fn, packed_lookup_factory) -> None:
        """Look up each logical table with ``lookup_fn(table, flat_ids)``
        and each packed one with ``packed_lookup_factory(dcol, pack)``'s
        lookup (``parallel/embedding_shard.py``); None keeps the layout's
        own lookup."""
        for name, pack in self.table_pack.items():
            dcol = int(name[len("table_w"):]) + 1
            fn = (packed_lookup_factory(dcol, pack)
                  if pack > 1 and packed_lookup_factory is not None
                  else lookup_fn if pack == 1 else None)
            if fn is not None:
                self.lookup_fns[name] = fn

    def lookup(self, d: int, flat_ids: torch.Tensor) -> torch.Tensor:
        """(n, d+1) rows of the width-``d`` table at logical ids
        ``flat_ids``, by an installed lookup, else the table's layout and
        the configured gather (module docstring)."""
        if self.quantized is not None:
            return self.quantized(d, flat_ids)
        table = getattr(self, f"table_w{d}")
        installed = self.lookup_fns.get(f"table_w{d}")
        if installed is not None:
            return installed(table, flat_ids)
        pack = self.table_pack[f"table_w{d}"]
        if pack > 1:
            return packed_lookup(table, flat_ids, d + 1, pack)
        if self.gather_kernel:
            return row_gather_lookup(table, flat_ids)
        return sparse_grad_lookup(table, flat_ids)

    def forward(
        self,
        ids: torch.Tensor,
        dense: torch.Tensor,
        rows_override: dict[str, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """ids (B, num_slots) int, dense (B, num_dense) float -> three views.

        ``rows_override`` maps a table name to its pre-gathered (n, d+1)
        f32 rows (``gather_group_rows``); the graph from there on is the
        one the in-graph gather builds."""
        packed = self.packed
        cdt = self.compute_dtype
        field_raw: dict[str, torch.Tensor] = {}
        field_proj: dict[str, torch.Tensor] = {}
        fo_parts: list[torch.Tensor] = []

        for gi, group in enumerate(packed.lookup_groups):
            d = group.width
            ids_g = ids[:, group.slot_start : group.slot_end]
            mask = (ids_g != 0).to(cdt)  # (B, S_g)
            name = f"table_w{d}"
            if rows_override is not None and name in rows_override:
                rows = rows_override[name]
            else:
                rows = self.lookup(d, self.local_ids(gi, ids).reshape(-1))
            raw = rows.reshape(*ids_g.shape, d + 1).to(cdt)
            raw = raw * mask[:, :, None]  # (B, S_g, d+1)
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


def gather_group_rows(
    embedding: FeatureEmbedding, ids: torch.Tensor
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Gather each width group's raw table rows outside the loss graph.

    Returns {table name: (rows (n, d+1) f32, flat logical row ids (n,)
    int64)}: the same ids and the same gather as
    ``FeatureEmbedding.forward``, so feeding the rows back through
    ``rows_override`` reproduces the forward, and the loss gradient with
    respect to the rows is the (id, cotangent) stream the sparse-fused
    table update consumes. The ids are logical in both layouts, so the
    sort and ``segment_sumsq`` do not depend on it. A table with an
    installed lookup (a model-sharded table's psum or all-to-all forward)
    is gathered through it, outside autograd. Port of
    ``deepfm_tpu/ops/embedding.py::gather_group_rows``.
    """
    out = {}
    for gi, group in enumerate(embedding.packed.lookup_groups):
        name = f"table_w{group.width}"
        flat = embedding.local_ids(gi, ids).reshape(-1)
        table = getattr(embedding, name).detach()
        pack = embedding.table_pack[name]
        installed = embedding.lookup_fns.get(name)
        if installed is not None:
            with torch.no_grad():
                rows = installed(table, flat)
        elif pack > 1:
            rows = packed_rows(table, flat, group.width + 1, pack)
        else:
            rows = table[flat]
        out[name] = (rows, flat)
    return out
