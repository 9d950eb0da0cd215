"""The sparse gradient exchange over the data axis (model axis 1).

Port of ``deepfm_tpu/parallel/embedding_shard.py``'s
``sparse_grad_exchange`` and of its factories ``make_lookup_fn`` and
``make_packed_lookup_factory`` at a model axis of 1. The model-sharded
lookups (the psum and all-to-all strategies, logical and packed) and the
routed exchange wait for ROADMAP queue 1 item 10(b).

Under data parallelism every rank holds the whole table, and autograd
would give each rank a dense table gradient of its own rows, which a
table-sized all-reduce would then sum (2 * V * (d+1) * 4 bytes a step:
707 MB at bench.py's 10.4M x 17 table). The gradient of a gather is
sparse, so the exchange replaces the lookup's backward: each rank's (id,
cotangent) pairs, ids as int32, are all-gathered over the ranks (rank 0's
first: the one-process stream of the global batch) and every rank
densifies the same stream with the port's densify kernel
(``ops/kernels/grad.py``, or ``ops/kernels/packed_grad.py`` straight into
a packed table), so every rank holds the same dense table gradient and
no table-sized all-reduce happens. The forward is the lookup the model
would take without a mesh (plain indexing, the row-gather kernel, or the
packed table's strided view).

Each rank's stream has as many pairs as every other's, since each takes
batch_size / data rows (``parallel/sharding.py::check_batch``), so the
JAX package's padding of an odd global stream (id 0, zero cotangent) has
no case to serve here.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.mesh import Mesh

Lookup = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _plain_gather(table: torch.Tensor, flat_ids: torch.Tensor):
    return table[flat_ids]


class SparseGradExchange(torch.autograd.Function):
    """``forward_fn(table, flat_ids)`` whose table gradient is the
    densified all-gathered (id, cotangent) stream of every rank;
    ``packed_geom`` = (dcol, pack) densifies into a packed table."""

    @staticmethod
    def forward(ctx, table, flat_ids, mesh, forward_fn, packed_geom):
        ctx.save_for_backward(flat_ids)
        ctx.mesh, ctx.packed_geom = mesh, packed_geom
        ctx.rows = table.shape[0]
        return forward_fn(table, flat_ids)

    @staticmethod
    def backward(ctx, ct):
        from deepfm_tpu_torch.ops.kernels.grad import densify_rows_grad
        from deepfm_tpu_torch.ops.kernels.packed_grad import (
            densify_rows_grad_packed,
        )

        (flat_ids,) = ctx.saved_tensors
        ids_all = collectives.all_gather_rows(ctx.mesh,
                                              flat_ids.to(torch.int32))
        ct_all = collectives.all_gather_rows(ctx.mesh,
                                             ct.float().contiguous())
        if ctx.packed_geom is None:
            grad = densify_rows_grad(ct_all, ids_all, ctx.rows)
        else:
            _, pack = ctx.packed_geom
            grad = densify_rows_grad_packed(ct_all, ids_all,
                                            ctx.rows * pack, pack)
        return grad, None, None, None, None


def sparse_grad_exchange(mesh: Mesh, forward_fn: Lookup,
                         packed_geom: tuple[int, int] | None = None
                         ) -> Lookup:
    """The lookup ``forward_fn`` with the sparse data-axis gradient
    exchange as its backward (module docstring)."""

    def lookup(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
        return SparseGradExchange.apply(table, flat_ids, mesh, forward_fn,
                                        packed_geom)

    return lookup


def _exchanges(mesh: Mesh | None, strategy: str) -> bool:
    """Whether ``make_lookup_fn`` installs an exchange: a mesh of more
    than one rank and any strategy but "auto", which leaves the dense
    table gradient to the step's all-reduce (GSPMD's in the JAX
    package)."""
    return mesh is not None and mesh.world > 1 and strategy != "auto"


def make_lookup_fn(mesh: Mesh | None, strategy: str = "psum",
                   gather: Lookup | None = None) -> Lookup | None:
    """The logical-layout lookup under ``mesh``: the exchange around
    ``gather`` (plain indexing by default; the row-gather kernel where
    the config asks for it), or None where the model keeps its own lookup
    (``_exchanges``). At a model axis of 1 every strategy but "auto" is
    this exchange, as in the JAX package."""
    if not _exchanges(mesh, strategy):
        return None
    return sparse_grad_exchange(mesh, gather or _plain_gather)


def make_packed_lookup_factory(mesh: Mesh | None, strategy: str = "psum"
                               ) -> Callable[[int, int], Lookup] | None:
    """``factory(dcol, pack)`` of packed-layout lookups under ``mesh``: the
    exchange around the packed table's strided gather, densified straight
    into the packed layout; None where ``make_lookup_fn`` gives None."""
    if not _exchanges(mesh, strategy):
        return None
    from deepfm_tpu_torch.ops.kernels.packed_grad import packed_rows

    def factory(dcol: int, pack: int) -> Lookup:
        def gather(table, flat_ids):
            return packed_rows(table, flat_ids, dcol, pack)

        return sparse_grad_exchange(mesh, gather, (dcol, pack))

    return factory
