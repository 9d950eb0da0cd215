"""Row-sharded embedding lookups and the sparse gradient exchange.

Port of ``deepfm_tpu/parallel/embedding_shard.py`` (ROADMAP queue 1 items
10(a) and 10(b)). Under a (data, model)
mesh each embedding table is cut into model-axis slabs
(``parallel/sharding.py``): the rank at model index j holds the logical
ids [j * rows, (j + 1) * rows) of every table, ``rows`` its slab's logical
rows (physical rows times ``pack`` on a packed table). The m ranks of a
data row hold the same batch rows, so the same ids.

Lookups (the JAX strategies, both layouts; at a model axis of 1 every one
is the rank's own gather):

  * "psum": each rank gathers the ids its slab owns (others masked to id
    0 and their rows zeroed) and the rows are summed over the model group
    (``collectives.model_sum``: exact in f32, one row and zeros);
  * "all_to_all": the data row's n ids are split over its m ranks; each
    buckets its n / m ids by owner with ``capacity = min(n/m, max(8,
    int(ALL_TO_ALL_CAPACITY * ceil(n / m / m))))``, exchanges the buckets
    with an all-to-all over the model group, gathers locally, and routes
    the rows back with a second all-to-all. Each rank then holds the rows
    of its n / m ids; an all-gather over the model group hands the whole
    data row's rows to every peer (GSPMD's all-gather at ``P((data,
    model))`` in the JAX package). Ids that overflowed their bucket take
    the exact psum path, which runs only when a rank of the model group
    overflowed (the gathered overflow mask is the same on every peer).
    When n does not split over the m ranks, the whole lookup is psum.

The local gather under each: plain indexing, the row-gather kernel
(``pallas.use_embedding_kernel``), or the packed table's strided view.

The sparse gradient exchange (``SparseGradExchange``) replaces the
lookup's backward under every strategy but "auto": autograd would give
each rank a dense gradient of its own rows, which a table-sized
all-reduce would then sum (2 * V * (d+1) * 4 bytes a step: 707 MB at
bench.py's 10.4M x 17 table). Instead the (id, cotangent) pairs, ids as
int32, are all-gathered over the data group (its first rank's first: the
one-process stream of the global batch), shifted to slab-local ids (an id
outside the slab becomes the id one past it, which the densify kernels
skip: the JAX package's id 0 with a zero cotangent would sum into slab
row 0 as one run as long as half the stream) and densified into the slab
with the port's densify kernel
(``ops/kernels/grad.py``, or ``ops/kernels/packed_grad.py`` straight into
a packed slab). Every rank of a model column holds the same slab
gradient, and no table-sized all-reduce happens. ``routed`` (the
all_to_all strategy, with more than one rank on each axis): each rank
first keeps only the pairs its slab owns, compressed into ``cap = min(n,
max(8, int(ROUTED_EXCHANGE_CAPACITY * ceil(n / m))))`` pairs, and
all-gathers only those; an overflow anywhere (agreed over the world, as
the JAX package's psum over (data, model)) takes the full exchange, which
is exact. The bucket's unused places hold the id one past the slab.

``route_sorted_pairs`` does the same routing for the sparse-fused path
(``training/steps.py``), then sorts the slab's pairs, drops the unused
places (sorted last; one host read of their count), and takes their
``segment_sumsq``, summed over the model group.

Strategy "auto" at a model axis above 1 is the JAX package's GSPMD lookup
on logical tables: the masked slab gather summed over the model group,
whose backward is the local gather's (the densify kernel into the slab);
the step's flat all-reduce sums that slab gradient over the data group.

Each rank's stream has as many pairs as every other's, since each takes
batch_size / data rows (``parallel/sharding.py::check_batch``), so the
JAX package's padding of an odd global stream (id 0, zero cotangent) has
no case to serve here. The capacity factors are module constants, read at
each call, so that a test can shrink them.
"""

from __future__ import annotations

from typing import Callable

import torch

from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.mesh import Mesh
from deepfm_tpu_torch.parallel.sharding import slabs_without_exchange

Lookup = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

STRATEGIES = ("auto", "psum", "all_to_all")
# capacity factors of the routed lookup's buckets, of the routed gradient
# exchange and of route_sorted_pairs (the JAX package's defaults)
ALL_TO_ALL_CAPACITY = 2.0
ROUTED_EXCHANGE_CAPACITY = 1.5
ROUTE_PAIRS_CAPACITY = 1.5
# calls that took an exact fallback, by path (read by tests and the card's
# phase; each rank counts its own)
fallbacks = {"lookup": 0, "exchange": 0, "route_sorted_pairs": 0}


def capacity(n: int, parts: int, factor: float) -> int:
    """The JAX package's bucket size for ``n`` items over ``parts``
    owners: min(n, max(8, int(factor * ceil(n / parts))))."""
    return min(n, max(8, int(factor * -(-n // parts))))


def owned(mesh: Mesh, ids: torch.Tensor, rows: int):
    """(slab-local ids, whether the rank's slab of ``rows`` logical rows
    owns them)."""
    local = ids - mesh.model_index * rows
    return local, (local >= 0) & (local < rows)


def _plain_gather(table: torch.Tensor, flat_ids: torch.Tensor):
    return table[flat_ids]


def psum_lookup(mesh: Mesh, local_lookup: Lookup, pack: int = 1) -> Lookup:
    """The psum strategy over ``local_lookup(slab, slab-local ids)``: a
    slab of ``pack`` logical rows a physical row. Differentiable where
    ``local_lookup`` is: the model-group sum passes the cotangent on as it
    is."""

    def lookup(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
        if mesh.model == 1:
            return local_lookup(table, flat_ids)
        local, ok = owned(mesh, flat_ids, table.shape[0] * pack)
        vals = local_lookup(table, torch.where(ok, local, 0))
        vals = vals * ok[:, None].to(vals.dtype)
        return collectives.model_sum(mesh.model_group, vals)

    return lookup


def a2a_lookup(mesh: Mesh, local_lookup: Lookup, pack: int = 1) -> Lookup:
    """The all_to_all strategy over ``local_lookup`` (module docstring),
    with the psum lookup as its exact fallback. A forward: its gradient is
    the routed exchange's (``make_lookup_fn``)."""
    psum = psum_lookup(mesh, local_lookup, pack)

    def lookup(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
        m = mesh.model
        n = flat_ids.shape[0]
        if m == 1:
            return local_lookup(table, flat_ids)
        if n % m:
            return psum(table, flat_ids)
        group, me = mesh.model_group, mesh.model_index
        rows = table.shape[0] * pack
        n_loc = n // m
        cap = capacity(n_loc, m, ALL_TO_ALL_CAPACITY)
        mine = flat_ids[me * n_loc:(me + 1) * n_loc]
        owner = torch.clamp(torch.div(mine, rows, rounding_mode="floor"),
                            0, m - 1)
        owner_s, order = torch.sort(owner, stable=True)
        counts = torch.bincount(owner_s, minlength=m)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(n_loc, device=mine.device) - starts[owner_s]
        fits = pos < cap
        slot = torch.where(fits, owner_s * cap + pos, m * cap)
        # row k of the buckets: the ids owner k is asked for (a spare slot
        # takes the ids that do not fit)
        send = torch.zeros(m * cap + 1, dtype=torch.int32,
                           device=mine.device)
        send.scatter_(0, slot, mine[order].to(torch.int32))
        recv = collectives.all_to_all_rows(group, send[:m * cap])
        local = torch.clamp(recv.long() - me * rows, 0, rows - 1)
        back = collectives.all_to_all_rows(group, local_lookup(table, local))
        got = back[torch.where(fits, slot, 0)]
        got = got * fits[:, None].to(got.dtype)
        out = torch.empty((n_loc, got.shape[1] + 1), dtype=got.dtype,
                          device=got.device)
        out[order, :-1] = got
        out[order, -1] = (~fits).to(got.dtype)
        # the whole data row's rows, and its overflow mask, on every peer
        every = collectives.all_gather_rows(group, out)
        vals, overflow = every[:, :-1], every[:, -1] > 0
        if bool(overflow.any()):
            fallbacks["lookup"] += 1
            fixed = psum(table, torch.where(overflow, flat_ids, 0))
            vals = torch.where(overflow[:, None], fixed, vals)
        return vals

    return lookup


class SparseGradExchange(torch.autograd.Function):
    """``forward_fn(table, flat_ids)`` whose table gradient is the
    densified stream of the (id, cotangent) pairs of every rank of the
    data group that the rank's slab owns (module docstring);
    ``packed_geom`` = (dcol, pack) densifies into a packed slab."""

    @staticmethod
    def forward(ctx, table, flat_ids, mesh, forward_fn, packed_geom,
                routed):
        ctx.save_for_backward(flat_ids)
        ctx.mesh, ctx.packed_geom, ctx.routed = mesh, packed_geom, routed
        ctx.rows = table.shape[0]
        return forward_fn(table, flat_ids)

    @staticmethod
    def backward(ctx, ct):
        from deepfm_tpu_torch.ops.kernels.grad import densify_rows_grad
        from deepfm_tpu_torch.ops.kernels.packed_grad import (
            densify_rows_grad_packed,
        )

        (flat_ids,) = ctx.saved_tensors
        mesh = ctx.mesh
        pack = 1 if ctx.packed_geom is None else ctx.packed_geom[1]
        rows = ctx.rows * pack

        def densify(ct_all, ids_all):
            if ctx.packed_geom is None:
                return densify_rows_grad(ct_all, ids_all, ctx.rows)
            return densify_rows_grad_packed(ct_all, ids_all, rows, pack)

        ids = flat_ids.to(torch.int32)
        ct = ct.float().contiguous()
        if (ctx.routed and mesh.model > 1
                and mesh.data_group is not None):
            got = routed_pairs(mesh, ids, ct, rows, ROUTED_EXCHANGE_CAPACITY,
                               "exchange")
            if got is not None:
                sids, cts = got
                return densify(cts, sids), None, None, None, None, None
        ids_all = collectives.all_gather_rows(mesh.data_group, ids)
        ct_all = collectives.all_gather_rows(mesh.data_group, ct)
        if mesh.model > 1:
            local, ok = owned(mesh, ids_all, rows)
            ids_all = torch.where(ok, local, rows)
        return densify(ct_all, ids_all), None, None, None, None, None


def routed_pairs(mesh: Mesh, ids: torch.Tensor, ct: torch.Tensor,
                 rows: int, factor: float, what: str):
    """The pairs of the data group that the rank's slab owns: each rank
    keeps its own owned pairs (slab-local ids; the rest after them, with
    the id ``rows``, one past the slab), the first ``cap`` of them,
    all-gathered over the data group: (ids (dp * cap,) int32, cotangents
    (dp * cap, C)).
    None when a rank anywhere owns more than ``cap`` pairs (the flag is
    agreed over the world: the caller takes its exact full path); no flag
    is taken where ``cap`` holds every pair."""
    n = ids.shape[0]
    cap = capacity(n, mesh.model, factor)
    local, ok = owned(mesh, ids, rows)
    order = torch.sort((~ok).to(torch.int8), stable=True).indices
    if cap < n and collectives.any_over(mesh.world_group,
                                        ok[order][cap:].any()):
        fallbacks[what] += 1
        return None
    keep = order[:cap]
    sids = torch.where(ok, local, rows)[keep].to(torch.int32)
    return (collectives.all_gather_rows(mesh.data_group, sids),
            collectives.all_gather_rows(mesh.data_group, ct[keep]))


def route_sorted_pairs(mesh: Mesh, rows: int):
    """Owner-route the sparse-fused path's (ids, cotangent) stream under
    the all_to_all strategy (``training/steps.py``): ``fn(flat_ids (n,),
    ct (n, C)) -> (sids, cts, ssq, ovf)``: the slab's routed pairs of the
    data group (``routed_pairs``), sorted (``sort_pairs``: slab-local
    ids) without the buckets' unused places, ``segment_sumsq`` of them
    summed over the model group (the table's ||g||^2 term), and ``ovf``:
    None where the capacity holds every pair, else False. Where a rank
    overflowed, every rank returns (None, None, None, True) and the caller
    takes the replicated branch, which is exact."""
    from deepfm_tpu_torch.ops.kernels.sparse_adam import (
        segment_sumsq,
        sort_pairs,
    )

    def fn(flat_ids: torch.Tensor, ct: torch.Tensor):
        n = flat_ids.shape[0]
        static_fit = capacity(n, mesh.model, ROUTE_PAIRS_CAPACITY) >= n
        got = routed_pairs(mesh, flat_ids.to(torch.int32), ct.float(), rows,
                           ROUTE_PAIRS_CAPACITY, "route_sorted_pairs")
        if got is None:
            return None, None, None, True
        sids, cts = sort_pairs(*got)
        # the unused places (id ``rows``) sort last: drop them, so that no
        # kernel walks them as one long run
        end = int(torch.searchsorted(sids, torch.full(
            (1,), rows, dtype=sids.dtype, device=sids.device)))
        sids, cts = sids[:end], cts[:end]
        ssq = collectives.all_reduce_(mesh.model_group,
                                      segment_sumsq(sids, cts).clone())
        return sids, cts, ssq, None if static_fit else False

    return fn


def make_psum_lookup(mesh: Mesh, gather_kernel: bool = False) -> Lookup:
    """The logical-layout psum lookup over the rank's differentiable
    gather: plain indexing whose backward is the densify kernel into the
    slab (``ops/kernels/grad.py::sparse_grad_lookup``), or with
    ``gather_kernel`` the row-gather kernel
    (``ops/kernels/gather.py::row_gather_lookup``). Alone it is strategy
    "auto" above a model axis of 1; under the exchange it is a forward."""
    from deepfm_tpu_torch.ops.kernels.gather import row_gather_lookup
    from deepfm_tpu_torch.ops.kernels.grad import sparse_grad_lookup

    return psum_lookup(mesh, row_gather_lookup if gather_kernel
                       else sparse_grad_lookup)


def make_psum_lookup_packed(mesh: Mesh, dcol: int, pack: int) -> Lookup:
    """The packed-layout psum lookup (logical ids into a packed slab), its
    backward the packed densify kernel into the slab."""
    from deepfm_tpu_torch.ops.kernels.packed_grad import packed_lookup

    return psum_lookup(mesh, lambda t, i: packed_lookup(t, i, dcol, pack),
                       pack)


def make_a2a_lookup(mesh: Mesh, gather_kernel: bool = False) -> Lookup:
    """The logical-layout all-to-all lookup (a forward) over plain
    indexing, or the row-gather kernel with ``gather_kernel``."""
    from deepfm_tpu_torch.ops.kernels.gather import row_gather

    return a2a_lookup(mesh, row_gather if gather_kernel else _plain_gather)


def make_a2a_lookup_packed(mesh: Mesh, dcol: int, pack: int) -> Lookup:
    """The packed-layout all-to-all lookup (a forward)."""
    from deepfm_tpu_torch.ops.kernels.packed_grad import packed_rows

    return a2a_lookup(mesh, lambda t, i: packed_rows(t, i, dcol, pack),
                      pack)


def sparse_grad_exchange(mesh: Mesh, forward_fn: Lookup,
                         packed_geom: tuple[int, int] | None = None,
                         routed: bool = False) -> Lookup:
    """The lookup ``forward_fn`` with the sparse gradient exchange as its
    backward (module docstring)."""

    def lookup(table: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
        return SparseGradExchange.apply(table, flat_ids, mesh, forward_fn,
                                        packed_geom, routed)

    return lookup


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"Unknown embedding strategy: {strategy}")


def _installs(mesh: Mesh | None, strategy: str) -> bool:
    """Whether the factories install a lookup: a mesh of more than one
    rank, and a strategy other than "auto" at a model axis of 1 (there
    "auto" leaves the dense table gradient to the step's all-reduce,
    GSPMD's in the JAX package)."""
    if mesh is None or mesh.world == 1:
        return False
    if mesh.model == 1:  # the JAX factories read no strategy name here
        return strategy != "auto"
    _check_strategy(strategy)
    return True


def make_lookup_fn(mesh: Mesh | None, strategy: str = "psum",
                   gather_kernel: bool = False) -> Lookup | None:
    """The logical-layout lookup under ``mesh``, or None where the model
    keeps its own (``_installs``): the strategy's lookup
    (``make_psum_lookup`` or ``make_a2a_lookup``, the rank's own gather
    at a model axis of 1) inside the sparse gradient exchange, routed
    under "all_to_all"; "auto" above a model axis of 1 the psum lookup
    alone (``sharding.slabs_without_exchange``)."""
    if not _installs(mesh, strategy):
        return None
    if slabs_without_exchange(mesh, strategy):
        return make_psum_lookup(mesh, gather_kernel)
    is_a2a = strategy == "all_to_all"
    make = make_a2a_lookup if is_a2a else make_psum_lookup
    return sparse_grad_exchange(mesh, make(mesh, gather_kernel),
                                routed=is_a2a)


def make_packed_lookup_factory(mesh: Mesh | None, strategy: str = "psum"
                               ) -> Callable[[int, int], Lookup] | None:
    """``factory(dcol, pack)`` of packed-layout lookups under ``mesh``: the
    exchange around ``make_psum_lookup_packed`` or
    ``make_a2a_lookup_packed``, densified straight into the packed
    layout; None where ``make_lookup_fn`` gives None, and where the slabs
    take no exchange (their tables are logical, ``models.tables_packed``)."""
    if not _installs(mesh, strategy) or slabs_without_exchange(mesh,
                                                                 strategy):
        return None
    is_a2a = strategy == "all_to_all"
    make = make_a2a_lookup_packed if is_a2a else make_psum_lookup_packed

    def factory(dcol: int, pack: int) -> Lookup:
        return sparse_grad_exchange(mesh, make(mesh, dcol, pack),
                                    (dcol, pack), routed=is_a2a)

    return factory
