"""The train step's four paths.

Port of ``deepfm_tpu/training/steps.py``, on one device and under a
(data, model) mesh (``Trainer.mesh``; ROADMAP queue 1 items 10(a) and
10(b)). PyTorch's autograd does the
model's backward. Paths (``Trainer.path``):

  * ``plain``: the optimizer chain over every leaf, tables included;
  * ``two_pass``: the table gradient is densified by the kernel
    (``ops/kernels/grad.py``, or ``ops/kernels/packed_grad.py`` straight
    into a packed table: the table lookup's backward), each table's
    sumsq(g + wd*p) is reduced from it, and ``fused_table_adam`` updates
    each table in place;
  * ``sparse_fused``: the rows are gathered outside the loss graph and fed
    back through ``rows_override``, so autograd yields the (id, cotangent)
    pairs; they are sorted, each table's sumsq(g + wd*p) is assembled as
    segment_sumsq(ct) + 2*wd*<ct, rows> + wd^2*sumsq(p) with sumsq(p)
    carried from the last step, and ``sparse_table_adam`` densifies,
    decays, clips and updates each table in one pass, returning the next
    sumsq(p). The dense table gradient never exists;
  * ``lazy`` (``optimizer: lazy_adam``): the loss adds the L2 of the
    non-table embedding leaves; the dense table gradient comes from the
    lookup's backward (the densify kernel, logical or packed); the clip
    scale min(1, clip / max(norm, 1e-12)) takes the global norm of every
    gradient, the whole dense table gradients included; the masked dense
    Adam runs on the scaled non-table gradients, and each table takes
    ``lazy_adam_table_update`` on the rows of the batch (physical rows on
    packed tables) at the optimizer's current learning rate.

Every path runs on both table layouts. The pairs carry logical ids in
both, so the sort and ``segment_sumsq`` do not see the layout; the table
update takes the table's ``pack``. A packed table's sums of squares (the
clip norm's, the carried ``table_psq``) run over the whole packed table,
whose dead lanes are 0. Both fused paths share ``chain_second_half``.

Under a (dp, m) mesh each rank holds B / dp rows of the global batch of
B (its data index's; its m model peers hold the same rows and run the same
dense computation on them) and reproduces what GSPMD does with them in
the JAX package. Every sum over rows runs over the data group, never the
world:

  * the loss divides by max(sum of the global batch's weights, 1), and
    the loss returned is the global one;
  * BatchNorm takes the global batch's statistics (``ops/dnn.py``);
  * the gradients each rank forms from its own rows (every non-table
    leaf, and a table looked up without the exchange, i.e. under
    ``mesh.embedding_strategy: auto``), the loss and, on the sparse-fused
    path, each table's <ct, rows> go through one flat all-reduce a step
    over the data group (``parallel/collectives.py::all_reduce_flat``),
    before the global norm;
  * sparse-fused, replicated branch (the JAX ``_replicate`` branch; the
    psum strategy, and every strategy at a model axis of 1): each table's
    (id, cotangent) pairs are all-gathered over the data group, ids as
    int32, its first rank's first, so every rank sorts the one-process
    stream of the global batch (the sort is stable) and takes its
    ``segment_sumsq``; each slab runs ``sparse_table_adam`` on the global
    sorted ids shifted by -j * (the slab's logical rows), so out-of-slab
    ids fall in no tile of the kernel;
  * sparse-fused, routed branch (all_to_all at a model axis above 1):
    ``route_sorted_pairs`` hands each slab's kernel only its own pairs,
    with their ``segment_sumsq`` summed over the model group; where a
    bucket overflowed (agreed over the world) the exact replicated branch
    runs instead;
  * two-pass, lazy and plain: the table gradient comes from the lookup's
    sparse gradient exchange (``parallel/embedding_shard.py``), the slab's
    and the same on every rank of its data group; ``lazy_adam`` updates
    the slab's rows of the global batch (its ids all-gathered over the
    data group, shifted to slab-local), and the loss's L2 term of the
    non-table embedding leaves is added on data index 0 alone, so that
    the data group's losses sum to the global one.

At a model axis above 1 each table's terms of the global clip norm (the
sums of squares, and the fused paths' carried sum(p^2), ``table_psq``)
are the slabs' summed over the model group, in one all-reduce a step.

So every rank of a model column takes the same update and the slab
replicas keep the same bits, and every rank the same update of the
replicated leaves; against one process at the same global batch only the
order of some sums differs (none at a data axis of 1: there only the clip
norm's table terms are summed in another order).

With ``profile.debug_nans`` (the JAX package turns on ``jax_debug_nans``)
each path reads one flag back to the host before it updates anything:
whether the loss and the step's global gradient norm are finite (the
fused paths' clip norm, the lazy path's when it clips, else the plain
norm of the gradients the step has). The first step where either is not
raises ``FloatingPointError``. Unset, the step reads nothing back.
Dropout draws from the trainer's generator (``Trainer.dropout_generator``),
so with dropout > 0 the masks differ from the JAX package's.

Every path runs in three spans of ``utils/tracing.py``: ``step.forward``
(the sparse-fused path's row gather, the loss, the lazy path's L2 term),
``step.backward`` (the ``torch.autograd.grad`` call) and ``step.update``
(everything after it: the all-reduce, norm, clip and the updates).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepfm_tpu_torch.models.base import embedding_l2_loss
from deepfm_tpu_torch.ops.embedding import gather_group_rows
from deepfm_tpu_torch.ops.kernels.adam import fused_table_adam
from deepfm_tpu_torch.ops.kernels.sparse_adam import (
    segment_sumsq,
    sort_pairs,
    sparse_table_adam,
)
from deepfm_tpu_torch.parallel import collectives, embedding_shard, sharding
from deepfm_tpu_torch.training.optim import (
    clip_fn,
    global_norm,
    leaf_order,
    sumsq,
    table_sumsq,
)
from deepfm_tpu_torch.training.sparse_opt import (
    lazy_adam_table_update,
    slab_rows,
    table_ids_for_batch,
)
from deepfm_tpu_torch.training.trainer import _is_table_name
from deepfm_tpu_torch.utils import tracing


def weighted_bce(logits: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor,
                 weight_sum: torch.Tensor | None = None) -> torch.Tensor:
    """optax's ``sigmoid_binary_cross_entropy``,
    -(y * log sigmoid(x) + (1 - y) * log sigmoid(-x)), weighted and divided
    by max(sum(weights), 1); ``weight_sum`` replaces sum(weights) (a rank's
    rows divided by the global batch's sum)."""
    per_row = (-labels * F.logsigmoid(logits)
               - (1.0 - labels) * F.logsigmoid(-logits))
    total = torch.sum(weights) if weight_sum is None else weight_sum
    denom = torch.clamp_min(total, 1.0)
    return torch.sum(per_row * weights) / denom


def slab_ids(sids: torch.Tensor, j: int, rows: int) -> torch.Tensor:
    """Global sorted logical ids as the ids of slab ``j`` of ``rows``
    logical rows: shifted by -j * rows (``sparse_table_adam`` takes the
    ids outside [0, rows) as no row's)."""
    return sids - j * rows


def build_train_step(trainer):
    """The step closure for the trainer's resolved path,
    ``step(trainer, ids, dense, labels, weights)``. It holds the model and
    the optimizer but not the trainer, which passes itself on each call: a
    trainer holding a closure that held it would form a reference cycle,
    and a deleted trainer's device memory would wait for the cycle
    collector."""
    model = trainer.model
    tx = trainer.tx
    config = trainer.config
    l2 = config.feature.embedding_l2_reg
    wd = 2.0 * l2
    clip = config.training.gradient_clip_norm
    params = dict(model.named_parameters())
    order = leaf_order(params)
    dense_names = [n for n in order if not _is_table_name(n)]
    debug_nans = config.profile.debug_nans
    mesh = trainer.mesh
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group
    # the data group has more than one rank: sums over rows are reduced
    dp = data_group is not None
    # the tables are model-axis slabs: j is this rank's
    sharded = model_group is not None
    j = 0 if mesh is None else mesh.model_index
    strategy = config.mesh.embedding_strategy
    routed = sharding.routed(mesh, strategy)
    # tables whose gradient every rank of the data group already holds
    # whole (the lookup's sparse gradient exchange)
    exchanged = (set() if sharding.slabs_without_exchange(mesh, strategy)
                 else {f"embedding.{k}" for k in model.embedding.lookup_fns})
    # table name -> logical rows of the rank's slab (of the whole table
    # without a model axis)
    slab_logical = {n: params[n].shape[0] * trainer._table_pack[n]
                    for n in trainer.table_names}

    def check_finite(trainer, loss, gnorm):
        """``profile.debug_nans``: one host read of whether the loss and
        the global gradient norm are finite; raises ``FloatingPointError``
        at the first step where one is not. A no-op when unset."""
        if not debug_nans:
            return
        ok_loss, ok_grads = torch.isfinite(
            torch.stack([loss.detach().float(), gnorm.float()])
        ).tolist()
        if not (ok_loss and ok_grads):
            what = " and ".join(
                w for w, ok in (("loss", ok_loss), ("gradients", ok_grads))
                if not ok)
            raise FloatingPointError(
                f"profile.debug_nans: non-finite {what} at step "
                f"{int(trainer.state.step) + 1}")

    def forward_loss(ids, dense, labels, weights, rows_override=None):
        model.train()
        logits = model(ids, dense, rows_override)[:, 0]
        weight_sum = (collectives.all_reduce_(data_group, torch.sum(weights))
                      if dp else None)
        return weighted_bce(logits, labels, weights, weight_sum)

    def reduce_partials(loss, grads, extra=()):
        """Under a mesh, the step's one all-reduce: the gradients of
        ``grads`` that each rank formed from its own rows, the loss and
        ``extra`` (scalars), summed over the data group in one flat
        buffer. Returns (loss, grads, extra) as given without one."""
        if not dp:
            return loss, grads, list(extra)
        names = [n for n in grads
                 if not _is_table_name(n) or n not in exchanged]
        parts = collectives.all_reduce_flat(
            data_group, [grads[n] for n in names] + [loss.detach().reshape(1)]
            + [e.reshape(1) for e in extra])
        k = len(names)
        return (parts[k].reshape(()), {**grads, **dict(zip(names, parts))},
                [e.reshape(()) for e in parts[k + 1:]])

    def grads_of(loss, names, extra=()):
        inputs = [params[n] for n in names] + list(extra)
        got = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, got)}
        return grads, got[len(names):]

    def chain_second_half(trainer, loss, grads, table_sq, opt_state):
        """The optax-chain tail of both fused paths: the decayed global
        norm with each table's sumsq(g + wd*p) from ``table_sq``, in the
        JAX tree's leaf order, then (after ``check_finite``) clip and the
        masked dense update (in place). Returns the norm."""
        def decayed(name):
            g = grads[name]
            return g + wd * params[name] if name.startswith("embedding.") \
                else g

        dense = {n: decayed(n) for n in order if not _is_table_name(n)}
        gnorm = global_norm([
            table_sq[n] if _is_table_name(n) else sumsq(dense[n])
            for n in order
        ])
        check_finite(trainer, loss, gnorm)
        if clip > 0:
            trigger = gnorm < clip
            dense = {n: clip_fn(g, gnorm, clip, trigger)
                     for n, g in dense.items()}
        tx.apply(dense, params, opt_state)
        return gnorm

    def forward_backward(ids, dense, labels, weights):
        """The rank's loss and every leaf's gradient, the table's
        densified by its lookup's backward (the plain and two-pass
        paths)."""
        with tracing.span("step.forward"):
            loss = forward_loss(ids, dense, labels, weights)
        with tracing.span("step.backward"):
            grads, _ = grads_of(loss, order)
        return loss, grads

    def plain_step(trainer, ids, dense, labels, weights):
        loss, grads = forward_backward(ids, dense, labels, weights)
        with tracing.span("step.update"), torch.no_grad():
            loss, grads, _ = reduce_partials(loss, grads)
            if debug_nans:
                check_finite(trainer, loss, tx.norm(grads))
            tx.update(grads, params, trainer.state.opt_state)
        return loss

    def two_pass_step(trainer, ids, dense, labels, weights):
        state = trainer.state
        loss, grads = forward_backward(ids, dense, labels, weights)
        with tracing.span("step.update"), torch.no_grad():
            loss, grads, _ = reduce_partials(loss, grads)
            table_sq = table_sumsq(model_group, {
                n: sumsq(grads[n] + wd * params[n])
                for n in trainer.table_names})
            gnorm = chain_second_half(trainer, loss, grads, table_sq,
                                      state.opt_state)
            lr = state.opt_state.lr
            for n in trainer.table_names:
                topt = state.table_opt[n]
                fused_table_adam(params[n].data, topt.mu, topt.nu, grads[n],
                                 lr, wd, gnorm, clip, state.step)
        return loss

    def replicated_pairs(fids, ct):
        """The data group's (id, cotangent) stream of a table, sorted."""
        return sort_pairs(
            collectives.all_gather_rows(data_group, fids.to(torch.int32)),
            collectives.all_gather_rows(data_group, ct))

    def sparse_fused_step(trainer, ids, dense, labels, weights):
        state = trainer.state
        with tracing.span("step.forward"):
            gathered = gather_group_rows(model.embedding, ids)
            rows_in = {k: rows.requires_grad_()
                       for k, (rows, _) in gathered.items()}
            loss = forward_loss(ids, dense, labels, weights, rows_in)
        with tracing.span("step.backward"):
            grads, cts = grads_of(loss, dense_names, rows_in.values())
        with tracing.span("step.update"), torch.no_grad():
            # <ct, rows> on each rank's own pairs, summed with the
            # gradients; the pairs are all-gathered, not the rows
            loss, grads, dots = reduce_partials(loss, grads, [
                torch.sum(ct * rows)
                for (rows, _), ct in zip(gathered.values(), cts)])
            # name -> (sorted slab-local or global ids, cotangents, whether
            # the ids are global: the kernel takes them shifted)
            pairs, table_sq = {}, {}
            for (key, (_, fids)), ct, dotgp in zip(gathered.items(), cts,
                                                    dots):
                name = f"embedding.{key}"
                got = (embedding_shard.route_sorted_pairs(
                    mesh, slab_logical[name])(fids, ct) if routed else None)
                if got is None or got[3]:  # replicated, or overflowed
                    sids, sorted_ct = replicated_pairs(fids, ct)
                    pairs[name] = (sids, sorted_ct, sharded)
                    ssq = segment_sumsq(sids, sorted_ct)
                else:
                    pairs[name] = (got[0], got[1], False)
                    ssq = got[2]
                table_sq[name] = (ssq + (2.0 * wd) * dotgp
                                  + (wd * wd) * state.table_psq[name])
            gnorm = chain_second_half(trainer, loss, grads, table_sq,
                                      state.opt_state)
            lr = state.opt_state.lr
            psq = {}
            for name, (sids, sorted_ct, shift) in pairs.items():
                if shift:
                    sids = slab_ids(sids, j, slab_logical[name])
                topt = state.table_opt[name]
                *_, psq[name] = sparse_table_adam(
                    params[name].data, topt.mu, topt.nu, sids, sorted_ct,
                    lr, wd, gnorm, clip, state.step,
                    pack=trainer._table_pack[name],
                )
            state.table_psq.update(table_sumsq(model_group, psq))
        return loss

    def lazy_step(trainer, ids, dense, labels, weights):
        state = trainer.state
        with tracing.span("step.forward"):
            loss = forward_loss(ids, dense, labels, weights)
            if l2 > 0 and (not dp or mesh.data_index == 0):
                loss = loss + embedding_l2_loss(params, l2,
                                                exclude_tables=True)
        with tracing.span("step.backward"):
            grads, _ = grads_of(loss, order)
        with tracing.span("step.update"), torch.no_grad():
            loss, grads, _ = reduce_partials(loss, grads)
            gnorm = tx.norm(grads) if clip > 0 or debug_nans else None
            check_finite(trainer, loss, gnorm)
            if clip > 0:
                scale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-12),
                                    max=1.0)
            else:
                scale = torch.ones((), device=loss.device)
            tx.apply({n: grads[n] * scale for n in order
                      if not _is_table_name(n)}, params, state.opt_state)
            batch_ids = (collectives.all_gather_rows(data_group,
                                                     ids.to(torch.int32))
                         if dp else ids)
            for key, row_ids in table_ids_for_batch(model.embedding,
                                                    batch_ids).items():
                name = f"embedding.{key}"
                if sharded:
                    slab = params[name].shape[0]
                    row_ids = slab_rows(row_ids, j * slab, slab)
                lazy_adam_table_update(
                    params[name].data, grads[name], state.table_opt[name],
                    row_ids, lr=state.opt_state.lr, step=state.step, l2=l2,
                    grad_scale=scale)
        return loss

    step_fn = {
        "plain": plain_step,
        "two_pass": two_pass_step,
        "sparse_fused": sparse_fused_step,
        "lazy": lazy_step,
    }[trainer.path]

    def train_step(trainer, ids, dense, labels, weights):
        loss = step_fn(trainer, ids, dense, labels, weights)
        trainer.state.step = trainer.state.step + 1
        return loss.detach()

    # the plain and two-pass paths' loss and gradients, before and after
    # the all-reduce (chip_smoke.py's gradient checks)
    train_step.forward_backward = forward_backward
    train_step.reduce_partials = reduce_partials
    return train_step
