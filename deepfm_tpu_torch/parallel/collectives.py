"""The collectives of the distributed step, each over a group of ranks.

Every function takes the group it runs on first: a ``Group`` of a
``Mesh`` (``mesh.data_group``, ``mesh.model_group``, ``mesh.world_group``),
a ``Mesh`` itself (its world), or None. A group of one rank, or None, makes
the collective an identity, so a mesh-less run, and a mesh axis of 1,
take no collective at all.

* ``all_reduce_`` sums a tensor over the group in place;
* ``all_reduce_flat`` sums a list of tensors in one call: they are laid
  end to end in one f32 buffer, reduced, and cut apart again (the step's
  one all-reduce of the dense gradients, not one call per leaf);
* ``all_reduce_sum`` is the sum that autograd differentiates: its
  backward sums the incoming gradient over the group too (BatchNorm's
  statistics over the data group, ``ops/dnn.py``);
* ``model_sum`` is the sum of the psum lookup's masked rows over the
  model group (``parallel/embedding_shard.py``), whose backward passes
  the cotangent through unchanged: the model peers' losses are copies of
  one another, so summing their cotangents would count each row m times;
* ``any_over`` is the MAX all-reduce of a flag, read on the host: the
  routed paths' overflow, agreed before they choose their collectives;
* ``all_gather_rows`` concatenates each rank's rows along dim 0 in the
  group's order (the (id, cotangent) pairs of the sparse gradient
  exchange, a split's scores, a table's slabs); every rank passes the
  same number of rows;
* ``all_to_all_rows`` cuts each rank's rows into as many equal chunks as
  the group has ranks and hands chunk k to rank k: rank k receives the
  chunks addressed to it, the group's ranks' in order (the all-to-all
  lookup's id buckets and rows);
* ``broadcast_`` hands rank ``src``'s tensor to every rank of the group,
  in place (a sharded ``serve``'s requests, from rank 0 to the followers,
  ``serving.py``);
* ``ring_shift`` passes each rank's tensor to the next rank of the group
  (position i to i + 1, the last to the first), the hop that autograd
  differentiates: its backward passes the cotangent the other way (ring
  attention's K/V blocks, ``parallel/ring_attention.py``); it is one
  ``all_to_all_single`` whose split sizes send the whole tensor to the
  next rank and nothing to the others;
* ``barrier``.

Every rank receives the same bits: an all-reduce's sum is formed once and
handed to every rank of the group by NCCL and by gloo alike.

Where a tensor meets its backend: NCCL takes CUDA tensors only, so a
CPU tensor (a generator's state) is copied to the rank's card and back
(``_staged``). gloo takes CPU tensors and, in the PyTorch of the card's
host (2.11), CUDA tensors in all_reduce, all_gather, all_to_all_single
(with split sizes too: ``ring_shift``) and barrier (``chip_smoke.py``'s
data_parallel, model_sharded and sharded_scoring phases run them so on
one H100), copying them through the host itself, so nothing is staged by
hand for it; ``broadcast_`` is given host tensors by its one caller. A
collective that fails raises; nothing retries it.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.parallel.mesh import Group, Mesh


def _group(g) -> Group | None:
    """The group a collective runs on, or None for an identity."""
    if isinstance(g, Mesh):
        g = g.world_group
    return g if g is not None and g.size > 1 else None


def _staged(group: Group, t: torch.Tensor) -> torch.Tensor:
    """``t`` where its backend takes it: a card copy of a CPU tensor under
    NCCL, else ``t`` itself."""
    if group.backend == "nccl" and t.device.type != "cuda":
        return t.to(group.device)
    return t


def all_reduce_(group, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` over the group ("sum" or "max"), in place; returns
    ``t``."""
    import torch.distributed as dist

    g = _group(group)
    if g is None:
        return t
    buf = _staged(g, t.contiguous())
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=g.handle)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def all_reduce_flat(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sums over the group of ``tensors`` (f32, one device), in one
    all-reduce of one flat buffer; new tensors of the inputs' shapes."""
    if _group(group) is None or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(group, flat)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose gradient is the sum over the group of
    the incoming gradients: every rank's loss depends on every rank's
    input through the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(group, t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(ctx.group, grad.clone()), None


def all_reduce_sum(group, t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``t`` over the group (``t`` on one
    rank)."""
    if _group(group) is None:
        return t
    return _AllReduceSum.apply(t, group)


class _ModelSum(torch.autograd.Function):
    """A sum over the model group whose gradient is the incoming gradient
    as it is (module docstring)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_(group, t.clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_sum(group, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the model group, its backward an identity."""
    if _group(group) is None:
        return t
    return _ModelSum.apply(t, group)


def any_over(group, flag: torch.Tensor | bool) -> bool:
    """Whether ``flag`` is true on any rank of the group: one MAX
    all-reduce and one host read."""
    if not isinstance(flag, torch.Tensor):
        flag = torch.tensor(bool(flag))
    g = _group(group)
    dev = flag.device if g is None else g.device
    buf = flag.reshape(1).to(dev, torch.int32)
    return bool(all_reduce_(g, buf, op="max").item())


def all_gather_rows(group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (n, ...) stacked along dim 0 in the group's order:
    (size * n, ...), on ``t``'s device. Every rank must pass the same n."""
    import torch.distributed as dist

    g = _group(group)
    if g is None:
        return t
    buf = _staged(g, t.contiguous())
    out = torch.empty((g.size * buf.shape[0], *buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    n = buf.shape[0]
    dist.all_gather([out[r * n:(r + 1) * n] for r in range(g.size)],
                    buf, group=g.handle)
    return out.to(t.device)


def all_to_all_rows(group, t: torch.Tensor) -> torch.Tensor:
    """``t`` (size * k, ...) cut into the group's size chunks of k rows,
    chunk r sent to the group's r-th rank; returns the chunks received, in
    the group's order, shaped as ``t``."""
    import torch.distributed as dist

    g = _group(group)
    if g is None:
        return t
    if t.shape[0] % g.size:
        raise ValueError(f"{t.shape[0]} rows do not split over {g.size} "
                         "ranks")
    buf = _staged(g, t.contiguous())
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=g.handle)
    return out.to(t.device)


def broadcast_(group, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` on every rank of the group with the ``src``-th rank's
    (its position in the group); returns ``t``. Every rank passes a tensor
    of the same shape and dtype."""
    import torch.distributed as dist

    g = _group(group)
    if g is None:
        return t
    buf = _staged(g, t.contiguous())
    dist.broadcast(buf, src=g.ranks[src], group=g.handle)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def _shift(g: Group, t: torch.Tensor, step: int) -> torch.Tensor:
    """``t`` of the rank ``step`` places before this one in the group: this
    rank's ``t`` goes to the rank ``step`` places after it."""
    import torch.distributed as dist

    buf = _staged(g, t.contiguous())
    send = [0] * g.size
    recv = [0] * g.size
    send[(g.index + step) % g.size] = buf.shape[0]
    recv[(g.index - step) % g.size] = buf.shape[0]
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, output_split_sizes=recv,
                           input_split_sizes=send, group=g.handle)
    return out.to(t.device)


class _RingShift(torch.autograd.Function):
    """The hop one place along the group; its gradient is the hop back."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(group, t, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(ctx.group, grad, -1), None


def ring_shift(group, t: torch.Tensor) -> torch.Tensor:
    """The ``t`` of the rank before this one in the group (position i
    receives from i - 1 and sends its own to i + 1, modulo the size); the
    backward sends the cotangent back, from i + 1 to i. Every rank passes
    a tensor of the same shape."""
    g = _group(group)
    if g is None:
        return t
    return _RingShift.apply(t, g)


def barrier(group) -> None:
    """Wait until every rank of the group gets here."""
    import torch.distributed as dist

    g = _group(group)
    if g is None:
        return
    if g.backend == "nccl":
        dist.barrier(group=g.handle, device_ids=[g.device.index])
    else:
        dist.barrier(group=g.handle)
