"""The collectives the data-parallel step takes, over a ``Mesh``'s ranks.

* ``all_reduce_`` sums a tensor over the ranks in place;
* ``all_reduce_flat`` sums a list of tensors in one call: they are laid
  end to end in one f32 buffer, reduced, and cut apart again (the step's
  one all-reduce of the dense gradients, not one call per leaf);
* ``all_reduce_sum`` is the sum that autograd differentiates: its
  backward sums the incoming gradient over the ranks too (BatchNorm's
  global statistics, ``ops/dnn.py``);
* ``all_gather_rows`` concatenates each rank's rows along dim 0, rank 0's
  first (the (id, cotangent) pairs of the sparse gradient exchange, a
  split's scores); every rank passes the same number of rows;
* ``barrier``.

Each is an identity on a world of one rank, so a mesh-less run takes no
collective at all. Every rank receives the same bits: an all-reduce's sum
is formed once and handed to every rank by NCCL and by gloo alike.

Where a tensor meets its backend: NCCL takes CUDA tensors only, so a
CPU tensor (a generator's state) is copied to the rank's card and back
(``_staged``). gloo takes CPU tensors and, in the PyTorch of the card's
host (2.11), CUDA tensors in every collective used here (all_reduce,
all_gather, barrier: ``chip_smoke.py``'s data_parallel phase runs them
so on one H100), copying them through the host itself, so nothing is
staged by hand for it. A collective that fails raises; nothing retries
it.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.parallel.mesh import Mesh


def _active(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.world > 1


def _staged(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where its backend takes it: a card copy of a CPU tensor under
    NCCL, else ``t`` itself."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return t.to(mesh.device)
    return t


def all_reduce_(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    import torch.distributed as dist

    if not _active(mesh):
        return t
    buf = _staged(mesh, t.contiguous())
    dist.all_reduce(buf, group=mesh.group)
    if buf.data_ptr() != t.data_ptr():
        t.copy_(buf)
    return t


def all_reduce_flat(mesh: Mesh | None,
                    tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sums over the ranks of ``tensors`` (f32, one device), in one
    all-reduce of one flat buffer; new tensors of the inputs' shapes."""
    if not _active(mesh) or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    all_reduce_(mesh, flat)
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum over the ranks of
    the incoming gradients: every rank's loss depends on every rank's
    input through the sum."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_(mesh, t.clone())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(ctx.mesh, grad.clone()), None


def all_reduce_sum(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``t`` over the ranks (``t`` on one
    rank)."""
    if not _active(mesh):
        return t
    return _AllReduceSum.apply(t, mesh)


def all_gather_rows(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (n, ...) stacked along dim 0 in rank order:
    (world * n, ...), on ``t``'s device. Every rank must pass the same n."""
    import torch.distributed as dist

    if not _active(mesh):
        return t
    buf = _staged(mesh, t.contiguous())
    out = torch.empty((mesh.world * buf.shape[0], *buf.shape[1:]),
                      dtype=buf.dtype, device=buf.device)
    n = buf.shape[0]
    dist.all_gather([out[r * n:(r + 1) * n] for r in range(mesh.world)],
                    buf, group=mesh.group)
    return out.to(t.device)


def barrier(mesh: Mesh | None) -> None:
    """Wait until every rank gets here."""
    import torch.distributed as dist

    if _active(mesh):
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)
