"""Placement over the mesh: which leaves live where, which rows a rank takes.

Port of ``deepfm_tpu/parallel/sharding.py`` at a model axis of 1. The
JAX package's rule row-shards the embedding tables ("table_w*",
"fo_table") over the model axis and replicates every other leaf; with a
model axis of 1 (the only one the port builds, ROADMAP queue 1 item
10(a)) that rule replicates every leaf, optimizer state included, on
every rank. The batch is split over the data axis: rank r of a
world of W holds rows [r * B / W, (r + 1) * B / W) of a global batch of
B rows, the rows GSPMD gives device r (``batch_shardings``).

Replicas are checked, not trusted: ``check_replicated`` all-gathers a
fingerprint of every replicated tensor and raises where a rank's bits
differ (the ``Trainer`` at construction; ``chip_smoke.py`` after every
step).
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.parallel.mesh import Mesh

TABLE_PARAM_PREFIXES = ("table_w", "fo_table")
FINGERPRINT_CHUNK = 1 << 24  # elements hashed at once


def is_table_path(name: str) -> bool:
    """Whether a parameter name (``embedding.table_w16``) is an embedding
    table's."""
    return any(part.startswith(TABLE_PARAM_PREFIXES)
               for part in name.split("."))


def placement(mesh: Mesh | None, name: str) -> str:
    """Where a leaf lives: "replicated" on every rank, or "rows over
    model" for a table on a model axis above 1 (which ``build_mesh``
    refuses until ROADMAP queue 1 item 10(b))."""
    if mesh is not None and mesh.model > 1 and is_table_path(name):
        return "rows over model"
    return "replicated"


def check_batch(mesh: Mesh | None, batch_size: int) -> None:
    """Refuse a global batch that the data axis does not divide (GSPMD
    cannot split it either), before any data is built."""
    if mesh is not None and batch_size % mesh.data:
        raise ValueError(
            f"training.batch_size {batch_size} is not divisible by the "
            f"mesh's data axis {mesh.data}: each rank takes batch_size / "
            "data rows of every global batch")


def batch_rows(mesh: Mesh | None, n: int) -> slice:
    """The rank's rows of a global batch of ``n`` rows (every row without
    a mesh); ``n`` must divide by the data axis (``check_batch``)."""
    if mesh is None:
        return slice(0, n)
    check_batch(mesh, n)
    per = n // mesh.data
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def split_bounds(world: int, n: int, block: int) -> list[tuple[int, int]]:
    """Each rank's contiguous share (lo, hi) of ``n`` rows cut in blocks of
    ``block`` rows (a split scored in batches): whole blocks, the ranks'
    counts differing by at most one block, so each batch is the one a
    single process would score."""
    blocks = -(-n // block)
    return [(min(n, blocks * r // world * block),
             min(n, blocks * (r + 1) // world * block))
            for r in range(world)]


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """An int64 hash of ``t``'s bits and their positions (0-dim, on
    ``t``'s device): the sum, modulo 2^64, of each element's bits as an
    integer times a weight of its position below 2^16, so a change in one
    element always changes it."""
    x = t.detach().reshape(-1)
    if x.is_floating_point():
        x = x.view({2: torch.int16, 4: torch.int32,
                    8: torch.int64}[x.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, x.numel(), FINGERPRINT_CHUNK):
        part = x[start:start + FINGERPRINT_CHUNK].long()
        weight = torch.arange(start, start + part.numel(),
                              device=x.device) % 65521 + 1
        total += torch.sum(part * weight)
    return total


def check_replicated(mesh: Mesh | None, tensors: dict[str, torch.Tensor],
                     what: str) -> None:
    """Raise RuntimeError unless every rank holds the same bits in each of
    ``tensors`` (name -> tensor): one all-gather of their fingerprints.
    Nothing without a mesh of more than one rank."""
    from deepfm_tpu_torch.parallel import collectives

    if mesh is None or mesh.world == 1:
        return
    names = list(tensors)
    mine = torch.stack([fingerprint(tensors[n]).to(mesh.device)
                        for n in names])
    every = collectives.all_gather_rows(mesh, mine[None])
    differ = (every != every[0]).any(dim=0).nonzero().flatten().tolist()
    if differ:
        raise RuntimeError(
            f"the ranks' replicas differ in {what}: "
            f"{[names[i] for i in differ[:8]]} ({len(differ)} of "
            f"{len(names)} tensors)")
