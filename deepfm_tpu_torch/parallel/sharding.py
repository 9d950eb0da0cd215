"""Placement over the mesh: which leaves live where, which rows a rank takes.

Port of ``deepfm_tpu/parallel/sharding.py`` (ROADMAP queue 1 item 10(b)
for the model axis). The embedding tables
("table_w*", "fo_table") are row-sharded over the model axis, and so are
their moments and, on the plain chain, their optimizer leaves: a table of
R rows (physical rows for a packed table) is cut into m slabs of R / m
rows, and the rank at model index j holds rows [j * R / m, (j + 1) * R /
m), logical ids [j * R / m * pack, (j + 1) * R / m * pack)
(``slab_bounds``). Every other leaf is replicated on every rank. A model
axis that does not divide a table's rows is refused (GSPMD pads uneven
shards; the port has no counterpart). The tables are padded to 128 rows,
so every m that divides 128 divides them.

The batch is split over the data axis: the ranks of data index i hold rows
[i * B / dp, (i + 1) * B / dp) of a global batch of B rows, the rows GSPMD
gives that mesh row (``batch_shardings``); its m model peers hold the same
rows.

Replicas are checked, not trusted: ``check_replicated`` all-gathers a
fingerprint of every tensor over a group and raises where a rank's bits
differ (replicated leaves over the world, slabs and their moments over
the data group: the ``Trainer`` at construction; ``chip_smoke.py`` after
every step).
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
    model" for a table (or a table's moment) on a model axis above 1."""
    if mesh is not None and mesh.model > 1 and is_table_path(name):
        return "rows over model"
    return "replicated"


def sharded(mesh: Mesh | None) -> bool:
    """Whether the mesh row-shards the tables (a model axis above 1)."""
    return mesh is not None and mesh.model > 1


def slabs_without_exchange(mesh: Mesh | None, strategy: str) -> bool:
    """Whether the tables are slabs looked up without the sparse gradient
    exchange: ``embedding_strategy`` "auto" at a model axis above 1, the
    JAX package's GSPMD lookup. The tables stay logical, the sparse-fused
    path is not taken, and the slab's dense gradient from the lookup's
    backward is summed over the data group by the step's all-reduce."""
    return sharded(mesh) and strategy == "auto"


def routed(mesh: Mesh | None, strategy: str) -> bool:
    """Whether the slabs' gradient pairs are routed to their owners
    (``embedding_strategy`` "all_to_all" at a model axis above 1)."""
    return sharded(mesh) and strategy == "all_to_all"


def check_model_axis(model: int, rows: int, name: str = "a table") -> None:
    """Refuse a model axis that does not divide a table's rows."""
    if rows % model:
        raise ValueError(
            f"{name} has {rows} rows, which the mesh's model axis {model} "
            "does not divide: each rank holds rows / model rows of every "
            "table (a model axis that divides 128 divides every table)")


def slab_bounds(mesh: Mesh, rows: int) -> tuple[int, int]:
    """[lo, hi): the rows of a table of ``rows`` (physical) rows that the
    rank's slab holds."""
    check_model_axis(mesh.model, rows)
    per = rows // mesh.model
    return mesh.model_index * per, (mesh.model_index + 1) * per


def state_shardings(mesh: Mesh | None, names) -> dict[str, str]:
    """Each leaf's ``placement`` (the JAX function's NamedSharding tree)."""
    return {n: placement(mesh, n) for n in names}


def replicated(mesh: Mesh | None) -> str:
    """The placement of a replicated leaf."""
    return "replicated"


def batch_shardings(mesh: Mesh | None, tree: dict) -> dict[str, slice]:
    """The rank's rows (``batch_rows``) of each batch array of ``tree``
    (name -> array of global batch rows)."""
    return {k: batch_rows(mesh, len(v)) for k, v in tree.items()}


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
    a mesh): its data index's share, the same on its model peers; ``n``
    must divide by the data axis (``check_batch``)."""
    if mesh is None:
        return slice(0, n)
    check_batch(mesh, n)
    per = n // mesh.data
    i = mesh.data_index
    return slice(i * per, (i + 1) * per)


def split_bounds(parts: int, n: int, block: int) -> list[tuple[int, int]]:
    """Each data index's contiguous share (lo, hi) of ``n`` rows cut in
    blocks of ``block`` rows (a split scored in batches): whole blocks, the
    shares differing by at most one block, so each batch is the one a
    single process would score."""
    blocks = -(-n // block)
    return [(min(n, blocks * r // parts * block),
             min(n, blocks * (r + 1) // parts * block))
            for r in range(parts)]


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


def check_replicated(group, tensors: dict[str, torch.Tensor],
                     what: str) -> None:
    """Raise RuntimeError unless every rank of ``group`` (a mesh's
    ``Group``, or a ``Mesh`` for its world) holds the same bits in each of
    ``tensors`` (name -> tensor): one all-gather of their fingerprints.
    Nothing on a group of one rank; every rank of the group must call it
    with the same names."""
    from deepfm_tpu_torch.parallel import collectives

    g = collectives._group(group)
    if g is None:
        return
    names = list(tensors)
    if not names:
        return
    mine = torch.stack([fingerprint(tensors[n]).to(g.device)
                        for n in names])
    every = collectives.all_gather_rows(g, mine[None])
    differ = (every != every[0]).any(dim=0).nonzero().flatten().tolist()
    if differ:
        raise RuntimeError(
            f"the ranks' replicas differ in {what}: "
            f"{[names[i] for i in differ[:8]]} ({len(differ)} of "
            f"{len(names)} tensors)")


def check_placement(mesh: Mesh | None, tensors: dict[str, torch.Tensor],
                    what: str) -> None:
    """``check_replicated`` by placement: the replicated tensors over the
    world, the slabs (a name with a table part, ``is_table_path``) over
    the data group. Every rank must call it."""
    if mesh is None or mesh.world == 1:
        return
    slabs = {n for n, where in state_shardings(mesh, tensors).items()
             if where != replicated(mesh)}
    check_replicated(mesh.world_group,
                     {n: t for n, t in tensors.items() if n not in slabs},
                     what)
    if slabs:
        check_replicated(mesh.data_group,
                         {n: tensors[n] for n in tensors if n in slabs},
                         f"{what} (the table slabs, over the data group)")
