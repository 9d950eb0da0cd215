"""Rank targets of the port's model-sharded CPU tests, spawned by
``tests/torch_dp_worker.py::spawn`` on a (data, model) mesh of gloo ranks.
This module imports no JAX: the JAX oracle runs in the test process.
"""

from __future__ import annotations

import numpy as np
import torch


def _constants(factors: dict | None):
    """Set ``parallel/embedding_shard.py``'s capacity factors for a case
    and zero its fallback counts; returns a function that puts the
    factors back."""
    from deepfm_tpu_torch.parallel import embedding_shard as es

    saved = {k: getattr(es, k) for k in (factors or {})}
    for k, v in (factors or {}).items():
        setattr(es, k, v)
    for k in es.fallbacks:
        es.fallbacks[k] = 0
    return lambda: [setattr(es, k, v) for k, v in saved.items()]


def lookups(mesh, cases: list[dict]) -> list[dict]:
    """Each case's lookup on the rank's slab of ``case["table"]`` (whole,
    logical (V, C), under the row-gather lookup with
    ``case["gather_kernel"]``, or packed (phys, 128) with ``case["geom"]``
    = (dcol, pack)) at the rank's data index's share of ``case["ids"]``: its rows,
    and the slab's gradient of sum(rows * up) (the exchange's, or under
    "auto" the local gradient summed over the data group by hand, as the
    step's flat all-reduce sums it), with the fallbacks each path took."""
    from deepfm_tpu_torch.parallel import (
        batch_rows,
        collectives,
        embedding_shard as es,
        make_lookup_fn,
        make_packed_lookup_factory,
        slab_bounds,
    )

    out = []
    for case in cases:
        restore = _constants(case.get("factors"))
        try:
            whole = torch.from_numpy(case["table"])
            lo, hi = slab_bounds(mesh, whole.shape[0])
            slab = whole[lo:hi].clone().requires_grad_()
            ids = torch.from_numpy(case["ids"])
            up = torch.from_numpy(case["up"])
            rows = batch_rows(mesh, ids.shape[0])
            if case["geom"] is None:
                lookup = make_lookup_fn(mesh, case["strategy"],
                                        case["gather_kernel"])
            else:
                lookup = make_packed_lookup_factory(
                    mesh, case["strategy"])(*case["geom"])
            got = lookup(slab, ids[rows])
            (got * up[rows]).sum().backward()
            grad = slab.grad
            if case["strategy"] == "auto":
                grad = collectives.all_reduce_(mesh.data_group, grad.clone())
            out.append({"rows": got.detach(), "grad": grad,
                        "fallbacks": dict(es.fallbacks)})
        finally:
            restore()
    return out


def routing(mesh, cases: list[dict]) -> list[dict]:
    """``route_sorted_pairs`` of each case's (ids, ct) stream (the rank's
    data index's share) over slabs of ``case["rows"]`` logical rows, at the
    case's capacity factors."""
    from deepfm_tpu_torch.parallel import batch_rows, route_sorted_pairs

    out = []
    for case in cases:
        restore = _constants(case.get("factors"))
        try:
            rows = batch_rows(mesh, len(case["ids"]))
            sids, cts, ssq, ovf = route_sorted_pairs(mesh, case["rows"])(
                torch.from_numpy(case["ids"][rows]),
                torch.from_numpy(case["ct"][rows]))
            out.append({"sids": sids, "cts": cts,
                        "ssq": None if ssq is None else float(ssq),
                        "ovf": ovf})
        finally:
            restore()
    return out


def mesh_groups(mesh) -> dict:
    """The rank's place in the mesh and its groups' ranks."""
    def ranks(g):
        return None if g is None else list(g.ranks)

    return {"rank": mesh.rank, "data_index": mesh.data_index,
            "model_index": mesh.model_index,
            "data_group": ranks(mesh.data_group),
            "model_group": ranks(mesh.model_group),
            "world_group": ranks(mesh.world_group)}


def collectives_on_groups(mesh) -> dict:
    """Each collective over the rank's groups on values that name the
    rank: all_gather_rows, all_reduce_ (sum and max), any_over,
    all_to_all_rows, model_sum's forward and backward."""
    from deepfm_tpu_torch.parallel import collectives

    r = float(mesh.rank)
    out = {}
    for name, g in (("data", mesh.data_group), ("model", mesh.model_group),
                    ("world", mesh.world_group)):
        size = 1 if g is None else g.size
        out[name] = {
            "gather": collectives.all_gather_rows(
                g, torch.tensor([[r, r + 0.5]])).tolist(),
            "sum": collectives.all_reduce_(g, torch.tensor([r])).item(),
            "max": collectives.all_reduce_(g, torch.tensor([r]),
                                           op="max").item(),
            "any": collectives.any_over(g, mesh.rank == size - 1),
            "a2a": collectives.all_to_all_rows(
                g, torch.arange(size, dtype=torch.float32) + 10 * r
            ).tolist(),
        }
    x = torch.tensor([r + 1.0], requires_grad=True)
    y = collectives.model_sum(mesh.model_group, x * 3.0)
    y.sum().backward()
    out["model_sum"] = {"value": y.item(), "grad": x.grad.item()}
    return out


def slab_refusal(mesh, rows: int) -> str | None:
    """The refusal of a table of ``rows`` rows on the mesh, if any."""
    from deepfm_tpu_torch.parallel import slab_bounds

    try:
        slab_bounds(mesh, rows)
    except ValueError as e:
        return str(e)
    return None


def np_stream(n: int, rows: int, dcol: int, seed: int, skew: int | None):
    """ids in [0, rows) (all in [skew, rows) when ``skew`` is given) and
    normal cotangents (n, dcol), seeded."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0 if skew is None else skew, rows, n).astype(np.int64)
    return ids, rng.normal(size=(n, dcol)).astype(np.float32)


def ring_attention(mesh, cases: list[dict]) -> list[dict]:
    """Each case's ``ring_field_attention`` at its (data, model) ``axes``
    (the spawned mesh, or one built for the case by every rank): the rank
    takes its data index's rows of the whole (B, F, H, Dh) ``q`` / ``k`` /
    ``v`` (each data row runs its own ring) and its field block, in the
    case's ``dtype``; returns its output block and, with ``grads``, the
    gradients of its block of q, k and v by sum(out²) (summed over the
    ranks, the whole loss: the hops carry the gradient between them)."""
    from deepfm_tpu_torch.parallel import (
        batch_rows,
        build_mesh,
        field_block,
        ring_field_attention,
    )

    meshes = {(mesh.data, mesh.model): mesh}
    out = []
    for case in cases:
        axes = tuple(case["axes"])
        if axes not in meshes:
            meshes[axes] = build_mesh(*axes, device="cpu")
        m = meshes[axes]
        dtype = getattr(torch, case["dtype"])
        blocks = []
        for name in ("q", "k", "v"):
            whole = torch.from_numpy(case[name])
            x = field_block(m, whole[batch_rows(m, whole.shape[0])])
            blocks.append(x.to(dtype).clone().requires_grad_(case["grads"]))
        got = ring_field_attention(*blocks, m)
        rec = {"axes": axes, "data_index": m.data_index,
               "model_index": m.model_index, "out": got.detach().float()}
        if case["grads"]:
            (got.float() ** 2).sum().backward()
            rec.update({f"d{n}": b.grad.float()
                        for n, b in zip("qkv", blocks)})
        out.append(rec)
    return out
