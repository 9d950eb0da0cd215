"""Ring attention over the FIELD axis, on ``torch.distributed``.

Port of ``deepfm_tpu/parallel/ring_attention.py``: softmax attention over
fields with the field axis cut over the mesh's model axis, the K/V blocks
passed around the ring of a data row's m ranks (streaming log-sum-exp
accumulators, one hop a step). At reference field counts (F ~= 16) it is
pointless; production schemas reach hundreds of fields, where the (B, F,
F) scores and the (B, F, D) activations are worth cutting over the fields.
As in the JAX package it is a standalone op with a parity test
(tests/test_torch_ring_attention.py): AttentionDeepFM keeps its fused
block (``ops/attention.py``), and no model calls this op.

The JAX op takes the whole (B, F, H, Dh) arrays and a ``shard_map`` cuts
them with ``P(None, "model", None, None)``; the port runs one rank a
device, so ``ring_field_attention`` takes this rank's field block (B,
F/m, H, Dh) of q, k and v (``field_block`` cuts it) and returns this
rank's block of the output. The batch is not cut: every data row of ranks
runs its own ring over its model group, on whatever rows it holds. Step s
attends the resident queries to the KV block that started on model index
(me - s) % m, folded into f32 running (max, sum, acc) accumulators; after
m steps every query has attended to every key once, which is unsharded
softmax attention to f32 roundoff.

The K and V blocks travel together as one stacked tensor, one
``collectives.ring_shift`` a hop, whose backward passes the cotangent back
the other way (JAX gets it from ``ppermute``'s transpose). The JAX scan
rotates m times; its last rotation only brings the blocks home, so the
port takes m - 1 hops for the same output. No kernel is written by hand:
the JAX body is ``jnp.einsum`` outside any Pallas kernel, and here it is
``torch.einsum``.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.mesh import Mesh


def _scale(q: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(Dh) formed in q's dtype (the JAX op's)."""
    dh = torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device)
    return 1.0 / torch.sqrt(dh)


def _ring_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
               m: int) -> torch.Tensor:
    """This rank's output block: q (B, Fq, H, Dh) against the m KV blocks
    of the ring, this rank's first."""
    b, fq, h, dh = q.shape
    scale = _scale(q)
    acc = torch.zeros((b, fq, h, dh), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, fq, h), -torch.inf, dtype=torch.float32,
                         device=q.device)
    row_sum = torch.zeros((b, fq, h), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(m):
        k_blk, v_blk = kv[0], kv[1]
        scores = torch.einsum("bqhd,bkhd->bqhk", q, k_blk).float() * scale
        new_max = torch.maximum(row_max, scores.amax(dim=-1))
        correction = torch.exp(row_max - new_max)
        p = torch.exp(scores - new_max[..., None])
        row_sum = row_sum * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p, v_blk.float())
        row_max = new_max
        if step < m - 1:
            # the block of the rank before this one (me - step - 1)
            kv = collectives.ring_shift(group, kv)
    return (acc / row_sum[..., None]).to(q.dtype)


def field_block(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of fields of ``x`` (B, F, ...): fields [j * F / m,
    (j + 1) * F / m) at model index j of a model axis m; ``x`` itself
    without a mesh or at m = 1. F must divide by m (the JAX op's
    message)."""
    m = 1 if mesh is None else mesh.model
    if m == 1:
        return x
    f = x.shape[1]
    if f % m != 0:
        raise ValueError(f"F={f} must divide model axis {m}")
    per = f // m
    return x[:, mesh.model_index * per:(mesh.model_index + 1) * per]


def ring_field_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: Mesh | None) -> torch.Tensor:
    """Softmax attention over fields with F cut over the model axis.

    q / k / v: this rank's field block (B, F/m, H, Dh) (``field_block``),
    the same shape on every rank of the model group; returns this rank's
    block of the output, numerically equal to unsharded softmax attention.
    Without a mesh, or at a model axis of 1, q / k / v are the whole (B,
    F, H, Dh) and the attention is the plain one, in q's dtype.
    """
    m = 1 if mesh is None else mesh.model
    if m == 1:
        s = torch.einsum("bqhd,bkhd->bqhk", q, k) * _scale(q)
        return torch.einsum("bqhk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return _ring_body(q, k, v, mesh.model_group, m)
