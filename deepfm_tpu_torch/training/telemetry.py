"""Engagement telemetry: which backward path and kernels a Trainer used.

Port of ``deepfm_tpu/training/telemetry.py::trainer_engagement``: a
JSON-ready dict recorded in results.json's ``training_info``, with the same
keys. ``backward`` is the label ``_backward_path`` gives for the same gates
and mesh (a sparse-fused path is "sparse_fused_replicated" at a model
axis of 1, and above it "sparse_fused_routed" under the all_to_all
strategy, else "sparse_fused_sharded"). ``kernels`` does not come from
the gates: it lists the port's CUDA kernels whose launch counters
(``ops/kernels/__init__.py::launch_counts``) rose since ``since``, so it
records what ran; under a mesh, what ran on every rank (the counters are
all-gathered, and every rank takes part). It is empty on the CPU, where
every wrapper takes its plain version. The JAX package's ``lowered_kernel_names`` and
``expected_mosaic_kernels`` read TPU HLO and are not ported.
"""

from __future__ import annotations

import torch

from deepfm_tpu_torch.ops.kernels import launch_counts
from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.sharding import routed

__all__ = ["trainer_engagement"]


def _backward_path(trainer) -> str:
    """The JAX package's label for the trainer's resolved path."""
    mesh = trainer.mesh
    if trainer.sparse_fused:
        if mesh is None:
            return "sparse_fused"
        if mesh.model == 1:
            return "sparse_fused_replicated"
        if routed(mesh, trainer.config.mesh.embedding_strategy):
            return "sparse_fused_routed"
        return "sparse_fused_sharded"
    if trainer.lazy_tables:
        return "lazy_adam"
    if trainer.fused_tables:
        return "fused_two_pass"
    return "plain_optax"


def trainer_engagement(trainer, since: dict[str, int] | None = None) -> dict:
    """The trainer's backward path, the kernels launched since the counts
    ``since`` (every kernel launched so far when None), its table layout
    and its mesh's shape (None: one device without a mesh)."""
    since = since or {}
    counts = launch_counts()
    rose = torch.tensor([[count - since.get(name, 0)
                          for name, count in counts.items()]],
                        dtype=torch.int64)
    every = collectives.all_gather_rows(trainer.mesh, rose).amin(dim=0)
    return {
        "backward": _backward_path(trainer),
        "kernels": [name for name, n in zip(counts, every.tolist())
                    if n > 0],
        "table_layout": trainer.model.table_layout,
        "mesh": None if trainer.mesh is None else trainer.mesh.shape,
    }
