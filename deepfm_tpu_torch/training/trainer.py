"""The train step's state, gates and trainer.

Port of ``deepfm_tpu/training/trainer.py``: ``TrainState``,
``_is_table_name``, the gates ``_use_fused_table_adam`` /
``sparse_fused_eligible`` and the ``Trainer``'s state construction and
``_train_step`` — the seam
``bench.py`` times — and its learning-rate scheduler (built as the JAX
``Trainer`` builds it: the first step runs at ``scheduler.lr``). The epoch
loop (and with it the schedulers' epoch steps), eval, staging, the mesh
and checkpoints come with later slices (ROADMAP queue 1 items 3 and 10).

The gates are resolved from the config alone, on every device: the CPU
runs each kernel's plain version, so the tests take the same paths as the
card. With the defaults (``adam``, ``fused_table_adam``,
``fused_backward``) the step takes the sparse-fused path;
``fused_backward: false`` takes the two-pass path (densify, then fused
table Adam); ``fused_table_adam: false``, ``adamw`` or ``sgd`` take the
plain optax chain. With ``pallas.use_embedding_kernel`` the row-gather
kernel is the lookup, and the step takes two-pass or plain, as in the JAX
package, whose sparse-fused gate wants the default lookup. Every path runs
on both table layouts (``pallas.table_layout``); the sparse-fused one also
on the logical layout, where the JAX package needs packed tables. The
TPU's width gate (128 // (d+1) > 1) and its f32-exact id limit do not
apply and are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.training.optim import OptState, build_optimizer
from deepfm_tpu_torch.training.schedulers import build_scheduler, set_lr
from deepfm_tpu_torch.training.sparse_opt import (
    TableSlotState,
    init_table_state,
)

@dataclass
class TrainState:
    """What a step carries besides the model's parameters and BatchNorm
    statistics (which live in the module)."""

    step: torch.Tensor  # completed steps, int32 0-dim
    opt_state: OptState
    # fused table paths: per-table Adam moments (name -> state)
    table_opt: dict[str, TableSlotState] | None = None
    # sparse-fused path: per-table sum(p^2), carried across steps from the
    # kernel so the decayed clip norm is assembled without reading the
    # table (name -> f32 0-dim)
    table_psq: dict[str, torch.Tensor] | None = None


def _is_table_name(name: str) -> bool:
    return name.split(".")[-1].startswith(("table_w", "fo_table"))


def _refuse_lazy(config: ExperimentConfig) -> None:
    if config.training.optimizer == "lazy_adam":
        raise NotImplementedError(
            "optimizer lazy_adam is not ported yet: it comes with ROADMAP "
            "queue 1 item 6 (baselines and lazy_adam)"
        )


def _use_fused_table_adam(config: ExperimentConfig) -> bool:
    """Fused table Adam (``ops/kernels/adam.py``) for the tables: Adam
    with ``training.fused_table_adam`` on."""
    return (config.training.optimizer == "adam"
            and config.training.fused_table_adam)


def sparse_fused_eligible(config: ExperimentConfig,
                          packed_schema: PackedSchema) -> bool:
    """True when the step takes the fused sparse backward-optimizer path
    (``ops/kernels/sparse_adam.py``): it gathers the rows itself, so it
    wants the default lookup, not the row-gather kernel."""
    return (
        _use_fused_table_adam(config)
        and config.training.fused_backward
        and not config.pallas.use_embedding_kernel
        and len(packed_schema.lookup_groups) > 0
    )


class Trainer:
    """Trains a CTR model on one device (``config.device``: the GPU unless
    the config asks for the CPU)."""

    def __init__(self, model: CTRModel, packed_schema: PackedSchema,
                 config: ExperimentConfig) -> None:
        _refuse_lazy(config)
        self.scheduler = build_scheduler(config.training)
        self.config = config
        self.packed_schema = packed_schema
        self.device = resolve_device(config.device)
        self.model = model.to(self.device)
        self.fused_tables = _use_fused_table_adam(config)
        self.sparse_fused = (sparse_fused_eligible(config, packed_schema)
                             and not model.embedding.gather_kernel)
        self.path = ("sparse_fused" if self.sparse_fused
                     else "two_pass" if self.fused_tables else "plain")
        self.table_names = [n for n, _ in model.named_parameters()
                            if _is_table_name(n)]
        # table name -> logical rows per physical row (1: logical layout)
        self._table_pack = {f"embedding.{k}": v
                            for k, v in model.embedding.table_pack.items()}
        self._table_layout = model.table_layout
        self.tx = build_optimizer(config, self.table_names,
                                  fused=self.fused_tables)
        self.state = self._init_state()
        # warmup: epoch 1 starts below the base LR
        set_lr(self.state.opt_state, self.scheduler.lr)
        from deepfm_tpu_torch.training.steps import build_train_step

        self._step_fn = build_train_step(self)

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    def _init_state(self) -> TrainState:
        params = self.params
        state = TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            opt_state=self.tx.init(params),
        )
        if self.fused_tables:
            mdt = getattr(torch, self.config.training.moments_dtype)
            state.table_opt = {n: init_table_state(params[n].detach(), mdt)
                               for n in self.table_names}
        if self.sparse_fused:
            state.table_psq = {n: torch.sum(params[n].detach() ** 2)
                               for n in self.table_names}
        return state

    def load_best(self, output_dir) -> dict:
        """Load a best checkpoint (either table layout) into the live model
        and re-derive the carried table sums of squares; returns the
        checkpoint's metadata."""
        from deepfm_tpu_torch.training.persistence import (
            load_best,
            recompute_table_psq,
        )

        meta = load_best(self.model, output_dir)
        recompute_table_psq(self)
        return meta

    def _as_tensor(self, x: Any, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.device, dtype)

    def _train_step(self, ids, dense, labels, weights) -> torch.Tensor:
        """One step in place (parameters, BatchNorm statistics, optimizer
        and table state); returns the weighted BCE loss (f32 0-dim, on the
        device, without the L2 term, as the JAX step logs it)."""
        return self._step_fn(
            self,
            self._as_tensor(ids, torch.int64),
            self._as_tensor(dense, torch.float32),
            self._as_tensor(labels, torch.float32),
            self._as_tensor(weights, torch.float32),
        )
