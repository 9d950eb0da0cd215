"""Trainer persistence: best checkpoints, resume and results.json.

Port of ``deepfm_tpu/training/persistence.py``, with ``torch.save`` files
for its Orbax checkpoints:

* ``save_best`` writes ``output_dir/best_model.pt`` (the model's
  ``state_dict``) and ``output_dir/best_model_meta.json``, which records
  the model's table layout. ``load_best`` reads them back into a live
  model on its own device, layout-portable: it detects the saved tables'
  layout from their shapes (``utils/layout.py::tree_layout``) and converts
  them to the live model's, so a packed checkpoint serves under a logical
  config and the reverse. ``recompute_table_psq`` re-derives a trainer's
  carried sums of squares after a load (``Trainer.load_best`` does both).
* ``save_resume`` / ``try_resume``: mid-training resume.
  ``output_dir/last_state.pt`` holds the model's ``state_dict``, the
  ``OptState``, the table moments, the step count and the RNG states a
  resumed run needs to repeat an unbroken one (dropout's generator, the
  shuffle's and the adapter's); ``last_state_meta.json`` has the JAX
  package's keys. A resume refuses a checkpoint of another table layout,
  ``fused_table_adam`` resolution, optimizer (recorded in ``last_state.pt``)
  or scheduler type (the state's structure follows them), casts the saved
  table moments to this run's ``moments_dtype`` (the fused paths; the
  lazy_adam moments stay f32) and recomputes the carried table sums of
  squares.
* ``save_results_file``: results.json, the reference's contract (reference:
  deepfm/training/trainer.py:171-195), with the JAX package's top-level
  and ``training_info`` keys (throughput and engagement telemetry).

Under a mesh rank 0 alone writes (the ``Trainer`` calls ``save_best`` on
rank 0 only; ``save_resume`` and ``save_results_file`` are called on every
rank and write on rank 0), and a barrier after each write keeps a rank
from reading a file before it is there; every rank reads. At a model axis
above 1 each rank holds a slab of every table, of its moments and of its
plain-chain optimizer leaves: every rank takes part in gathering them
over its data row's model group (``whole_state_dict``, ``save_resume``),
rank 0 writes whole tables, and every reader keeps its slab of them
(``FeatureEmbedding.slab_of``). So a checkpoint holds no trace of the
mesh: one written on N ranks at any (data, model) shape restores on one
process, and the reverse. The resume state records the dropout
generator of each data index (the one state that is per rank: model
peers share theirs; the shuffle's and the adapter's are the same on every
rank), and a resume into another mesh is refused only where that state
would matter: when the model has dropout and the data axis differs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime
from pathlib import Path

import torch

from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.ops.dnn import Dropout
from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.sharding import is_table_path
from deepfm_tpu_torch.training.optim import OptState
from deepfm_tpu_torch.training.schedulers import set_lr
from deepfm_tpu_torch.training.sparse_opt import TableSlotState
from deepfm_tpu_torch.training.telemetry import trainer_engagement
from deepfm_tpu_torch.utils.io import save_results
from deepfm_tpu_torch.utils.layout import convert_table_tree, tree_layout

CHECKPOINT = "best_model.pt"
META = "best_model_meta.json"
RESUME = "last_state.pt"
RESUME_META = "last_state_meta.json"


def _model_group(model: CTRModel, mesh):
    """The group over which ``model``'s tables are slabs, or None."""
    if model.embedding.shard is None or mesh is None:
        return None
    return mesh.model_group


def whole(group, t: torch.Tensor) -> torch.Tensor:
    """The whole table of which every rank of the model ``group`` holds a
    slab ``t``, on the host (a gather; every rank of the group calls it);
    ``t`` itself on the host without a group. bf16 moments travel as f32,
    which holds them exactly."""
    if group is None:
        return t.detach().cpu()
    return collectives.all_gather_rows(
        group, t.detach().float()).to(t.dtype).cpu()


def whole_state_dict(trainer) -> dict[str, torch.Tensor]:
    """The model's ``state_dict`` on the host with whole tables: at a model
    axis above 1 every rank must call it (the slabs are gathered over each
    data row's model group)."""
    group = _model_group(trainer.model, trainer.mesh)
    return {k: (whole(group, v) if is_table_path(k) else v.detach().cpu())
            for k, v in trainer.model.state_dict().items()}


def save_best(
    model: CTRModel, output_dir: str | Path, epoch: int = 0,
    best_metric: float = 0.0, state: dict | None = None,
) -> Path:
    """Write the best checkpoint of ``model``: its ``state_dict``, or
    ``state`` (a ``whole_state_dict``, whose tables are whole where the
    model holds slabs)."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if state is None:
        if model.embedding.shard is not None:
            raise ValueError("a model of table slabs is saved from its "
                             "whole_state_dict")
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _save(state, out / CHECKPOINT)
    save_results({
        "epoch": epoch,
        "best_metric": best_metric,
        "table_layout": model.table_layout,
    }, out / META)
    return out / CHECKPOINT


def load_best(model: CTRModel, output_dir: str | Path) -> dict:
    """Load the best checkpoint into ``model`` (strict), its tables
    converted to the model's layout (and cut to the model's slabs), and
    return its metadata. Tensors land on the device of the model's
    parameters."""
    out = Path(output_dir)
    path = out / CHECKPOINT
    if not path.exists():
        raise FileNotFoundError(f"no best checkpoint at {path}")
    meta = json.loads((out / META).read_text())
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    if tree_layout(state, model.packed) != model.table_layout:
        state = convert_table_tree(state, model.packed,
                                   to_packed=model.table_layout == "packed")
    model.load_state_dict(slab_state(model, state))
    return meta


def slab_state(model: CTRModel, state: dict) -> dict:
    """``state`` (a ``state_dict`` with whole tables) with each table cut
    to the model's slab of it."""
    return {k: (model.embedding.slab_of(v) if is_table_path(k) else v)
            for k, v in state.items()}


def table_psq(trainer) -> dict[str, torch.Tensor]:
    """sum(p^2) of every whole table: the slabs' summed over the model
    group at a model axis above 1 (every rank calls it)."""
    from deepfm_tpu_torch.training.optim import table_sumsq

    params = trainer.params
    with torch.no_grad():
        sq = {n: torch.sum(params[n].detach() ** 2)
              for n in trainer.table_names}
    return table_sumsq(_model_group(trainer.model, trainer.mesh), sq)


def recompute_table_psq(trainer) -> None:
    """Re-derive the carried sum(p^2) of every table after a restore that
    replaced the tables (the sparse-fused update otherwise keeps them
    current as a by-product of each step)."""
    if not trainer.sparse_fused:
        return
    trainer.state.table_psq = table_psq(trainer)


def _save(obj, path: Path) -> None:
    """torch.save to a temporary file, then rename: a reader never sees
    half a checkpoint."""
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu(x):
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_resume(
    trainer,
    epoch: int,
    best_metric: float,
    best_epoch: int,
    best_metrics: dict,
    patience_counter: int,
) -> None:
    if not trainer.config.training.resume:
        return
    mesh = trainer.mesh
    st = trainer.state
    # the dropout generator state of every data index, in order (model
    # peers share theirs: each data row's first rank's)
    dropout_rngs = collectives.all_gather_rows(
        mesh, trainer.dropout_generator.get_state()[None]).cpu()
    if mesh is not None:
        dropout_rngs = dropout_rngs[::mesh.model]
    group = _model_group(trainer.model, mesh)
    if group is None and not trainer.is_writer:  # nothing to gather
        collectives.barrier(mesh)
        return

    def gathered(name, t):
        return whole(group, t) if is_table_path(name) else _cpu(t)

    model_state = whole_state_dict(trainer)
    opt_state = {f.name: getattr(st.opt_state, f.name)
                 for f in dataclasses.fields(OptState)}
    opt_state = {k: ({n: gathered(n, t) for n, t in v.items()}
                     if isinstance(v, dict) else _cpu(v))
                 for k, v in opt_state.items()}
    table_opt = None if st.table_opt is None else {
        n: {"mu": whole(group, s.mu), "nu": whole(group, s.nu)}
        for n, s in st.table_opt.items()}
    if not trainer.is_writer:
        collectives.barrier(mesh)
        return
    ckpt = {
        "model": model_state,
        "opt_state": opt_state,
        "step": _cpu(st.step),
        "optimizer": trainer.config.training.optimizer,
        "table_opt": table_opt,
        "dropout_rngs": dropout_rngs,
        "shuffle_rng": trainer.np_rng.bit_generator.state,
        "adapter_rng": trainer._adapter_rng_state,
    }
    trainer.output_dir.mkdir(parents=True, exist_ok=True)
    _save(ckpt, trainer.output_dir / RESUME)
    save_results(
        {
            "epoch": epoch,
            "best_metric": best_metric,
            "best_epoch": best_epoch,
            "best_metrics": best_metrics,
            "patience_counter": patience_counter,
            "scheduler": trainer.scheduler.state_dict(),
            "scheduler_type": type(trainer.scheduler).__name__,
            "history": trainer.history,
            # the state's structure follows these two resolutions:
            # recorded so that a mismatched resume fails with a message
            "table_layout": trainer.model.table_layout,
            "fused_table_adam": trainer.fused_tables,
        },
        trainer.output_dir / RESUME_META,
    )
    collectives.barrier(mesh)


def uses_dropout(model: CTRModel) -> bool:
    return any(isinstance(m, Dropout) for m in model.modules())


def _refuse_mismatch(trainer, meta: dict) -> None:
    layout = trainer.model.table_layout
    saved_layout = meta.get("table_layout")
    if saved_layout is not None and saved_layout != layout:
        raise ValueError(
            f"Cannot resume: checkpoint tables are {saved_layout} but the "
            f"model uses {layout} (optimizer moments follow the table "
            f"layout). Set pallas.table_layout={saved_layout} to resume "
            f"this run, or start fresh. (best_model checkpoints DO convert "
            f"across layouts — only mid-training resume is layout-pinned.)"
        )
    saved_fused = meta.get("fused_table_adam")
    if saved_fused is not None and saved_fused != trainer.fused_tables:
        raise ValueError(
            f"Cannot resume: checkpoint was written with "
            f"fused_table_adam={saved_fused} but this run resolves it to "
            f"{trainer.fused_tables} (the optimizer states differ). Match "
            f"training.fused_table_adam, or start fresh."
        )
    saved_sched = meta.get("scheduler_type")
    sched = type(trainer.scheduler).__name__
    if saved_sched is not None and saved_sched != sched:
        raise ValueError(
            f"Cannot resume: checkpoint was written with scheduler "
            f"{saved_sched} but this run uses {sched} (their states are "
            f"incompatible). Match training.scheduler, or start fresh."
        )


def try_resume(trainer) -> dict | None:
    """Restore the last epoch's state from ``output_dir`` into the trainer;
    returns the checkpoint's metadata, or None when there is none."""
    path = trainer.output_dir / RESUME
    meta_path = trainer.output_dir / RESUME_META
    if not path.exists() or not meta_path.exists():
        return None
    meta = json.loads(meta_path.read_text())
    _refuse_mismatch(trainer, meta)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    saved_opt = ckpt.get("optimizer")
    opt = trainer.config.training.optimizer
    if saved_opt is not None and saved_opt != opt:
        raise ValueError(
            f"Cannot resume: checkpoint was written with optimizer "
            f"{saved_opt} but this run uses {opt} (the optimizer states "
            f"differ). Match training.optimizer, or start fresh."
        )
    # one dropout generator state a data index ("dropout_rng" before the
    # mesh)
    rngs = ckpt.get("dropout_rngs", [ckpt.get("dropout_rng")])
    rows = 1 if trainer.mesh is None else trainer.mesh.data
    if len(rngs) != rows and uses_dropout(trainer.model):
        raise ValueError(
            f"Cannot resume: checkpoint was written by {len(rngs)} ranks "
            f"and this run has {rows}. The dropout generator's state is "
            f"per rank of the data axis (dropout_rngs), so the masks would "
            f"not continue the run; the shuffle's and the adapter's states "
            f"are the same on every rank. Resume with a data axis of "
            f"{len(rngs)}, or start fresh.")
    dev = trainer.device

    def to_dev(x):
        if isinstance(x, dict):
            return {k: to_dev(v) for k, v in x.items()}
        return x.to(dev)

    slab = trainer.model.embedding.slab_of
    trainer.model.load_state_dict(slab_state(trainer.model, ckpt["model"]))
    st = trainer.state
    st.opt_state = OptState(**to_dev({
        k: ({n: slab(t) if is_table_path(n) else t for n, t in v.items()}
            if isinstance(v, dict) else v)
        for k, v in ckpt["opt_state"].items()}))
    st.step = ckpt["step"].to(dev)
    if ckpt["table_opt"] is not None:
        # fused moments may have been saved under another
        # training.moments_dtype; lazy_adam's are f32 (the tables')
        mdt = (getattr(torch, trainer.config.training.moments_dtype)
               if trainer.fused_tables else torch.float32)
        st.table_opt = {
            n: TableSlotState(mu=slab(s["mu"]).to(dev, mdt),
                              nu=slab(s["nu"]).to(dev, mdt))
            for n, s in ckpt["table_opt"].items()}
    index = 0 if trainer.mesh is None else trainer.mesh.data_index
    if index < len(rngs):  # else unused: the model has no dropout
        trainer.dropout_generator.set_state(rngs[index].clone())
    trainer.np_rng.bit_generator.state = ckpt["shuffle_rng"]
    if ckpt["adapter_rng"] is not None and trainer.adapter is not None:
        trainer.adapter.set_rng_state(ckpt["adapter_rng"])
        trainer._adapter_rng_state = ckpt["adapter_rng"]
    trainer.epoch = meta["epoch"]
    trainer.scheduler.load_state_dict(meta["scheduler"])
    trainer.history = meta.get("history", [])
    set_lr(st.opt_state, trainer.scheduler.lr)
    recompute_table_psq(trainer)
    trainer.logger.info(f"Resumed from epoch {meta['epoch']}")
    return meta


def save_results_file(
    trainer,
    val_metrics: dict[str, float],
    test_metrics: dict[str, float],
    best_epoch: int,
    total_epochs: int,
) -> None:
    results = {
        "run_id": trainer.output_dir.name,
        "timestamp": datetime.now().isoformat(timespec="seconds"),
        "config": trainer.config.to_dict(),
        "val_metrics": val_metrics,
        "test_metrics": test_metrics,
        "training_info": {
            "best_epoch": best_epoch,
            "total_epochs": total_epochs,
            **trainer.throughput,
            **trainer_engagement(trainer, since=trainer._launches_at_start),
        },
        "history": trainer.history,
    }
    if trainer.is_writer:
        save_results(results, trainer.output_dir / "results.json")
        trainer.logger.info(
            f"Results saved to {trainer.output_dir / 'results.json'}")
    collectives.barrier(trainer.mesh)
