"""Best-checkpoint persistence (port of the best-model part of
``deepfm_tpu/training/persistence.py``).

``save_best`` writes ``output_dir/best_model.pt`` (the model's
``state_dict``) and ``output_dir/best_model_meta.json``, which records the
model's table layout. ``load_best`` reads them back into a live model on
its own device, layout-portable: it detects the saved tables' layout from
their shapes (``utils/layout.py::tree_layout``) and converts them to the
live model's, so a packed checkpoint serves under a logical config and the
reverse. ``recompute_table_psq`` re-derives a trainer's carried sums of
squares after a load (``Trainer.load_best`` does both). Resume checkpoints
and results.json come with the trainer-loop slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.utils.layout import convert_table_tree, tree_layout

CHECKPOINT = "best_model.pt"
META = "best_model_meta.json"


def save_best(
    model: CTRModel, output_dir: str | Path, epoch: int = 0,
    best_metric: float = 0.0,
) -> Path:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, out / CHECKPOINT)
    (out / META).write_text(json.dumps({
        "epoch": epoch,
        "best_metric": best_metric,
        "table_layout": model.table_layout,
    }, indent=2))
    return out / CHECKPOINT


def load_best(model: CTRModel, output_dir: str | Path) -> dict:
    """Load the best checkpoint into ``model`` (strict), its tables
    converted to the model's layout, and return its metadata. Tensors land
    on the device of the model's parameters."""
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
    model.load_state_dict(state)
    return meta


def recompute_table_psq(trainer) -> None:
    """Re-derive the carried sum(p^2) of every table after a restore that
    replaced the tables (the sparse-fused update otherwise keeps them
    current as a by-product of each step)."""
    if trainer.state.table_psq is None:
        return
    params = trainer.params
    with torch.no_grad():
        trainer.state.table_psq = {
            n: torch.sum(params[n].detach() ** 2) for n in trainer.table_names
        }
