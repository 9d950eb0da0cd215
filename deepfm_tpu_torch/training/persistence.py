"""Best-checkpoint persistence (port of the best-model part of
``deepfm_tpu/training/persistence.py``).

``save_best`` writes ``output_dir/best_model.pt`` (the model's
``state_dict``) and ``output_dir/best_model_meta.json``; ``load_best``
reads them back into a live model on its own device. Resume checkpoints
and results.json come with the training slice.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch import nn

CHECKPOINT = "best_model.pt"
META = "best_model_meta.json"


def save_best(
    model: nn.Module, output_dir: str | Path, epoch: int = 0,
    best_metric: float = 0.0,
) -> Path:
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, out / CHECKPOINT)
    (out / META).write_text(json.dumps({
        "epoch": epoch,
        "best_metric": best_metric,
        "table_layout": "logical",
    }, indent=2))
    return out / CHECKPOINT


def load_best(model: nn.Module, output_dir: str | Path) -> dict:
    """Load the best checkpoint into ``model`` (strict) and return its
    metadata. Tensors land on the device of the model's parameters."""
    out = Path(output_dir)
    path = out / CHECKPOINT
    if not path.exists():
        raise FileNotFoundError(f"no best checkpoint at {path}")
    meta = json.loads((out / META).read_text())
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(state)
    return meta
