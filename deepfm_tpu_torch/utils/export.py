"""Serving export: the fitted scoring function as a ``torch.export``
program.

Port of ``deepfm_tpu/utils/export.py``, with the same names.
``torch.export`` packages the model's predict path (sigmoid probabilities)
into one self-contained artifact: the fitted parameters are in it, the
batch dimension is symbolic (one artifact serves any batch size) unless a
static batch is pinned, and a consumer needs only ``torch.export.load``,
no model code, config or checkpoint machinery::

    program = torch.export.load("model.pt2")
    score = program.module()
    probs = score(ids_int32, dense_float32)  # on the program's device

The exported function is the PLAIN forward, as in the JAX package: the
model is rebuilt with ``serving_config`` (every kernel toggle off, logical
tables, no mesh) and traced on CPU tensors, where every kernel wrapper
takes its plain version, so the program holds no custom call (the JAX
package turns its Pallas kernels off because Mosaic custom calls do not
serialise). A packed checkpoint restores into the logical tables through
the cross-layout restore (``utils/layout.py``).

Where the JAX package lowers one artifact for several platforms, a
``torch.export`` program is bound to one device: ``platform="cpu"``, or
``"cuda"``, for which the traced program's weights and the devices named
in its graph are moved by ``torch.export.passes.move_to_device_pass``.
That pass needs a CUDA device in the exporting process.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

__all__ = [
    "PLATFORMS",
    "check_platform",
    "serving_config",
    "export_scoring",
    "input_shapes",
    "save_scoring",
    "load_scoring",
    "quantize_embedding_tables",
    "quantized_scoring_model",
]

PLATFORMS = ("cpu", "cuda")
# the example batch a symbolic-batch program is traced at (a size of 0 or
# 1 would be specialised by torch.export)
TRACE_BATCH = 8


def serving_config(config):
    """A copy of ``config`` for a portable export: every kernel toggle off
    (the program is the plain forward), the logical table layout (packed
    tables are a training-side storage layout), a 1x1 mesh (the artifact
    is a single program) and ``device="cpu"`` (the trace runs on CPU
    tensors)."""
    return dataclasses.replace(
        config,
        pallas=dataclasses.replace(
            config.pallas,
            use_embedding_kernel=False,
            use_cin_kernel=False,
            use_attention_kernel=False,
            use_grad_kernel=False,
            table_layout="logical",
        ),
        mesh=dataclasses.replace(config.mesh, data_axis=1, model_axis=1),
        device="cpu",
    )


def quantize_embedding_tables(model) -> dict[int, tuple]:
    """Per-row symmetric int8 quantization of ``model``'s embedding tables.

    Returns ``{width+1: (q int8 (rows, w), scale f32 (rows,))}``, one entry
    per lookup group, from the tables' logical view (a packed model's
    tables are unpacked first). The JAX package's arithmetic in numpy:
    ``scale = max|row| / 127`` (1.0 for an all-zero row),
    ``q = clip(round(t / scale), -127, 127)`` with ``np.round``'s half to
    even. The dequantized row ``q * scale`` is within scale/2 of the row;
    row 0 (OOV/padding) is all zero and stays exact. Width-17 f32 rows are
    68 B, int8 with a scale 21 B: 3.2x smaller.
    """
    from deepfm_tpu_torch.utils.layout import convert_table_tree

    tables = {n: p.detach().cpu() for n, p in model.state_dict().items()
              if n.startswith("embedding.table_w")}
    tables = convert_table_tree(tables, model.packed, to_packed=False)
    qtabs: dict[int, tuple] = {}
    for t in tables.values():
        t = t.numpy().astype(np.float32)
        amax = np.abs(t).max(axis=1)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(t / scale[:, None]), -127, 127).astype(np.int8)
        qtabs[t.shape[1]] = (q, scale)
    return qtabs


def quantized_scoring_model(config, packed, model):
    """The serving model of ``config`` with int8 table lookups, on the CPU,
    holding ``model``'s weights (either table layout).

    Where the JAX model keeps its f32 tables declared and XLA drops them
    from the program as dead code, ``torch.export`` lifts every registered
    parameter: so this model has no ``table_w*`` parameter at all. Its
    tables are the int8 buffers and f32 scales of ``QuantizedTables``
    (``ops/embedding.py``), and its other weights and BatchNorm statistics
    are ``model``'s.
    """
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.utils.layout import convert_table_tree

    qmodel = create_model(config.model_name, packed, serving_config(config),
                          device="cpu")
    state = {n: v.detach().cpu() for n, v in model.state_dict().items()}
    qmodel.load_state_dict(convert_table_tree(state, packed, to_packed=False))
    qmodel.embedding.quantize_tables(quantize_embedding_tables(qmodel))
    return qmodel


def check_platform(platform: str) -> None:
    """Refuse a platform this process cannot export for: one of
    ``PLATFORMS``, and ``cuda`` only with a CUDA device, which
    ``move_to_device_pass`` needs."""
    if platform not in PLATFORMS:
        raise ValueError(
            f"platform must be one of {PLATFORMS}, got {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' moves the traced program to a CUDA device "
            "(torch.export.passes.move_to_device_pass), and "
            "torch.cuda.is_available() is False: export on a host with a "
            "card, or export for platform 'cpu'")


class _Scoring(nn.Module):
    """``(ids int32[b, S], dense float32[b, Dn]) -> probs float32[b]``."""

    def __init__(self, model: nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, ids: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
        return self.model.predict(ids, dense)[:, 0]


def export_scoring(
    model,
    num_slots: int,
    num_dense: int,
    *,
    platform: str = "cpu",
    batch_size: int | None = None,
):
    """Export ``model``'s predict method as a ``torch.export``
    ``ExportedProgram``.

    Its calling convention is ``(ids int32[b, num_slots], dense
    float32[b, num_dense]) -> probs float32[b]``, where ``b`` is symbolic
    (``Dim("batch", min=1)``) unless ``batch_size`` pins it. The model is
    put in eval mode and traced on CPU tensors, so it must be on the CPU
    (``serving_config``). ``platform="cuda"`` moves the traced program to
    the card and needs one.
    """
    check_platform(platform)
    devices = {t.device.type for t in model.state_dict().values()}
    if devices != {"cpu"}:
        raise ValueError(
            f"export_scoring traces on CPU tensors; the model is on "
            f"{sorted(devices)} (build it with serving_config)")
    model.eval()
    b = TRACE_BATCH if batch_size is None else batch_size
    example = (torch.zeros(b, num_slots, dtype=torch.int32),
               torch.zeros(b, num_dense, dtype=torch.float32))
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic = ({0: batch}, {0: batch})
    program = torch.export.export(_Scoring(model), example,
                                  dynamic_shapes=dynamic)
    if platform == "cuda":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, "cuda")
    return program


def input_shapes(program) -> list[tuple[str, ...]]:
    """The program's input shapes, a symbolic size by its name."""
    names = set(program.graph_signature.user_inputs)
    return [tuple(str(s) for s in node.meta["val"].shape)
            for node in program.graph.nodes
            if node.op == "placeholder" and node.name in names]


def save_scoring(path: str | Path, program) -> int:
    """Write the artifact (``torch.export.save``); returns its size in
    bytes."""
    torch.export.save(program, str(path))
    return Path(path).stat().st_size


def load_scoring(path: str | Path) -> Callable[..., np.ndarray]:
    """Load an exported artifact into ``score(ids, dense) -> np.ndarray``,
    NumPy in and out, run on the program's own device. A thin convenience
    over ``torch.export.load``: it needs nothing from this package (the
    module docstring loads an artifact in three lines of torch). The
    program is ``score.program``."""
    program = torch.export.load(str(path))
    module = program.module()
    tensors = [*program.state_dict.values(), *program.constants.values()]
    device = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                  torch.device("cpu"))

    def score(ids, dense) -> np.ndarray:
        ids = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32))
        dense = torch.from_numpy(
            np.ascontiguousarray(dense, dtype=np.float32))
        with torch.no_grad():
            out = module(ids.to(device), dense.to(device))
        return out.cpu().numpy()

    score.program = program
    return score
