"""Batched scoring (port of ``Trainer.predict`` and ``_build_eval_step``
of ``deepfm_tpu/training/trainer.py``).

``Predictor.predict`` returns sigmoid probabilities for every row of a
``PackedArrays``, in order: the rows go to the device once, the model runs
in eval mode under ``torch.inference_mode`` in batches of
``training.batch_size``, and the scores come back in one host fetch. The
JAX package pads the last batch to a static shape for its compiled scan;
eager PyTorch needs no padding, so the last batch is just shorter.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedArrays, PackedSchema
from deepfm_tpu_torch.device import resolve_device


class Predictor:
    def __init__(
        self,
        model: nn.Module,
        packed: PackedSchema,
        config: ExperimentConfig,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.packed = packed
        self.config = config

    @property
    def n_params(self) -> int:
        """Parameter count (``p.numel()`` summed; buffers such as BN
        running statistics excluded, as the JAX package counts params)."""
        return sum(p.numel() for p in self.model.parameters())

    def predict(self, data: PackedArrays) -> np.ndarray:
        n = len(data)
        if n == 0:
            return np.zeros(0, np.float32)
        bs = self.config.training.batch_size
        self.model.eval()
        with torch.inference_mode():
            ids = torch.from_numpy(np.ascontiguousarray(data.ids)).to(
                self.device, non_blocking=True
            )
            dense = torch.from_numpy(np.ascontiguousarray(data.dense)).to(
                self.device, non_blocking=True
            )
            parts = [
                self.model.predict(ids[i : i + bs], dense[i : i + bs])[:, 0]
                for i in range(0, n, bs)
            ]
            scores = torch.cat(parts) if len(parts) > 1 else parts[0]
            return scores.cpu().numpy()
