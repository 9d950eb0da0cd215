"""Batched scoring (port of ``Trainer.predict`` and ``_build_eval_step``
of ``deepfm_tpu/training/trainer.py``).

``Predictor.predict`` returns sigmoid probabilities for every row of a
``PackedArrays``, in order: the rows go to the device in chunks of as many
batches as ``training.stage_budget_mb`` holds (``budget_batches``, the JAX
``Trainer._budget_batches``), the model runs in eval mode under
``torch.inference_mode`` in batches of ``training.batch_size``, and each
chunk's scores come back in one host fetch. The JAX package pads the last
batch to a static shape for its compiled scan; eager PyTorch needs no
padding, so the last batch is just shorter. Its spans (``utils/tracing.py``)
are ``score.stage`` (a staging copy, twice a chunk; counter
``score.stage_bytes``), ``score.forward`` (a batch's ``model.predict``) and
``score.fetch`` (a chunk's scores to the host).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedArrays, PackedSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.utils import tracing


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

    def budget_batches(self, data: PackedArrays, batch_size: int) -> int:
        """How many batches one staged chunk holds (at least one): the
        staging budget over a batch's bytes, its ids and dense values at 4
        bytes each and 8 for its label and weight, as the JAX trainer
        counts them."""
        bytes_per_batch = batch_size * (
            4 * data.ids.shape[1] + 4 * data.dense.shape[1] + 8
        )
        budget = self.config.training.stage_budget_mb * (1 << 20)
        return max(1, budget // max(bytes_per_batch, 1))

    def _stage(self, a: np.ndarray) -> torch.Tensor:
        """A chunk on the device. A chunk of a read-only memory-mapped
        split (``data/store.py``) is read into a host copy first; an
        in-memory one is not copied on the host."""
        with tracing.span("score.stage"):
            host = np.require(a, requirements=("C", "W"))
            out = torch.from_numpy(host).to(self.device, non_blocking=True)
        tracing.count("score.stage_bytes", host.nbytes)
        return out

    def predict(self, data: PackedArrays) -> np.ndarray:
        n = len(data)
        if n == 0:
            return np.zeros(0, np.float32)
        bs = self.config.training.batch_size
        chunk = bs * self.budget_batches(data, bs)
        self.model.eval()
        scores = []
        with torch.inference_mode():
            for lo in range(0, n, chunk):
                ids = self._stage(data.ids[lo : lo + chunk])
                dense = self._stage(data.dense[lo : lo + chunk])
                parts = []
                for i in range(0, ids.shape[0], bs):
                    with tracing.span("score.forward"):
                        parts.append(self.model.predict(
                            ids[i : i + bs], dense[i : i + bs])[:, 0])
                part = torch.cat(parts) if len(parts) > 1 else parts[0]
                with tracing.span("score.fetch"):
                    scores.append(part.cpu().numpy())
        return scores[0] if len(scores) == 1 else np.concatenate(scores)
