"""Reproducibility: one seed drives python's, numpy's and torch's RNGs.

Port of ``deepfm_tpu/utils/seeding.py``'s ``seed_everything`` (reference:
deepfm/utils/seeding.py:9-15). Where the JAX package threads explicit
``jax.random`` keys, the port's stochastic ops take their own seeded
generators: the initial weights (``models.create_model``), the shuffle
(``Trainer.np_rng``) and dropout (``Trainer.dropout_generator``); this
seeds what is left to the global RNGs.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """Seed python's, numpy's and torch's global RNGs (every device's)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
