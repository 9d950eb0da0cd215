"""Factorization-Machine second-order interaction (parameter-free).

Port of ``deepfm_tpu/ops/fm.py``: the O(F*D) sum-of-squares identity

    0.5 * sum_d [ (sum_f e_{f,d})^2 - sum_f e_{f,d}^2 ]

in plain tensor ops; the JAX package leaves it to XLA, no kernel.
"""

from __future__ import annotations

import torch


def fm_interaction(field_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B, 1) second-order FM interaction."""
    summed = field_embeddings.sum(dim=1)  # (B, D)
    square_of_sum = summed * summed
    sum_of_squares = (field_embeddings * field_embeddings).sum(dim=1)
    return 0.5 * (square_of_sum - sum_of_squares).sum(dim=1, keepdim=True)
