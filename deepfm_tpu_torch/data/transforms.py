"""Fit/transform encoders with the OOV -> index 0 convention.

The port's own copy of ``deepfm_tpu/data/transforms.py`` (the port imports
nothing of the JAX package); the text below is the original's.

Behavioral contract matches the reference encoders (reference:
deepfm/data/transforms.py:8-76): sorted uniques map to 1..N so index 0 is
reserved for OOV/padding everywhere; ``vocabulary_size`` is N+1.

TPU-relevant difference: transforms are vectorized (np.searchsorted over
the sorted class array) instead of per-element dict lookups — encoding the
full interaction table is O(n log V) and never enters a Python loop.
"""

from __future__ import annotations

import numpy as np


class LabelEncoder:
    """Categorical -> contiguous int codes; unseen values -> 0."""

    def __init__(self) -> None:
        self.classes_: np.ndarray | None = None
        self._mapping: dict = {}

    def fit(self, values) -> "LabelEncoder":
        arr = np.asarray(values)
        self.classes_ = np.unique(arr)
        self._mapping = {v: i + 1 for i, v in enumerate(self.classes_.tolist())}
        return self

    @property
    def vocabulary_size(self) -> int:
        """N distinct classes + 1 reserved OOV/padding slot."""
        return len(self.classes_) + 1

    def transform(self, values) -> np.ndarray:
        arr = np.asarray(values)
        classes = self.classes_
        idx = np.searchsorted(classes, arr)
        idx = np.clip(idx, 0, len(classes) - 1)
        hit = classes[idx] == arr
        return np.where(hit, idx + 1, 0).astype(np.int64)


class MinMaxScaler:
    """Scale to [0, 1] over the fitted range; constant input -> 0.

    Out-of-range values are NOT clipped (matches reference
    transforms.py:31-49)."""

    def __init__(self) -> None:
        self.min_: float = 0.0
        self.range_: float = 0.0

    def fit(self, values) -> "MinMaxScaler":
        arr = np.asarray(values, dtype=np.float64)
        self.min_ = float(arr.min())
        self.range_ = float(arr.max()) - self.min_
        return self

    def transform(self, values) -> np.ndarray:
        arr = np.asarray(values, dtype=np.float64)
        if self.range_ == 0.0:
            return np.zeros_like(arr)
        return (arr - self.min_) / self.range_


class MultiHotEncoder:
    """Token lists -> padded (N, max_length) int64 code matrix.

    Padding/truncation to ``max_length``; unseen tokens -> 0; empty lists
    -> all-zero rows (matches reference transforms.py:52-76)."""

    def __init__(self, max_length: int = 6) -> None:
        self.max_length = max_length
        self.classes_: np.ndarray | None = None
        self._mapping: dict = {}

    def fit(self, token_lists) -> "MultiHotEncoder":
        tokens: list = []
        for row in token_lists:
            tokens.extend(row)
        self.classes_ = np.unique(np.asarray(tokens))
        self._mapping = {v: i + 1 for i, v in enumerate(self.classes_.tolist())}
        return self

    @property
    def vocabulary_size(self) -> int:
        return len(self.classes_) + 1

    def transform(self, token_lists) -> np.ndarray:
        n = len(token_lists)
        out = np.zeros((n, self.max_length), dtype=np.int64)
        mapping = self._mapping
        for i, row in enumerate(token_lists):
            for j, tok in enumerate(row[: self.max_length]):
                out[i, j] = mapping.get(tok, 0)
        return out
