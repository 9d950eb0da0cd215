"""Dataset container + static-shape batch iteration.

The port's own copy of ``deepfm_tpu/data/dataset.py`` (the port imports
nothing of the JAX package); the text below is the original's.

``TabularDataset`` mirrors the reference container's dtype policy
(reference: deepfm/data/dataset.py:28-38 — integer features int64, floats
float32, labels float32) but holds whole NumPy arrays instead of yielding
per-item tensors: the TPU consumer is an epoch-level packed array, not a
DataLoader of rows.

``iterate_batches`` pads the trailing batch to the static batch size with
zero rows and ``weights=0`` — under jit every step sees the same shapes,
so one compilation serves the whole run; padded rows are masked out of the
loss/metrics by weight.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from deepfm_tpu_torch.data.packing import PackedArrays, PackedSchema, pack_features


class TabularDataset:
    """Dict-of-ndarrays + labels with the reference dtype policy."""

    def __init__(
        self, features: dict[str, np.ndarray], labels: np.ndarray
    ) -> None:
        self.features: dict[str, np.ndarray] = {}
        for name, arr in features.items():
            arr = np.asarray(arr)
            if arr.dtype.kind in "iu":
                arr = arr.astype(np.int64)
            else:
                arr = arr.astype(np.float32)
            self.features[name] = arr
        self.labels = np.asarray(labels, np.float32)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int) -> tuple[dict[str, np.ndarray], np.float32]:
        return {k: v[i] for k, v in self.features.items()}, self.labels[i]

    def pack(self, packed: PackedSchema) -> PackedArrays:
        return pack_features(packed, self.features, self.labels)


def num_batches(n: int, batch_size: int, drop_remainder: bool = False) -> int:
    if drop_remainder:
        return n // batch_size
    return -(-n // batch_size)


def iterate_batches(
    arrays: PackedArrays,
    batch_size: int,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    drop_remainder: bool = False,
) -> Iterator[PackedArrays]:
    """Yield fixed-shape PackedArrays batches (zero-padded, weight-masked)."""
    n = len(arrays)
    order = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    nb = num_batches(n, batch_size, drop_remainder)
    for b in range(nb):
        idx = order[b * batch_size : (b + 1) * batch_size]
        k = len(idx)
        if k == batch_size:
            yield PackedArrays(
                ids=arrays.ids[idx],
                dense=arrays.dense[idx],
                labels=arrays.labels[idx],
                weights=arrays.weights[idx],
                user_ids=(
                    arrays.user_ids[idx]
                    if arrays.user_ids is not None
                    else None
                ),
            )
            continue
        pad = batch_size - k
        yield PackedArrays(
            ids=np.concatenate(
                [arrays.ids[idx], np.zeros((pad, arrays.ids.shape[1]), np.int32)]
            ),
            dense=np.concatenate(
                [
                    arrays.dense[idx],
                    np.zeros((pad, arrays.dense.shape[1]), np.float32),
                ]
            ),
            labels=np.concatenate(
                [arrays.labels[idx], np.zeros(pad, np.float32)]
            ),
            weights=np.concatenate(
                [arrays.weights[idx], np.zeros(pad, np.float32)]
            ),
            user_ids=(
                np.concatenate(
                    [arrays.user_ids[idx], np.zeros(pad, np.int64)]
                )
                if arrays.user_ids is not None
                else None
            ),
        )
