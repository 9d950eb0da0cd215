"""On-disk packed datasets: out-of-core training from memory-mapped arrays.

The port's own copy of ``deepfm_tpu/data/store.py``, with the same layout,
so a store written by either package loads in the other. It keeps the
packed batch layout (``data/packing.py::PackedArrays``) as plain ``.npy``
files and loads them back with ``mmap_mode="r"``: the trainer's chunk plan
(``training/trainer.py::_chunk_plan``) fancy-indexes one staging-budget
chunk of rows at a time, and NumPy reads just those rows from disk, so an
epoch streams under a fixed host-memory bound.

Layout of a packed dataset directory::

    root/
      schema.json          # DatasetSchema (field specs), rebuilds models
      train/ ids.npy dense.npy labels.npy weights.npy [user_ids.npy]
      val/   ...
      test/  ...

``write_synthetic_packed`` generates a Criteo-scale synthetic dataset
straight into preallocated memmaps in bounded chunks. ``PackedDirAdapter``
(dataset_name "packed") is the CLI registry entry.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from deepfm_tpu_torch.config import DataConfig
from deepfm_tpu_torch.data.packing import PackedArrays, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema

__all__ = [
    "save_schema",
    "load_schema",
    "save_packed",
    "load_packed",
    "write_synthetic_packed",
    "PackedDirAdapter",
]


# ---------------------------------------------------------------------------
# schema (de)serialization
# ---------------------------------------------------------------------------

def save_schema(schema: DatasetSchema, path: str | Path) -> None:
    doc = {
        "label_field": schema.label_field,
        "fields": [
            {
                "name": f.name,
                "feature_type": f.feature_type.value,
                "vocabulary_size": f.vocabulary_size,
                "embedding_dim": f.embedding_dim,
                "group": f.group,
                "max_length": f.max_length,
                "combiner": f.combiner,
            }
            for f in schema.fields.values()
        ],
    }
    Path(path).write_text(json.dumps(doc, indent=1))


def load_schema(path: str | Path) -> DatasetSchema:
    doc = json.loads(Path(path).read_text())
    fields = {
        d["name"]: FieldSchema(
            name=d["name"],
            feature_type=FeatureType(d["feature_type"]),
            vocabulary_size=d["vocabulary_size"],
            embedding_dim=d["embedding_dim"],
            group=d["group"],
            max_length=d["max_length"],
            combiner=d["combiner"],
        )
        for d in doc["fields"]
    }
    return DatasetSchema(fields=fields, label_field=doc["label_field"])


# ---------------------------------------------------------------------------
# packed array (de)serialization
# ---------------------------------------------------------------------------

def save_packed(arrays: PackedArrays, d: str | Path) -> None:
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "ids.npy", np.ascontiguousarray(arrays.ids, np.int32))
    np.save(d / "dense.npy", np.ascontiguousarray(arrays.dense, np.float32))
    np.save(d / "labels.npy", np.ascontiguousarray(arrays.labels, np.float32))
    np.save(
        d / "weights.npy", np.ascontiguousarray(arrays.weights, np.float32)
    )
    if arrays.user_ids is not None:
        np.save(
            d / "user_ids.npy",
            np.ascontiguousarray(arrays.user_ids, np.int64),
        )
    else:
        # a stale user_ids.npy from a previous save would otherwise be
        # picked up by load_packed and group metrics by the wrong users
        (d / "user_ids.npy").unlink(missing_ok=True)


def load_packed(d: str | Path, mmap: bool = True) -> PackedArrays:
    """Load a split directory; ``mmap=True`` keeps rows on disk until the
    trainer's chunk plan touches them."""
    d = Path(d)
    mode = "r" if mmap else None
    uid_path = d / "user_ids.npy"
    return PackedArrays(
        ids=np.load(d / "ids.npy", mmap_mode=mode),
        dense=np.load(d / "dense.npy", mmap_mode=mode),
        labels=np.load(d / "labels.npy", mmap_mode=mode),
        weights=np.load(d / "weights.npy", mmap_mode=mode),
        user_ids=(
            np.load(uid_path, mmap_mode=mode) if uid_path.exists() else None
        ),
    )


# ---------------------------------------------------------------------------
# bounded-memory synthetic generation
# ---------------------------------------------------------------------------

def write_synthetic_packed(
    root: str | Path,
    config: DataConfig,
    seed: int = 0,
    chunk_rows: int = 1_000_000,
) -> Path:
    """Write a Criteo-scale synthetic packed dataset straight to disk.

    Splits are ``synthetic_num_rows`` train rows + num_rows//10 each of
    val/test (the SyntheticCTRAdapter proportions). Generation runs in
    ``chunk_rows`` blocks copied into preallocated ``.npy`` memmaps, so
    peak host memory is O(chunk_rows) regardless of dataset size.
    """
    from deepfm_tpu_torch.data.synthetic import SyntheticCTRAdapter

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    adapter = SyntheticCTRAdapter(config, seed=seed)
    packed = pack_schema(adapter.schema)
    save_schema(adapter.schema, root / "schema.json")

    n_train = config.synthetic_num_rows
    n_eval = max(n_train // 10, 1)
    for split, n in (("train", n_train), ("val", n_eval), ("test", n_eval)):
        d = root / split
        d.mkdir(exist_ok=True)
        mm = {
            "ids": np.lib.format.open_memmap(
                d / "ids.npy", mode="w+", dtype=np.int32,
                shape=(n, packed.num_slots),
            ),
            "dense": np.lib.format.open_memmap(
                d / "dense.npy", mode="w+", dtype=np.float32,
                shape=(n, packed.num_dense),
            ),
            "labels": np.lib.format.open_memmap(
                d / "labels.npy", mode="w+", dtype=np.float32, shape=(n,)
            ),
            "weights": np.lib.format.open_memmap(
                d / "weights.npy", mode="w+", dtype=np.float32, shape=(n,)
            ),
        }
        for start in range(0, n, chunk_rows):
            k = min(chunk_rows, n - start)
            block = adapter._sample(k).pack(packed)
            sl = slice(start, start + k)
            mm["ids"][sl] = block.ids
            mm["dense"][sl] = block.dense
            mm["labels"][sl] = block.labels
            mm["weights"][sl] = block.weights
        for m in mm.values():
            m.flush()
        del mm
    return root


# ---------------------------------------------------------------------------
# adapter (dataset registry entry "packed")
# ---------------------------------------------------------------------------

class PackedDirAdapter:
    """Serve a packed dataset directory memory-mapped.

    Unlike the interaction adapters this one returns device-layout
    ``PackedArrays`` directly (``build_packed``), their arrays
    ``np.memmap``s; there is no per-epoch negative resampling — the
    on-disk rows ARE the training distribution, the usual shape for logged
    CTR data.
    """

    def __init__(self, config: DataConfig, seed: int = 0) -> None:
        self.root = Path(config.data_dir)
        if not (self.root / "schema.json").exists():
            raise FileNotFoundError(
                f"{self.root}/schema.json not found — generate a packed "
                "dataset with `deepfm_tpu_torch synth-packed` or `pack-data`"
            )
        self.schema = load_schema(self.root / "schema.json")

    def build_packed(self):
        packed = pack_schema(self.schema)
        return (
            self.schema,
            packed,
            load_packed(self.root / "train"),
            load_packed(self.root / "val"),
            load_packed(self.root / "test"),
        )
