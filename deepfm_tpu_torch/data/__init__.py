"""Data layer: schema contract, encoders, packed batch layout, adapters.

Host-side only (NumPy); the device boundary is the packed (ids, dense,
labels, weights) arrays produced by :mod:`deepfm_tpu_torch.data.packing`.
"""

from deepfm_tpu_torch.data.dataset import (
    TabularDataset,
    iterate_batches,
    num_batches,
)
from deepfm_tpu_torch.data.packing import (
    PackedArrays,
    PackedSchema,
    pack_features,
    pack_schema,
)
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.data.transforms import (
    LabelEncoder,
    MinMaxScaler,
    MultiHotEncoder,
)

__all__ = [
    "DatasetSchema",
    "FeatureType",
    "FieldSchema",
    "LabelEncoder",
    "MinMaxScaler",
    "MultiHotEncoder",
    "PackedArrays",
    "PackedSchema",
    "TabularDataset",
    "iterate_batches",
    "num_batches",
    "pack_features",
    "pack_schema",
]
