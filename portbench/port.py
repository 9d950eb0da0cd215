"""The system under test: ``deepfm_tpu_torch`` built for a cell.

The only module of the benchmark that imports the port. It turns a
configuration file and a traffic mix into the port's ``ExperimentConfig``,
schema, model and ``Trainer``, and loads the benchmark's weights
(``weights.py``) into the model by name.

What differs between model kinds comes from the kind's file,
``models/<kind>.py`` (``Registry.model`` of the configuration's
``"model"``), passed in as ``kind``: the sections it adds to the port's
configuration (``port_config``), the port's names of its own leaves
(``port_names``), and its DNN (``dnn_width``, None without one) and
output heads (``heads``), whose names this module gives.
"""

from __future__ import annotations

import numpy as np
import torch

from deepfm_tpu_torch.config import config_from_dict
from deepfm_tpu_torch.data.packing import PackedArrays, pack_schema
from deepfm_tpu_torch.data.schema import DatasetSchema, FeatureType, FieldSchema
from deepfm_tpu_torch.models import create_model
from deepfm_tpu_torch.training.predict import Predictor
from deepfm_tpu_torch.training.trainer import Trainer
from portbench import fields as bench_fields


def experiment_config(kind, config: dict, mix: dict, device: str,
                      seed: int):
    return config_from_dict({
        "model_name": config["model"],
        "seed": seed,
        "device": device,
        "feature": {"fm_embed_dim": config["embed_dim"],
                    "embedding_l2_reg": config["embedding_l2_reg"]},
        "dnn": {"hidden_units": list(config["dnn_hidden_units"]),
                "activation": config["dnn_activation"],
                "dropout": config["dropout"],
                "use_batch_norm": config["dnn_batch_norm"]},
        "training": {"batch_size": mix["batch"], "lr": config["lr"],
                     "optimizer": config["optimizer"],
                     "gradient_clip_norm": config["gradient_clip_norm"],
                     "compute_dtype": config["compute_dtype"],
                     "moments_dtype": config["moments_dtype"],
                     "stage_budget_mb": config["stage_budget_mb"],
                     "scheduler": "none"},
        "pallas": {"table_layout": config["table_layout"]},
        **kind.port_config(config),
    })


def schema(config: dict) -> DatasetSchema:
    """Criteo's column order: the dense fields I1.. then the categorical
    fields C1.. (``fields.vocab_sizes`` rows each), every one embedded at
    ``embed_dim``."""
    d = config["embed_dim"]
    fields = {}
    for i in range(config["dense_fields"]):
        fields[f"I{i + 1}"] = FieldSchema(f"I{i + 1}", FeatureType.DENSE, 0,
                                          d, "context")
    for i, vocab in enumerate(bench_fields.vocab_sizes(config)):
        fields[f"C{i + 1}"] = FieldSchema(f"C{i + 1}", FeatureType.SPARSE,
                                          vocab, d, "item")
    return DatasetSchema(fields=fields)


def packed_arrays(pool: dict) -> PackedArrays:
    n = len(pool["labels"])
    return PackedArrays(ids=pool["ids"], dense=pool["dense"],
                        labels=pool["labels"],
                        weights=np.ones(n, np.float32))


def port_names(kind, config: dict) -> dict[str, str]:
    """Benchmark weight name -> the port's state_dict key."""
    d = config["embed_dim"]
    out = {"table": f"embedding.table_w{d}",
           "dense_fo_w": "embedding.dense_fo_w",
           "dense_fo_b": "embedding.dense_fo_b",
           "dense_w": f"embedding.dense_w{d}",
           "dense_b": f"embedding.dense_b{d}",
           **kind.port_names(config)}
    for name, _, linear in kind.heads(config):
        out[f"{name}.w"], out[f"{name}.b"] = (f"{linear}.weight",
                                              f"{linear}.bias")
    if kind.dnn_width(config) is None:
        return out
    for i in range(len(config["dnn_hidden_units"])):
        out[f"dnn.w{i}"] = f"dnn.dense_{i}.weight"
        out[f"dnn.b{i}"] = f"dnn.dense_{i}.bias"
        if config["dnn_batch_norm"]:
            for ours, theirs in (("gamma", "weight"), ("beta", "bias"),
                                 ("mean", "running_mean"),
                                 ("var", "running_var")):
                out[f"bn.{ours}{i}"] = f"dnn.bn_{i}.{theirs}"
    return out


def build_model(kind, config: dict, mix: dict, weights: dict, device: str,
                seed: int):
    """The port's model for the configuration, on ``device``, holding
    ``weights``."""
    cfg = experiment_config(kind, config, mix, device, seed)
    packed = pack_schema(schema(config))
    model = create_model(cfg.model_name, packed, cfg, device=device,
                         seed=seed)
    names = port_names(kind, config)
    state = model.state_dict()
    missing = [k for k in state if k not in names.values()
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the benchmark makes no weight for {missing}")
    with torch.no_grad():
        model.load_state_dict({names[k]: v for k, v in weights.items()},
                              strict=False)
    return cfg, packed, model


def build_trainer(cfg, packed, model, pool: dict, rng_seed: int) -> Trainer:
    return Trainer(model, packed, cfg, train_data=packed_arrays(pool),
                   rng_seed=rng_seed)


def predictor(cfg, packed, model, device) -> Predictor:
    """The ``predict`` command's scorer on one device."""
    return Predictor(model, packed, cfg, device=device)


def leaf_names(kind, config: dict) -> dict[str, str]:
    """Benchmark name -> port name of every trained leaf (not the
    BatchNorm statistics)."""
    return {k: v for k, v in port_names(kind, config).items()
            if not k.startswith(("bn.mean", "bn.var"))}
