"""Dataclass-based configuration with YAML loading and dot-notation overrides.

The port's own copy of ``deepfm_tpu/config.py``: the same dataclasses and
the same YAML contract, so every file under ``configs/`` loads unchanged.
Sections the port does not read yet (``benchmark``, most of
``training``) are kept so those files still parse. The port reads:

  * ``device`` — "auto" and "cuda" run on the GPU, "cpu" on the host;
  * ``pallas.use_cin_kernel`` — on (the default), the CIN stack runs in
    the hand-written CUDA kernel (ops/kernels/cin_stack.py) on the GPU and
    in its plain version on the CPU; off, the plain version on the CPU and
    an error on the GPU, which has no plain path;
  * ``pallas.cin_bf16_operands`` — bf16 operands for that kernel when the
    activations are bfloat16;
  * ``pallas.table_layout`` — "packed" stores the embedding tables packed
    (128 // (d+1) logical rows per 128-float row), "logical" and "auto"
    (the port has no TPU to ask) as (rows, d+1);
  * ``pallas.use_embedding_kernel`` — gathers the logical tables with the
    hand-written row-gather kernel, and forces logical tables;
  * ``training``: ``optimizer``, ``lr``, ``gradient_clip_norm``,
    ``compute_dtype``, ``fused_table_adam``, ``fused_backward`` and
    ``moments_dtype`` (training/trainer.py picks the step's path from
    them), and ``feature.embedding_l2_reg``;
  * ``mesh`` — resolved by the JAX CLI's rules for one device
    (``parallel/mesh.py``): a mesh of more devices, or ``multihost``
    without ``allow_single_process``, is refused;
  * ``profile.debug_nans`` — the train step raises ``FloatingPointError``
    at the first non-finite loss or gradient (``training/steps.py``), and
    ``profile.trace_dir`` — a ``torch.profiler`` trace of ``train``
    (``trace.json``), which carries the port's own ranges
    (``utils/tracing.py``, on while the profiler runs):
    ``deepfm.train.plan`` (the epoch's shuffle and each chunk's gather),
    ``deepfm.train.stage`` (a chunk copied to the device),
    ``deepfm.train.wait`` (the host blocked on the losses),
    ``deepfm.step.forward`` / ``.backward`` / ``.update`` (a train step's
    lookup, model and loss; its ``autograd.grad``; its norm, clip and
    updates) and, in each epoch's val evaluation (not the final test
    evaluation, after the trace stops), ``deepfm.score.stage``,
    ``deepfm.score.forward`` (a batch) and ``deepfm.score.fetch`` (a
    chunk's scores to the host); each epoch's spans are also logged in one
    ``spans:`` line and kept in ``Trainer.timings["spans"]``.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, get_args, get_origin

import yaml


@dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "movielens"
    data_dir: str = "data/ml-100k"
    split_strategy: str = "temporal"
    temporal_val_ratio: float = 0.1
    temporal_test_ratio: float = 0.1
    neg_sampling_alpha: float = 0.75
    min_interactions: int = 3
    label_threshold: float = 4.0
    num_neg_train: int = 4
    num_neg_eval: int = 999
    # Synthetic data controls (used when dataset_name is
    # "synthetic" or "criteo_synthetic"); see data/synthetic.py.
    synthetic_num_users: int = 943
    synthetic_num_items: int = 1682
    synthetic_num_rows: int = 100_000
    synthetic_num_fields: int = 26
    synthetic_vocab_size: int = 100_000
    # Use the native C++ negative sampler when available.
    use_native_sampler: bool = True


@dataclass(frozen=True)
class FeatureConfig:
    fm_embed_dim: int = 16
    embedding_l2_reg: float = 1e-5


@dataclass(frozen=True)
class FMConfig:
    use_first_order: bool = True
    use_second_order: bool = True


@dataclass(frozen=True)
class DNNConfig:
    hidden_units: tuple[int, ...] = (256, 128, 64)
    activation: str = "relu"
    dropout: float = 0.1
    use_batch_norm: bool = True


@dataclass(frozen=True)
class CINConfig:
    layer_sizes: tuple[int, ...] = (128, 128)
    split_half: bool = True


@dataclass(frozen=True)
class AttentionConfig:
    num_heads: int = 4
    attention_dim: int = 64
    num_layers: int = 1
    use_residual: bool = True


@dataclass(frozen=True)
class TrainingConfig:
    num_epochs: int = 50
    batch_size: int = 4096
    lr: float = 1e-3
    optimizer: str = "adam"
    # "reduce_on_plateau" (reference parity), "warmup_cosine"
    # (epoch-granularity linear warmup + cosine decay), or "none".
    scheduler: str = "reduce_on_plateau"
    # Warmup length for scheduler="warmup_cosine" (epochs).
    warmup_epochs: int = 0
    early_stopping_patience: int = 5
    metric: str = "auc"
    gradient_clip_norm: float = 1.0
    ranking_ks: tuple[int, ...] = (1, 5, 10, 20)
    # Additions of the JAX package. The port reads compute_dtype
    # ("float32" or "bfloat16" for the dense towers; params stay f32),
    # fused_table_adam, moments_dtype, fused_backward, stage_budget_mb
    # (the trainer's and Predictor's staging) and resume (Trainer.train).
    compute_dtype: str = "float32"
    resume: bool = False
    stage_budget_mb: int = 1024
    fused_table_adam: bool = True
    moments_dtype: str = "bfloat16"
    fused_backward: bool = True

    def __post_init__(self):
        if self.moments_dtype not in ("float32", "bfloat16"):
            # fail at config time, not deep inside state init — and keep
            # unvetted dtypes (e.g. float16 moments were never A/B'd)
            # out of the storage path
            # ConfigError is defined below at module level; __post_init__
            # runs at construction time, after the module has loaded
            raise ConfigError(
                "training.moments_dtype must be 'float32' or 'bfloat16', "
                f"got {self.moments_dtype!r}"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the JAX package, over the port's ranks (one
    process a device, ``parallel/mesh.py``), by the JAX CLI's rules:
    ``data_axis`` and ``model_axis`` resolve against the world size (one
    rank with a model axis of 1 or -1 needs no mesh; an axis of -1 takes
    the ranks left over); a model axis above 1 row-shards every embedding
    table over it (ROADMAP queue 1 item 10(b); it must divide the tables'
    rows, ``parallel/sharding.py``); ``num_slices`` groups the ranks as
    ``build_hybrid_mesh`` does, the model axis inside a slice;
    ``multihost`` starts the process group from torchrun's environment or
    refuses without a coordinator unless ``allow_single_process``;
    ``embedding_strategy`` ("psum", "all_to_all" or "auto"; read by
    ``parallel/embedding_shard.py``): at a model axis of 1, "auto"
    all-reduces the dense table gradient of the two-pass, lazy and plain
    paths and any other strategy gives them the sparse gradient exchange;
    above 1, "psum" and "all_to_all" are the sharded lookups (the latter
    routed, forward and backward) under the exchange on every path, and
    "auto" the masked slab lookup on logical tables, without the
    sparse-fused path."""

    data_axis: int = -1
    model_axis: int = 1
    embedding_strategy: str = "psum"
    multihost: bool = False
    allow_single_process: bool = False
    num_slices: int = 1


@dataclass(frozen=True)
class PallasConfig:
    """Kernel toggles, named after the JAX package's Pallas kernels.

    The port maps them by meaning: ``use_cin_kernel`` runs the CIN stack
    in the hand-written CUDA kernel (off, the plain version runs on the
    CPU only: the port keeps no plain path on the GPU), and
    ``cin_bf16_operands`` feeds that kernel bf16 operands when the
    activations are bfloat16. ``use_embedding_kernel`` gathers the
    logical tables with the row-gather kernel (ops/kernels/gather.py) and
    forces logical tables. ``use_grad_kernel`` is not read: the table
    gather's backward is always a densify kernel (ops/kernels/grad.py, or
    ops/kernels/packed_grad.py for packed tables), which has no plain path
    on the GPU either.
    """

    use_embedding_kernel: bool = False
    use_cin_kernel: bool = True
    use_attention_kernel: bool = True
    use_grad_kernel: bool = True
    cin_bf16_operands: bool = True
    # Embedding-table storage layout: "auto" and "logical" give plain
    # (pad128(rows), d+1) tables; "packed" gives (pad128(ceil(rows / pack)),
    # 128) tables with pack = 128 // (d+1) (models/__init__.py).
    table_layout: str = "auto"


@dataclass(frozen=True)
class ProfileConfig:
    trace_dir: str = ""
    debug_nans: bool = False


@dataclass(frozen=True)
class BenchmarkConfig:
    warmup_steps: int = 5
    measure_steps: int = 20
    log_throughput: bool = True
    # Single-chip examples/sec reference for the weak-scaling efficiency
    # column (results.json training_info.scaling_efficiency =
    # eps / (num_devices * reference_eps)). 0 = don't report efficiency.
    reference_eps: float = 0.0


@dataclass(frozen=True)
class ExperimentConfig:
    model_name: str = "deepfm"
    seed: int = 42
    # "auto" and "cuda" run on the GPU (and raise without one); "cpu"
    # runs on the host. Nothing falls back from one to the other.
    device: str = "auto"
    output_dir: str = "outputs"
    data: DataConfig = field(default_factory=DataConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    fm: FMConfig = field(default_factory=FMConfig)
    dnn: DNNConfig = field(default_factory=DNNConfig)
    cin: CINConfig = field(default_factory=CINConfig)
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    pallas: PallasConfig = field(default_factory=PallasConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    benchmark: BenchmarkConfig = field(default_factory=BenchmarkConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


class ConfigError(ValueError):
    pass


def _coerce(value: Any, typ: Any, path: str) -> Any:
    """Coerce a raw YAML value into the annotated type, recursively."""
    if is_dataclass(typ):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping for {typ.__name__}")
        return _from_dict(typ, value, path)
    origin = get_origin(typ)
    if origin in (list, tuple):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected list, got {type(value).__name__}")
        args = get_args(typ)
        elem_t = args[0] if args else Any
        out = [_coerce(v, elem_t, f"{path}[{i}]") for i, v in enumerate(value)]
        return tuple(out) if origin is tuple else out
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected float, got {value!r}")
        return float(value)
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected int, got {value!r}")
        return value
    if typ is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"{path}: expected bool, got {value!r}")
        return value
    if typ is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected str, got {value!r}")
        return value
    return value


def _from_dict(cls: type, raw: dict[str, Any], path: str = "") -> Any:
    """Typed construction of a dataclass tree from a nested dict."""
    known = {f.name: f for f in fields(cls)}
    unknown = set(raw) - set(known)
    if unknown:
        raise ConfigError(f"{path or cls.__name__}: unknown keys {sorted(unknown)}")
    kwargs = {}
    hints = {f.name: f.type for f in fields(cls)}
    # Resolve string annotations (from __future__ import annotations).
    import typing

    resolved = typing.get_type_hints(cls)
    for name, value in raw.items():
        typ = resolved.get(name, hints[name])
        kwargs[name] = _coerce(value, typ, f"{path}.{name}" if path else name)
    return cls(**kwargs)


def _parse_value(value: str) -> Any:
    """Parse an override string into bool/int/float/list/str."""
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("[") and value.endswith("]"):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    return value


def apply_overrides(raw: dict[str, Any], overrides: list[str]) -> dict[str, Any]:
    """Apply ``a.b.c=value`` dot-notation overrides to a nested dict in place."""
    for override in overrides:
        if "=" not in override:
            raise ConfigError(f"Override must be key=value, got {override!r}")
        key, value = override.split("=", 1)
        parts = key.strip().split(".")
        target = raw
        for part in parts[:-1]:
            target = target.setdefault(part, {})
            if not isinstance(target, dict):
                raise ConfigError(f"Override path {key!r} collides with a scalar")
        target[parts[-1]] = _parse_value(value.strip())
    return raw


def load_config(
    yaml_path: str | Path | None = None, overrides: list[str] | None = None
) -> ExperimentConfig:
    """Load an ExperimentConfig from YAML with optional dot-notation overrides.

    Mirrors the reference CLI contract (deepfm/config.py:89-110): YAML file
    plus ``key.subkey=value`` override strings with typed scalar parsing.
    """
    raw: dict[str, Any] = {}
    if yaml_path is not None:
        with open(yaml_path) as f:
            raw = yaml.safe_load(f) or {}
    if overrides:
        apply_overrides(raw, overrides)
    return _from_dict(ExperimentConfig, raw)


def config_from_dict(raw: dict[str, Any]) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, raw)
