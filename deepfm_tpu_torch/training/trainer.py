"""The trainer: the train step's state and gates, and the epoch loop.

Port of ``deepfm_tpu/training/trainer.py`` on one device: ``TrainState``,
``_is_table_name``, the gates ``_use_fused_table_adam`` /
``sparse_fused_eligible``, and the ``Trainer`` with the reference's
constructor (train, val and test data, the adapter, ``rng_seed``): its
state construction, ``_train_step`` (``training/steps.py``; the seam
``bench.py`` times), ``_chunk_plan`` (the JAX shuffle stream, padding with
weight 0, chunks capped by ``stage_budget_mb``), ``_train_epoch`` (chunks
staged to the device one ahead, at most two resident, losses summed on the
device with one host read a chunk), ``predict`` / ``evaluate`` (on
``training/predict.py::Predictor``) and ``train``: per-epoch negative
resampling prefetched on a worker thread, the learning-rate scheduler
stepped once an epoch on the val metric (the first epoch runs at
``scheduler.lr``), early stopping, best checkpoints, resume, throughput and
history, an optional ``torch.profiler`` trace (``profile.trace_dir``, with
the port's ``deepfm.*`` spans of ``utils/tracing.py``, each epoch's also
logged and kept in ``timings["spans"]``), and
the final test evaluation on the last epoch's state and results.json
(``training/persistence.py``). With ``profile.debug_nans`` a step raises
``FloatingPointError`` before its update when its loss or global gradient
norm is not finite (``training/steps.py``; one host read a step, none
when unset).

Under a ``mesh`` (``parallel.Mesh``, one rank a device; ROADMAP queue 1
items 10(a) and 10(b)) the trainer is one rank's: its state lives on
``mesh.device``; at a model axis above 1 it holds its slab of every
table, of the tables' moments and of their plain-chain optimizer leaves
(``models.create_model`` cuts the tables from the whole model built from
the seed), and ``table_psq`` is the whole tables' (the slabs' sums over
the model group). At construction an all-gathered fingerprint shows that
the replicated parameters are the same bits on every rank, and each slab
on every rank of its data group (nothing is broadcast to cover a
difference). Every rank draws the same shuffles and resamples (they all
build the dataset from the seed) and stages only its data index's rows of
each global batch (``parallel/sharding.py``); dropout draws from a
generator seeded from the seed and the data index, so model peers draw
the same masks. ``predict`` / ``evaluate`` score the data index's
contiguous share of the split in whole batches (model peers score the
same share: the lookup's collectives need them) and all-gather the scores
over the data group, so every rank computes the same metrics; rank 0
alone writes the checkpoints and results.json, with whole tables
gathered over its model group (``training/persistence.py``).
``throughput`` reports the global examples/s, ``num_devices`` and
``examples_per_sec_per_device``.

The gates are resolved from the config alone, on every device: the CPU
runs each kernel's plain version, so the tests take the same paths as the
card. With the defaults (``adam``, ``fused_table_adam``,
``fused_backward``) the step takes the sparse-fused path;
``fused_backward: false`` takes the two-pass path (densify, then fused
table Adam); ``optimizer: lazy_adam`` the lazy path (the densified table
gradient, a global clip, masked dense Adam and row-sparse table Adam with
f32 moments); ``fused_table_adam: false``, ``adamw`` or ``sgd`` take the
plain optax chain. With ``pallas.use_embedding_kernel`` the row-gather
kernel is the lookup, and the step takes two-pass, lazy or plain, as in
the JAX package, whose sparse-fused gate wants the default lookup. Every
path runs on both table layouts (``pallas.table_layout``); the
sparse-fused one also on the logical layout, where the JAX package needs
packed tables. The TPU's width gate (128 // (d+1) > 1) and its f32-exact
id limit do not apply and are dropped.

Dropout draws from ``Trainer.dropout_generator`` (seeded from the seed
and the data index, ``dropout_seed``; carried by the resume checkpoint with the
shuffle's and the adapter's RNG states, so a resumed run repeats an
unbroken one); its masks are PyTorch's, not the JAX package's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from deepfm_tpu_torch.config import ExperimentConfig
from deepfm_tpu_torch.data.packing import PackedArrays, PackedSchema
from deepfm_tpu_torch.device import resolve_device
from deepfm_tpu_torch.models.base import CTRModel
from deepfm_tpu_torch.ops.dnn import BatchNorm, Dropout
from deepfm_tpu_torch.ops.kernels import launch_counts
from deepfm_tpu_torch.parallel import collectives
from deepfm_tpu_torch.parallel.sharding import (
    batch_rows,
    check_batch,
    check_placement,
    sharded,
    slabs_without_exchange,
    split_bounds,
)
from deepfm_tpu_torch.training.metrics import (
    compute_auc,
    compute_calibration,
    compute_logloss,
    grouped_ranking_metrics,
)
from deepfm_tpu_torch.training.optim import OptState, build_optimizer
from deepfm_tpu_torch.training.predict import Predictor
from deepfm_tpu_torch.training.schedulers import build_scheduler, set_lr
from deepfm_tpu_torch.training.sparse_opt import (
    TableSlotState,
    init_table_state,
)
from deepfm_tpu_torch.utils import tracing
from deepfm_tpu_torch.utils.logging import get_logger

@dataclass
class TrainState:
    """What a step carries besides the model's parameters and BatchNorm
    statistics (which live in the module)."""

    step: torch.Tensor  # completed steps, int32 0-dim
    opt_state: OptState
    # fused table paths and lazy_adam: per-table Adam moments (name ->
    # state)
    table_opt: dict[str, TableSlotState] | None = None
    # sparse-fused path: per-table sum(p^2), carried across steps from the
    # kernel so the decayed clip norm is assembled without reading the
    # table (name -> f32 0-dim)
    table_psq: dict[str, torch.Tensor] | None = None


def dropout_seed(seed: int, data_index: int) -> int:
    """The dropout generator's seed at ``data_index``: ``seed`` at 0 (a
    mesh-less run's), one drawn from (seed, data index) at the others.
    The model peers of a data row share it, so they draw the same masks
    on the same rows."""
    if data_index == 0:
        return seed
    return int(np.random.SeedSequence([seed, data_index]).generate_state(
        1)[0])


def _is_table_name(name: str) -> bool:
    return name.split(".")[-1].startswith(("table_w", "fo_table"))


def _use_fused_table_adam(config: ExperimentConfig) -> bool:
    """Fused table Adam (``ops/kernels/adam.py``) for the tables: Adam
    with ``training.fused_table_adam`` on."""
    return (config.training.optimizer == "adam"
            and config.training.fused_table_adam)


def sparse_fused_eligible(config: ExperimentConfig,
                          packed_schema: PackedSchema, mesh=None) -> bool:
    """True when the step takes the fused sparse backward-optimizer path
    (``ops/kernels/sparse_adam.py``): it gathers the rows itself, so it
    wants the default lookup, not the row-gather kernel. Never under
    ``lazy_adam``, which is not fused table Adam. At a model axis above 1
    it gathers through the strategy's lookup, so it needs a strategy other
    than "auto" (the JAX package's factory;
    ``parallel.sharding.slabs_without_exchange``)."""
    if slabs_without_exchange(mesh, config.mesh.embedding_strategy):
        return False
    return (
        _use_fused_table_adam(config)
        and config.training.fused_backward
        and not config.pallas.use_embedding_kernel
        and len(packed_schema.lookup_groups) > 0
    )


class Trainer:
    """Trains a CTR model on one device (``config.device``: the GPU unless
    the config asks for the CPU), or as one rank of a data-parallel
    ``mesh`` on ``mesh.device``. The data and the adapter are needed by
    ``train`` only; a trainer built without them takes steps
    (``_train_step``, on the rank's rows under a mesh) and evaluates."""

    def __init__(
        self,
        model: CTRModel,
        packed_schema: PackedSchema,
        config: ExperimentConfig,
        train_data: PackedArrays | None = None,
        val_data: PackedArrays | None = None,
        test_data: PackedArrays | None = None,
        adapter: Any | None = None,
        rng_seed: int | None = None,
        mesh=None,
    ) -> None:
        check_batch(mesh, config.training.batch_size)
        self.mesh = mesh
        self.scheduler = build_scheduler(config.training)
        self.config = config
        self.packed_schema = packed_schema
        self.train_data = train_data
        self.val_data = val_data
        self.test_data = test_data
        self.adapter = adapter
        self.logger = get_logger("deepfm_tpu_torch.trainer")
        self.output_dir = Path(config.output_dir)
        self.device = (mesh.device if mesh is not None
                       else resolve_device(config.device))
        self.model = model.to(self.device)
        seed = config.seed if rng_seed is None else rng_seed
        # the epochs' shuffles: the same on every rank
        self.np_rng = np.random.default_rng(seed)
        self.dropout_generator = torch.Generator(device=self.device)
        self.dropout_generator.manual_seed(
            dropout_seed(seed, 0 if mesh is None else mesh.data_index))
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_generator
            if isinstance(m, BatchNorm):
                m.mesh = mesh
        check_placement(mesh, dict(self.model.named_parameters()),
                        "the parameters built from the seed")
        self.predictor = Predictor(self.model, packed_schema, config,
                                   device=self.device)
        self.lazy_tables = config.training.optimizer == "lazy_adam"
        self.fused_tables = _use_fused_table_adam(config)
        self.sparse_fused = (
            sparse_fused_eligible(config, packed_schema, mesh)
            and not model.embedding.gather_kernel)
        self.path = ("sparse_fused" if self.sparse_fused
                     else "two_pass" if self.fused_tables
                     else "lazy" if self.lazy_tables else "plain")
        self.table_names = [n for n, _ in model.named_parameters()
                            if _is_table_name(n)]
        # table name -> logical rows per physical row (1: logical layout)
        self._table_pack = {f"embedding.{k}": v
                            for k, v in model.embedding.table_pack.items()}
        self._table_layout = model.table_layout
        self.tx = build_optimizer(
            config, self.table_names, fused=self.fused_tables,
            model_group=mesh.model_group if sharded(mesh) else None)
        self.state = self._init_state()
        # warmup: epoch 1 starts below the base LR
        set_lr(self.state.opt_state, self.scheduler.lr)
        from deepfm_tpu_torch.training.steps import build_train_step

        self._step_fn = build_train_step(self)
        self.epoch = 0
        self.throughput: dict[str, float] = {}
        # per-epoch records (train loss, lr, val metrics, throughput),
        # shipped under results.json "history" and carried across resume
        self.history: list[dict] = []
        # where each epoch's seconds went (host clock): staging, the val
        # evaluation and its scoring (the rest is the metrics' numpy); and
        # the final test evaluation's. While tracing is on, "spans" has
        # each epoch's spans and counters (``tracing.since``)
        self.timings: dict[str, list] = {
            "epoch_seconds": [], "stage_seconds": [], "val_seconds": [],
            "val_predict_seconds": [], "test_seconds": [],
            "test_predict_seconds": [], "spans": []}
        self._predict_seconds = 0.0
        self._stage_seconds = 0.0
        self._launches_at_start: dict[str, int] | None = None
        # the adapter's RNG state before the next epoch's resample (what a
        # resume from the end of the current epoch restores)
        self._adapter_rng_state = None

    @property
    def params(self) -> dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def replica_state(self) -> dict[str, torch.Tensor]:
        """Every tensor a step changes, by name: the parameters and
        BatchNorm statistics, the optimizer state, the table moments and
        the carried table sums of squares."""
        st = self.state
        out = dict(self.model.state_dict())
        out["step"] = st.step
        out["opt.lr"], out["opt.count"] = st.opt_state.lr, st.opt_state.count
        for kind in ("mu", "nu"):
            for n, t in getattr(st.opt_state, kind).items():
                out[f"opt.{kind}.{n}"] = t
        for n, s in (st.table_opt or {}).items():
            out[f"{n}.mu"], out[f"{n}.nu"] = s.mu, s.nu
        for n, t in (st.table_psq or {}).items():
            out[f"{n}.psq"] = t
        return out

    def check_replicas(self, what: str = "the train state") -> None:
        """Raise unless every rank's ``replica_state`` has the same bits
        (an all-gathered fingerprint): the replicated tensors over the
        world, the table slabs, their moments and ``table_psq`` over the
        data group; nothing without a mesh."""
        check_placement(self.mesh, self.replica_state(), what)

    def _init_state(self) -> TrainState:
        params = self.params
        state = TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            opt_state=self.tx.init(params),
        )
        if self.fused_tables or self.lazy_tables:
            # bf16 moments apply only to the fused kernels: lazy_adam's
            # row-sparse update keeps the table's f32
            mdt = (getattr(torch, self.config.training.moments_dtype)
                   if self.fused_tables else None)
            state.table_opt = {n: init_table_state(params[n].detach(), mdt)
                               for n in self.table_names}
        if self.sparse_fused:
            from deepfm_tpu_torch.training.persistence import table_psq

            state.table_psq = table_psq(self)
        return state

    def load_best(self, output_dir=None) -> dict:
        """Load a best checkpoint (either table layout; ``output_dir``
        defaults to the config's) into the live model and re-derive the
        carried table sums of squares; returns the checkpoint's
        metadata."""
        from deepfm_tpu_torch.training.persistence import (
            load_best,
            recompute_table_psq,
        )

        meta = load_best(self.model,
                         self.output_dir if output_dir is None else output_dir)
        recompute_table_psq(self)
        return meta

    def _as_tensor(self, x: Any, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.device, dtype)

    def _train_step(self, ids, dense, labels, weights) -> torch.Tensor:
        """One step in place (parameters, BatchNorm statistics, optimizer
        and table state); returns the weighted BCE loss (f32 0-dim, on the
        device, without the L2 term, as the JAX step logs it)."""
        return self._step_fn(
            self,
            self._as_tensor(ids, torch.int64),
            self._as_tensor(dense, torch.float32),
            self._as_tensor(labels, torch.float32),
            self._as_tensor(weights, torch.float32),
        )

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------

    def _budget_batches(self, data: PackedArrays, batch_size: int) -> int:
        """How many batches fit the staging budget (>= 1)."""
        return self.predictor.budget_batches(data, batch_size)

    def _chunk_plan(self, data: PackedArrays, batch_size: int, *,
                    shuffle: bool, drop_remainder: bool):
        """Yield (num_batches, host_arrays) chunks of the (shuffled,
        padded) epoch without staging them: the JAX ``Trainer``'s batches
        for the same ``np_rng`` state (ids, dense, labels and weights, the
        padding's weight 0), in chunks of at most ``_budget_batches``. Lazy:
        only the chunk being built holds host memory."""
        n = len(data)
        order = np.arange(n)
        if shuffle:
            self.np_rng.shuffle(order)
        if drop_remainder and n >= batch_size:
            usable = (n // batch_size) * batch_size
            order = order[:usable]
        nb = -(-len(order) // batch_size)
        pad = nb * batch_size - len(order)
        weights = np.ones(len(order), np.float32)
        if pad:
            order = np.concatenate([order, np.zeros(pad, np.int64)])
            weights = np.concatenate([weights, np.zeros(pad, np.float32)])

        chunk_nb = max(1, min(nb, self._budget_batches(data, batch_size)))

        for start in range(0, nb, chunk_nb):
            cb = min(chunk_nb, nb - start)
            sl = order[start * batch_size : (start + cb) * batch_size]
            wl = weights[start * batch_size : (start + cb) * batch_size]
            yield cb, (
                data.ids[sl].reshape(cb, batch_size, -1),
                data.dense[sl].reshape(cb, batch_size, -1),
                data.labels[sl].reshape(cb, batch_size),
                wl.reshape(cb, batch_size),
            )

    def _stage(self, arrays) -> tuple[torch.Tensor, ...]:
        """A chunk's host arrays (batches, rows, ...) on the device, only
        the rank's data index's rows of each batch: ids as int64, the rest
        f32."""
        dtypes = (torch.int64, torch.float32, torch.float32, torch.float32)
        rows = batch_rows(self.mesh, arrays[0].shape[1])
        out, nbytes = [], 0
        t0 = time.perf_counter()
        with tracing.span("train.stage"):
            for a, dt in zip(arrays, dtypes):
                host = np.ascontiguousarray(a[:, rows])
                nbytes += host.nbytes
                out.append(torch.from_numpy(host).to(
                    self.device, non_blocking=True).to(dt))
        self._stage_seconds += time.perf_counter() - t0
        tracing.count("train.stage_bytes", nbytes)
        return tuple(out)

    # ------------------------------------------------------------------
    # training loop
    # ------------------------------------------------------------------

    def _train_epoch(self) -> tuple[float, int]:
        """One epoch over ``train_data``; returns the mean loss over its
        batches and its example count."""
        tc = self.config.training
        n = len(self.train_data)
        drop = n >= tc.batch_size  # keep BN stats clean of padded rows
        plan = self._chunk_plan(self.train_data, tc.batch_size, shuffle=True,
                                drop_remainder=drop)
        # chunk i + 1 is staged while chunk i's steps run; before staging
        # chunk i + 2 the host reads chunk i's loss, so at most two staged
        # chunks are on the device, whatever the epoch's size
        with tracing.span("train.plan"):
            nxt = next(plan, None)
        staged_next = self._stage(nxt[1]) if nxt is not None else None
        nb, losses, prev_loss = 0, [], None
        while nxt is not None:
            cb = nxt[0]
            staged, staged_next = staged_next, None
            chunk_loss = None
            for i in range(cb):
                loss = self._train_step(*(a[i] for a in staged))
                chunk_loss = loss if chunk_loss is None else chunk_loss + loss
            staged = None  # released once its steps have run
            with tracing.span("train.plan"):
                nxt = next(plan, None)
            if nxt is not None:
                if prev_loss is not None:
                    with tracing.span("train.wait"):
                        float(prev_loss)
                staged_next = self._stage(nxt[1])
            losses.append(chunk_loss)
            prev_loss = chunk_loss
            nb += cb
        with tracing.span("train.wait"):
            total_loss = sum(float(x) for x in losses)
        n_examples = (nb * tc.batch_size if drop
                      else min(n, nb * tc.batch_size))
        return total_loss / max(nb, 1), n_examples

    def train(self) -> dict[str, float]:
        """The epoch loop (see the module docstring); returns the best
        epoch's val metrics."""
        from deepfm_tpu_torch.training import persistence

        tc = self.config.training
        best_metric = -float("inf")
        best_epoch = 0
        patience_counter = 0
        best_metrics: dict[str, float] = {}
        self._launches_at_start = launch_counts()
        if tc.resume:
            resumed = persistence.try_resume(self)
            if resumed:
                best_metric = resumed.get("best_metric", best_metric)
                best_epoch = resumed.get("best_epoch", 0)
                best_metrics = resumed.get("best_metrics", {})
                patience_counter = resumed.get("patience_counter", 0)
        epoch = self.epoch

        profiler = None
        # the port's spans (utils/tracing.py) open their deepfm.* ranges
        # in the trace while the profiler runs
        tracing_was_on = tracing.enabled()
        if self.config.profile.trace_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.start()
            tracing.enable()

        # The per-epoch resample runs on the host; the next epoch's is
        # prefetched on a worker thread while this epoch trains. One
        # resample an epoch, in order, so the adapter's RNG stream is the
        # synchronous sequence's.
        resample_pool = resample_future = None
        resample = self.adapter is not None and hasattr(
            self.adapter, "resample_train")
        if resample and tc.num_epochs - epoch > 1:
            from concurrent.futures import ThreadPoolExecutor

            resample_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="resample")
        try:
            for epoch in range(epoch + 1, tc.num_epochs + 1):
                self.epoch = epoch
                if resample and epoch > 1:
                    ds = (resample_future.result()
                          if resample_future is not None
                          else self.adapter.resample_train())
                    resample_future = None
                    self.train_data = ds.pack(self.packed_schema)
                if resample:
                    self._adapter_rng_state = self.adapter.rng_state()
                if resample_pool is not None and epoch < tc.num_epochs:
                    resample_future = resample_pool.submit(
                        self.adapter.resample_train)

                self._stage_seconds = 0.0
                traced = tracing.snapshot() if tracing.enabled() else None
                t0 = time.perf_counter()
                train_loss, n_examples = self._train_epoch()
                dt = time.perf_counter() - t0
                eps = n_examples / max(dt, 1e-9)
                n_dev = 1 if self.mesh is None else self.mesh.size
                self.throughput = {
                    "examples_per_sec": eps,
                    "epoch_seconds": dt,
                    "num_devices": n_dev,
                    "examples_per_sec_per_device": eps / n_dev,
                }
                ref_eps = self.config.benchmark.reference_eps
                if ref_eps > 0:
                    self.throughput["scaling_efficiency"] = eps / (
                        n_dev * ref_eps)

                t1 = time.perf_counter()
                val_metrics = self.evaluate(self.val_data, "val")
                val_seconds = time.perf_counter() - t1
                for key, v in (("epoch_seconds", dt),
                               ("stage_seconds", self._stage_seconds),
                               ("val_seconds", val_seconds),
                               ("val_predict_seconds", self._predict_seconds)):
                    self.timings[key].append(v)
                current = val_metrics.get(tc.metric,
                                          val_metrics.get("auc", 0.0))
                self.logger.info(
                    f"Epoch {epoch}/{tc.num_epochs}  "
                    f"train_loss={train_loss:.4f}  "
                    f"val_auc={val_metrics.get('auc', 0):.4f}  "
                    f"val_logloss={val_metrics.get('logloss', 0):.4f}  "
                    f"lr={self.scheduler.lr:.2e}  "
                    f"ex/s={eps:,.0f}  epoch_s={dt:.2f} "
                    f"(staging {self._stage_seconds:.2f})  "
                    f"val_s={val_seconds:.2f}"
                )
                if traced is not None:
                    spent = tracing.since(traced)
                    self.timings["spans"].append(spent)
                    self.logger.info(f"  spans: {tracing.describe(spent)}")
                self.history.append({
                    "epoch": epoch,
                    "train_loss": float(train_loss),
                    "lr": float(self.scheduler.lr),
                    "epoch_seconds": dt,
                    "examples_per_sec": eps,
                    **{f"val_{k}": v for k, v in val_metrics.items()},
                })

                set_lr(self.state.opt_state, self.scheduler.step(current))

                if current > best_metric:
                    best_metric = current
                    best_epoch = epoch
                    patience_counter = 0
                    best_metrics = val_metrics
                    # every rank gathers the slabs; without them only the
                    # writer copies its state
                    whole = (persistence.whole_state_dict(self)
                             if self.is_writer or sharded(self.mesh)
                             else None)
                    if self.is_writer:
                        persistence.save_best(self.model, self.output_dir,
                                              epoch, best_metric,
                                              state=whole)
                    collectives.barrier(self.mesh)
                    self.logger.info(
                        f"  -> New best {tc.metric}={current:.4f}, saved "
                        f"checkpoint")
                else:
                    patience_counter += 1
                    if patience_counter >= tc.early_stopping_patience:
                        self.logger.info(
                            f"Early stopping at epoch {epoch} (no "
                            f"improvement for {tc.early_stopping_patience} "
                            f"epochs)")
                        break
                persistence.save_resume(self, epoch, best_metric, best_epoch,
                                        best_metrics, patience_counter)
        finally:
            if resample_pool is not None:
                # join an in-flight resample: the worker draws from the
                # adapter's RNG, which a later resample in this process
                # must find where the synchronous sequence leaves it
                resample_pool.shutdown(wait=True, cancel_futures=True)
            if profiler is not None:
                if not tracing_was_on:
                    tracing.disable()
                profiler.stop()
                trace = Path(self.config.profile.trace_dir)
                trace.mkdir(parents=True, exist_ok=True)
                name = ("trace.json" if self.is_writer
                        else f"trace_rank{self.mesh.rank}.json")
                profiler.export_chrome_trace(str(trace / name))

        self.logger.info("--- Final evaluation on test set ---")
        t1 = time.perf_counter()
        test_metrics = self.evaluate(self.test_data, "test")
        self.timings["test_seconds"].append(time.perf_counter() - t1)
        self.timings["test_predict_seconds"].append(self._predict_seconds)
        for k, v in test_metrics.items():
            self.logger.info(f"  test_{k} = {v:.4f}")
        persistence.save_results_file(self, best_metrics, test_metrics,
                                      best_epoch, epoch)
        return best_metrics

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def predict(self, data: PackedArrays) -> np.ndarray:
        """Sigmoid probabilities for every row of ``data``, in order
        (``Predictor.predict``: chunks of ``stage_budget_mb``, one host
        fetch a chunk). Under a mesh each data index scores its contiguous
        share in whole batches (``split_bounds``: each batch the one a
        single process scores; the model peers of a data row score the
        same share, whose lookups they serve together) and the shares are
        all-gathered over the data group, padded to one length and
        trimmed, so every rank returns every score, each the bits one
        process gives it."""
        if self.mesh is None or self.mesh.world == 1:
            return self.predictor.predict(data)
        bounds = split_bounds(self.mesh.data, len(data),
                              self.config.training.batch_size)
        lo, hi = bounds[self.mesh.data_index]
        longest = max(h - l for l, h in bounds)
        part = PackedArrays(data.ids[lo:hi], data.dense[lo:hi],
                            data.labels[lo:hi], data.weights[lo:hi])
        scores = torch.zeros(longest, dtype=torch.float32,
                             device=self.device)
        scores[:hi - lo] = torch.from_numpy(self.predictor.predict(part))
        every = collectives.all_gather_rows(self.mesh.data_group,
                                            scores).cpu().numpy()
        every = every.reshape(self.mesh.data, longest)
        return np.concatenate([every[r, :h - l]
                               for r, (l, h) in enumerate(bounds)])

    def evaluate(self, data: PackedArrays,
                 split_name: str = "eval") -> dict[str, float]:
        """The reference's metric dict: AUC (0.0 for a single class),
        logloss, calibration and, where the rows carry user ids, the
        grouped ranking metrics at ``training.ranking_ks``."""
        t0 = time.perf_counter()
        scores = self.predict(data)  # ends in a host fetch
        self._predict_seconds = time.perf_counter() - t0
        labels = data.labels
        metrics: dict[str, float] = {}
        try:
            metrics["auc"] = compute_auc(labels, scores)
        except ValueError:
            metrics["auc"] = 0.0
        metrics["logloss"] = compute_logloss(labels, scores)
        metrics.update(compute_calibration(labels, scores))
        if data.user_ids is not None:
            metrics.update(grouped_ranking_metrics(
                data.user_ids, scores, labels,
                self.config.training.ranking_ks))
        return metrics
