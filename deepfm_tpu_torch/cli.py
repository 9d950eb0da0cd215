"""CLI of the port: ``train``, ``evaluate``, ``compare``, ``predict``,
``recommend``, ``serve``, ``export``, ``pack-data``, ``synth-data`` and
``synth-packed``.

Port of the matching parts of ``deepfm_tpu/cli.py``: ``train`` (the data
pipeline, the model and ``Trainer.train``, which writes best checkpoints,
the resume state and results.json under ``output_dir``), ``evaluate`` (the
best checkpoint on the val and test splits: with the same seed the same
eval negatives, so it reproduces the test metrics ``train`` wrote when its
last epoch was its best), ``compare`` (the results.json table), the serving
commands over the ``_build_data`` / ``_restore_predictor`` prologue
(``predict``: a u.data-format file scored to tab-separated user, item and
score rows; ``recommend``: one user's top-K unseen items; ``serve``: the
HTTP server),
``pack-data`` (the configured dataset's splits written as an on-disk packed
store, ``data/store.py``), ``synth-data`` and ``synth-packed`` (a
Criteo-scale synthetic packed store written in bounded chunks). A packed
store trains with ``data.dataset_name=packed data.data_dir=DIR``, its
splits memory-mapped. ``export`` writes the best checkpoint as a
``torch.export`` scoring artifact (``utils/export.py``: the plain forward,
a symbolic batch unless ``--batch-size`` pins it, optionally int8 tables)
for one platform, ``cpu`` or ``cuda``, and verifies it against the
in-process scores.

``train``, ``evaluate``, ``predict``, ``recommend`` and ``serve`` first
build the runtime (``build_runtime``, the JAX CLI's
``maybe_init_multihost`` and ``build_runtime``): under
``python -m torch.distributed.run --nproc-per-node N`` each of the N
processes is one rank on one device, the process group starts
(``parallel/mesh.py``; with ``mesh.multihost: false`` too, since the port
runs one process per device where JAX runs one per host), and the
``mesh`` section resolves to a (data, model) mesh over the N ranks
(ROADMAP queue 1 items 10(a) and 10(b)): each data row of ranks trains on
its rows of every global batch, each model column holds one slab of every
embedding table (``mesh.model_axis`` above 1, under
``mesh.embedding_strategy``), and rank 0 alone logs and writes files,
with whole tables. A mesh the ranks cannot form is refused with the JAX
package's message, ``mesh.multihost`` without a coordinator unless
``allow_single_process``, and a batch the data axis does not divide, all
before any data is built; a model axis that does not divide a table's
rows is refused when the model is built.
On N ranks the serving commands score through ``Trainer.predict`` on the
mesh (the JAX CLI's ``_restore_trainer``): each data index scores its
share of the rows in whole batches, the model peers of a data row serve
its lookups from their slabs, and every rank gets every score, the bits
one process gives it. Rank 0 alone writes ``predict``'s file and prints
``recommend``'s table; ``serve`` runs its HTTP server on rank 0, which
broadcasts every dispatch to the other ranks (``serving.py``'s
``RankScorer``) and, when it stops (SIGINT, as ``torch.distributed.run``
sends every rank), sends them the stop that ends them; the other ranks
ignore SIGINT and end on that stop, and while the server idles rank 0's
heartbeat keeps their wait inside the group's timeout. A dispatch that
fails on rank 0 after its broadcast ends the run. ``export`` writes one
artifact: rank 0 exports and verifies on the serving config's 1x1 mesh
(the JAX command's ``use_mesh=False``) while the other ranks wait at a
world barrier.
``profile.debug_nans`` makes ``train`` raise ``FloatingPointError`` at
the first step whose loss or gradients are not finite
(``training/steps.py``).

    python -m deepfm_tpu_torch train --config configs/xdeepfm_movielens_cin_tuned.yaml \\
        --override data.data_dir=DIR output_dir=RUN
    python -m torch.distributed.run --nproc-per-node 2 -m deepfm_tpu_torch \\
        train --config ... --override ... (the same, data-parallel)
    python -m deepfm_tpu_torch evaluate --config ... --override ... (the same)
    python -m deepfm_tpu_torch predict --config ... --override ... \\
        --input DIR/u.data --output scores.tsv
    python -m torch.distributed.run --nproc-per-node 2 -m deepfm_tpu_torch \\
        predict --config ... --override ... mesh.model_axis=2 --input ... \\
        --output ... (the same scores, the tables in two slabs)
    python -m deepfm_tpu_torch recommend --config ... --override ... --user 20 --k 5
    python -m torch.distributed.run --nproc-per-node 2 -m deepfm_tpu_torch \\
        serve --config ... --override ... --port 8080 (Ctrl-C stops every rank)
    python -m deepfm_tpu_torch compare --dir RUN
    python -m deepfm_tpu_torch export --config ... --override ... \
        --output model.pt2 [--platforms cpu|cuda] [--quantize int8] [--batch-size N]
    python -m deepfm_tpu_torch synth-packed --dir STORE --rows 2000000
    python -m deepfm_tpu_torch train --config configs/deepfm_criteo_packed.yaml \\
        --override data.data_dir=STORE output_dir=RUN

The model runs on CUDA (``device: auto`` or ``cuda``) or, with
``--override device=cpu``, on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

from deepfm_tpu_torch.config import ExperimentConfig, load_config
from deepfm_tpu_torch.utils import get_logger, seed_everything

logger = logging.getLogger("deepfm_tpu_torch")


def _build_data(config: ExperimentConfig):
    """Fit the dataset's adapter and pack its splits: (adapter, schema,
    packed, train, val, test). An on-disk packed store gives its splits
    memory-mapped (``data/store.py``), and the trainer reads one chunk of
    rows at a time."""
    from deepfm_tpu_torch.data.packing import pack_schema
    from deepfm_tpu_torch.data.synthetic import build_adapter

    adapter = build_adapter(config.data, seed=config.seed)
    if hasattr(adapter, "build_packed"):
        schema, packed, train_d, val_d, test_d = adapter.build_packed()
        return adapter, schema, packed, train_d, val_d, test_d
    schema, train_ds, val_ds, test_ds = adapter.build()
    packed = pack_schema(schema)
    return (
        adapter,
        schema,
        packed,
        train_ds.pack(packed),
        val_ds.pack(packed),
        test_ds.pack(packed),
    )


def start_runtime(config: ExperimentConfig) -> int:
    """The JAX CLI's ``maybe_init_multihost``: start the process group
    where a coordinator is named (``mesh.multihost``, or a torchrun launch
    of more than one rank; raises where the JAX CLI would); returns the
    number of ranks."""
    from deepfm_tpu_torch.parallel import (
        check_multihost,
        initialize_distributed,
    )
    from deepfm_tpu_torch.parallel.mesh import world_size

    if not check_multihost(config, os.environ):
        initialize_distributed(env=os.environ, device=config.device)
    return world_size()


def build_runtime(config: ExperimentConfig):
    """The JAX CLI's ``maybe_init_multihost`` and ``build_runtime``: start
    the process group (``start_runtime``), resolve ``config.mesh`` over
    the ranks, and return the (data, model) mesh, or None for one device
    without a mesh. Raises where the JAX CLI would."""
    from deepfm_tpu_torch.parallel import (
        build_hybrid_mesh,
        build_mesh,
        resolve_mesh,
    )

    n = start_runtime(config)
    try:
        shape = resolve_mesh(config, n_devices=n)
    except ValueError as e:
        raise ValueError(
            f"{e} (the port runs one rank a device: launch N ranks with "
            "python -m torch.distributed.run --nproc-per-node N; ROADMAP "
            "queue 1 item 10)") from None
    if shape is None:
        return None
    m = config.mesh
    if m.num_slices > 1:
        return build_hybrid_mesh(m.num_slices, m.data_axis, m.model_axis,
                                 device=config.device)
    return build_mesh(m.data_axis, m.model_axis, device=config.device)


def _run_logger(mesh, log_file: str | None = None):
    """The package's logger: rank 0 (or a run without a mesh) logs to the
    console and to ``log_file``; every other rank only warns."""
    import logging

    if mesh is not None and mesh.rank != 0:
        log = get_logger("deepfm_tpu_torch")
        log.setLevel(logging.WARNING)
        return log
    return get_logger("deepfm_tpu_torch", log_file=log_file)


def train_command(config: ExperimentConfig):
    """Train ``config``'s model on its dataset (``Trainer.train``), its log
    lines also in ``output_dir/train.log``; returns the trainer."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.parallel import check_batch
    from deepfm_tpu_torch.training.trainer import Trainer

    mesh = build_runtime(config)
    check_batch(mesh, config.training.batch_size)
    log = _run_logger(mesh, f"{config.output_dir}/train.log")
    seed_everything(config.seed)
    if config.profile.debug_nans:
        log.info("profile.debug_nans: each step checks that its loss and "
                 "gradients are finite (one host read a step)")
    log.info("Loading and preparing data...")
    adapter, schema, packed, train_d, val_d, test_d = _build_data(config)
    log.info(f"Data ready: train={len(train_d)}, val={len(val_d)}, "
             f"test={len(test_d)}")
    log.info(f"Schema: {schema.field_names}")
    model = create_model(config.model_name, packed, config,
                         device=config.device, mesh=mesh)
    trainer = Trainer(
        model, packed, config, train_data=train_d, val_data=val_d,
        test_data=test_d,
        # the adapter drives per-epoch train resampling
        adapter=adapter if hasattr(adapter, "resample_train") else None,
        mesh=mesh,
    )
    log.info(f"Device: {trainer.device}" + ("" if mesh is None else (
        f" (rank 0 of a {mesh.data}x{mesh.model} mesh, {mesh.backend})")))
    log.info(f"Model: {config.model_name} "
             f"({trainer.predictor.n_params:,} parameters)")
    trainer.train()
    return trainer


def evaluate_command(config: ExperimentConfig) -> dict[str, dict]:
    """The best checkpoint's metrics on the val and test splits, logged;
    returns {"val": ..., "test": ...}."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.parallel import check_batch
    from deepfm_tpu_torch.training.trainer import Trainer

    mesh = build_runtime(config)
    check_batch(mesh, config.training.batch_size)
    log = _run_logger(mesh)
    seed_everything(config.seed)
    _, _, packed, _, val_d, test_d = _build_data(config)
    model = create_model(config.model_name, packed, config,
                         device=config.device, mesh=mesh)
    trainer = Trainer(model, packed, config, val_data=val_d,
                      test_data=test_d, mesh=mesh)
    trainer.load_best()
    out = {}
    for split, title, data in (("val", "Validation", val_d),
                               ("test", "Test", test_d)):
        log.info(f"--- {title} ---")
        out[split] = trainer.evaluate(data, split)
        for k, v in out[split].items():
            log.info(f"  {split}_{k} = {v:.4f}")
    return out


def _fmt(d: dict, key: str) -> str:
    v = d.get(key)
    return f"{v:.4f}" if isinstance(v, float) else "-"


def print_comparison_table(runs: list[dict]) -> None:
    """Fixed-width comparison table over results.json runs (reference
    cli.py:115-188, plus a throughput column), as the JAX package prints
    it."""
    w_run, w_model, w_hp, w_m = 28, 18, 20, 10

    seen: set[str] = set()
    for run in runs:
        for key in run.get("test_metrics", {}):
            if key.startswith(("HR@", "NDCG@")):
                seen.add(key)
    hr = sorted((k for k in seen if k.startswith("HR@")),
                key=lambda x: int(x.split("@")[1]))
    ndcg = sorted((k for k in seen if k.startswith("NDCG@")),
                  key=lambda x: int(x.split("@")[1]))
    ranking_keys = hr + ndcg
    # calibration column only when some run reports it
    show_ece = any("ece" in r.get("test_metrics", {}) for r in runs)

    header = (
        "Run".ljust(w_run)
        + "Model".ljust(w_model)
        + "LR·BS·Emb".ljust(w_hp)
        + "Val AUC".rjust(w_m)
        + "Val LogL".rjust(w_m)
        + "Tst AUC".rjust(w_m)
        + "Tst LogL".rjust(w_m)
        + "".join(k.rjust(w_m) for k in ranking_keys)
        + ("Tst ECE".rjust(w_m) if show_ece else "")
        + "BstEp".rjust(w_m)
        + "Ex/s".rjust(w_m + 2)
        + "Eff".rjust(8)
    )
    sep = "-" * len(header)
    print(sep)
    print(header)
    print(sep)
    for run in runs:
        cfg = run.get("config", {})
        tc = cfg.get("training", {})
        fc = cfg.get("feature", {})
        hp = (f"{tc.get('lr', '?')}·{tc.get('batch_size', '?')}·"
              f"{fc.get('fm_embed_dim', '?')}")
        vm = run.get("val_metrics", {})
        tm = run.get("test_metrics", {})
        ti = run.get("training_info", {})
        eps = ti.get("examples_per_sec")
        eps_s = f"{eps:,.0f}" if isinstance(eps, (int, float)) else "-"
        eff = ti.get("scaling_efficiency")
        eff_s = f"{eff:.0%}" if isinstance(eff, (int, float)) else "-"
        print(
            str(run.get("run_id", "?"))[:w_run].ljust(w_run)
            + str(cfg.get("model_name", "?"))[:w_model].ljust(w_model)
            + hp[:w_hp].ljust(w_hp)
            + _fmt(vm, "auc").rjust(w_m)
            + _fmt(vm, "logloss").rjust(w_m)
            + _fmt(tm, "auc").rjust(w_m)
            + _fmt(tm, "logloss").rjust(w_m)
            + "".join(_fmt(tm, k).rjust(w_m) for k in ranking_keys)
            + (_fmt(tm, "ece").rjust(w_m) if show_ece else "")
            + str(ti.get("best_epoch", "-")).rjust(w_m)
            + eps_s.rjust(w_m + 2)
            + eff_s.rjust(8)
        )
    print(sep)


def compare_command(args) -> None:
    base = Path(args.dir)
    files = sorted(base.rglob("results.json"))
    if not files:
        print(f"No results.json files found under {base}")
        return
    print_comparison_table([json.loads(f.read_text()) for f in files])


def _restore_predictor(
    config: ExperimentConfig,
    require: tuple[str, ...] | None = None,
    use_mesh: bool = True,
):
    """Shared serving prologue (the JAX CLI's ``_restore_trainer``): build
    the runtime (``build_runtime``, unless ``use_mesh`` is False: one
    device), the fitted data pipeline and the model, and load the best
    checkpoint. Without a mesh the model runs on ``config.device`` behind
    a ``Predictor``; under one, it is built on the mesh (the rank's slab of
    every table at a model axis above 1) behind a ``Trainer``, whose
    ``predict`` scores the rank's share and all-gathers every score.
    Returns (adapter, packed, val_d, test_d, model, predictor, mesh): the
    ``Predictor`` and None, or the ``Trainer`` and its mesh.
    ``require=(command, *adapter_methods)`` fails fast, before the model
    build, when the dataset's adapter lacks a serving method."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.persistence import load_best
    from deepfm_tpu_torch.training.predict import Predictor
    from deepfm_tpu_torch.training.trainer import Trainer

    mesh = build_runtime(config) if use_mesh else None
    if mesh is not None:
        _run_logger(mesh)
    adapter, schema, packed, train_d, val_d, test_d = _build_data(config)
    if require is not None:
        missing = [m for m in require[1:] if not hasattr(adapter, m)]
        if missing:
            raise SystemExit(
                f"{require[0]}: dataset {config.data.dataset_name!r} has no "
                f"{'/'.join(missing)} path (movielens-format only)"
            )
    model = create_model(config.model_name, packed, config,
                         device=config.device, mesh=mesh)
    if mesh is None:
        load_best(model, config.output_dir)
        predictor = Predictor(model, packed, config, device=config.device)
    else:
        predictor = Trainer(model, packed, config, val_data=val_d,
                            test_data=test_d, mesh=mesh)
        predictor.load_best()
    return adapter, packed, val_d, test_d, model, predictor, mesh


def predict_command(
    config: ExperimentConfig, input_path: str, output_path: str
) -> None:
    """Batch scoring: load the best checkpoint and score every row of a
    u.data-format file through the fitted pipeline, writing
    ``user \\t item \\t score`` per kept row. Rows whose raw ids have no
    metadata are dropped (logged as a warning)."""
    import time

    import numpy as np

    seed_everything(config.seed)
    adapter, packed, _, _, _, predictor, mesh = _restore_predictor(
        config, require=("predict", "score_interactions")
    )
    score_ds, kept, total = adapter.score_interactions(input_path)
    if len(kept) < total:
        logger.warning(
            "dropped %d/%d rows with unknown user/item ids",
            total - len(kept), total,
        )
    score_d = score_ds.pack(packed)

    t0 = time.perf_counter()
    scores = predictor.predict(score_d)
    dt = time.perf_counter() - t0
    if mesh is not None and mesh.rank != 0:
        return

    raw = np.loadtxt(input_path, dtype=np.int64).reshape(-1, 4)[kept]
    with open(output_path, "w") as f:
        for (u, m), s in zip(raw[:, :2], scores):
            f.write(f"{u}\t{m}\t{s:.6f}\n")
    logger.info(
        "Scored %d rows in %.2fs (%.0f rows/s incl. kernel build) -> %s",
        len(scores), dt, len(scores) / max(dt, 1e-9), output_path,
    )


def _export_platform(config: ExperimentConfig, platforms: str | None) -> str:
    """``--platforms`` as one platform: by default the one ``device``
    resolves to (``auto`` and ``cuda`` -> cuda). A ``torch.export``
    program is bound to one device, so a list is refused, where the JAX
    command lowers for several."""
    from deepfm_tpu_torch.utils.export import PLATFORMS

    if platforms is None:
        return "cpu" if str(config.device) == "cpu" else "cuda"
    names = [p.strip() for p in platforms.split(",") if p.strip()]
    if len(names) != 1 or names[0] not in PLATFORMS:
        raise SystemExit(
            f"export: --platforms takes one of {', '.join(PLATFORMS)} (a "
            f"torch.export program is bound to one device), got "
            f"{platforms!r}")
    return names[0]


def export_command(
    config: ExperimentConfig,
    output_path: str,
    platforms: str | None,
    batch_size: int | None,
    quantize: str | None = None,
) -> dict:
    """Export the best checkpoint as a self-contained ``torch.export``
    scoring artifact (``utils/export.py``): the plain forward with its
    parameters, a symbolic batch unless ``batch_size`` pins it, for one
    platform. ``quantize="int8"`` swaps the embedding tables for per-row
    int8 ones (~3.2x smaller). Before it reports success the artifact is
    loaded back and scored on up to 256 val rows (pinned batches padded
    with id-0 rows) against the in-process CPU predict, within 1e-4, or
    0.05 quantized; a quantized symbolic-batch artifact also logs its val
    AUC against the f32 model's. Returns what it measured. On N ranks rank
    0 alone exports, one artifact, while the others wait at a world
    barrier and return {}."""
    seed_everything(config.seed)
    platform = _export_platform(config, platforms)
    if quantize is not None and quantize != "int8":
        raise SystemExit(f"--quantize supports 'int8', got {quantize!r}")
    if start_runtime(config) == 1:
        return _export(config, output_path, platform, batch_size, quantize)
    from deepfm_tpu_torch.parallel import build_mesh, collectives

    world = build_mesh(device=config.device)
    try:
        if world.rank != 0:
            _run_logger(world)
            return {}
        return _export(config, output_path, platform, batch_size, quantize)
    finally:
        collectives.barrier(world)


def _export(config: ExperimentConfig, output_path: str, platform: str,
            batch_size: int | None, quantize: str | None) -> dict:
    """``export_command`` on one device."""
    import time

    import numpy as np

    from deepfm_tpu_torch.data.packing import PackedArrays
    from deepfm_tpu_torch.utils.export import (
        export_scoring,
        input_shapes,
        load_scoring,
        quantized_scoring_model,
        save_scoring,
        serving_config,
    )

    scfg = serving_config(config)
    # the artifact is one program on one device; cross-layout restore
    # loads a packed checkpoint into the serving model's logical tables
    _, packed, val_d, _, model, predictor, _ = _restore_predictor(
        scfg, use_mesh=False)
    export_model = model
    if quantize is not None:
        export_model = quantized_scoring_model(config, packed, model)

    t0 = time.perf_counter()
    try:  # cuda needs a card in this process
        program = export_scoring(export_model, packed.num_slots,
                                 packed.num_dense, platform=platform,
                                 batch_size=batch_size)
    except RuntimeError as e:
        raise SystemExit(f"export: {e}") from None
    export_s = time.perf_counter() - t0
    n_bytes = save_scoring(output_path, program)
    shapes = input_shapes(program)
    logger.info(
        "Exported %s -> %s (%.1f MB, platform=%s, inputs=%s) in %.2f s",
        scfg.model_name, output_path, n_bytes / 1e6, platform, shapes,
        export_s,
    )
    out = {"bytes": n_bytes, "platform": platform, "inputs": shapes,
           "export_s": export_s}

    t0 = time.perf_counter()
    score = load_scoring(output_path)
    out["load_s"] = time.perf_counter() - t0
    k = min(len(val_d), batch_size or 256)
    ids, dense = val_d.ids[:k], val_d.dense[:k]
    if batch_size is not None and k < batch_size:
        # a static batch: pad the verification rows with id-0 (OOV) rows
        # up to the pinned batch and compare only the real k
        pad = batch_size - k
        ids = np.concatenate([ids, np.zeros((pad, ids.shape[1]), np.int32)])
        dense = np.concatenate(
            [dense, np.zeros((pad, dense.shape[1]), np.float32)])
    head = PackedArrays(val_d.ids[:k], val_d.dense[:k], val_d.labels[:k],
                        val_d.weights[:k])
    err = float(np.abs(score(ids, dense)[:k] - predictor.predict(head)).max())
    logger.info("Round-trip verification on %d rows: max|Δ|=%.2e", k, err)
    out["max_abs_err"] = err
    tol = 0.05 if quantize else 1e-4
    if not err <= tol:
        raise SystemExit(f"export verification failed: max|Δ|={err}")
    if quantize and batch_size is None:
        # quality delta of the quantized tables on the val split
        from deepfm_tpu_torch.training.metrics import compute_auc

        q_auc = compute_auc(val_d.labels, score(val_d.ids, val_d.dense))
        f_auc = compute_auc(val_d.labels, predictor.predict(val_d))
        logger.info("Quantized val AUC %.4f vs f32 %.4f (Δ=%+.4f)",
                    q_auc, f_auc, q_auc - f_auc)
        out["auc_delta"] = q_auc - f_auc
    return out


def recommend_command(
    config: ExperimentConfig, user: int, k: int, include_seen: bool
) -> None:
    """Top-K retrieval for one user: score the item catalog (unseen items
    unless ``include_seen``) through the best checkpoint and print the K
    highest-scoring items."""
    import numpy as np

    seed_everything(config.seed)
    if k < 1:
        raise SystemExit(f"recommend: --k must be >= 1, got {k}")
    adapter, packed, _, _, _, predictor, mesh = _restore_predictor(
        config, require=("recommend", "recommend_candidates")
    )
    try:
        ds, item_ids = adapter.recommend_candidates(
            user, exclude_seen=not include_seen
        )
    except ValueError as e:
        raise SystemExit(f"recommend: {e}") from None
    if len(item_ids) == 0:
        raise SystemExit(f"recommend: user {user} has no unseen items")

    scores = predictor.predict(ds.pack(packed))
    if mesh is not None and mesh.rank != 0:
        return
    top = np.argsort(-scores)[:k]
    print(f"Top-{min(k, len(top))} items for user {user}:")
    print(f"{'rank':>4}  {'item':>6}  score")
    for r, i in enumerate(top, 1):
        print(f"{r:>4}  {int(item_ids[i]):>6}  {scores[i]:.4f}")
    logger.info("Scored %d candidate items for user %d", len(item_ids), user)


def serve_command(
    config: ExperimentConfig,
    host: str,
    port: int,
    batch_window_ms: float = 0.0,
    max_rows: int | None = None,
) -> None:
    """Local JSON-over-HTTP scoring server over the best checkpoint:
    GET /health, POST /score, GET /recommend (see serving.py). On N ranks
    rank 0 serves and broadcasts every dispatch (``RankScorer``); the
    other ranks follow until rank 0 stops, on SIGINT, which they ignore.
    A dispatch that fails on rank 0 after its broadcast stops the server
    and raises ``RankFailure``: the run ends, and torchrun ends the other
    ranks."""
    import signal
    import threading

    from deepfm_tpu_torch.serving import (
        DEFAULT_MAX_ROWS,
        RankScorer,
        ScoringService,
        make_http_server,
    )

    adapter, packed, _, _, model, predictor, mesh = _restore_predictor(
        config,
        require=(
            "serve", "score_id_pairs", "known_pair", "now_timestamp",
            "recommend_candidates",
        ),
    )
    if mesh is not None:
        predictor = RankScorer(predictor)
        if mesh.rank != 0:
            signal.signal(signal.SIGINT, signal.SIG_IGN)
            runs = predictor.follow()
            logger.warning("rank %d: stopped by rank 0 after %d dispatches",
                           mesh.rank, runs)
            return
    service = ScoringService(
        adapter, packed, predictor, config.model_name,
        max_rows=max_rows if max_rows is not None else DEFAULT_MAX_ROWS,
        batch_window_ms=batch_window_ms,
    )
    server = None
    try:
        logger.info("Warming up (kernel build and first launch)...")
        service.warmup()
        server = make_http_server(service, host, port)
        if mesh is not None:
            predictor.on_failure = threading.Thread(
                target=server.shutdown, daemon=True).start
        bound = server.server_address
        logger.info(
            "Serving %s on http://%s:%d  (GET /health, POST /score, "
            "GET /recommend?user=U&k=K)%s",
            config.model_name, bound[0], bound[1],
            "" if mesh is None else
            f" on {mesh.world} ranks ({mesh.data}x{mesh.model} mesh)",
        )
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        if mesh is not None:
            # a second SIGINT must not cut the followers' stop short
            signal.signal(signal.SIGINT, signal.SIG_IGN)
        if server is not None:
            server.server_close()
        service.close()
    if mesh is not None:
        predictor.raise_if_failed()


def pack_data_command(config: ExperimentConfig, out_dir: str) -> None:
    """Convert the configured dataset into an on-disk packed store
    (``data/store.py``): fit the adapter once, pack every split, write
    schema.json and the memory-mappable ``.npy`` splits. Training then takes
    ``data.dataset_name=packed data.data_dir=<out>``."""
    from deepfm_tpu_torch.data.store import save_packed, save_schema

    seed_everything(config.seed)
    adapter, schema, packed, train_d, val_d, test_d = _build_data(config)
    if hasattr(adapter, "resample_train"):
        logger.warning(
            "pack-data freezes ONE draw of train negatives: dataset %r "
            "resamples them per epoch when trained directly, so training "
            "from this packed directory changes the negative-sampling "
            "protocol (expect a quality delta vs direct training)",
            config.data.dataset_name,
        )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_schema(schema, out / "schema.json")
    for split, arrays in (("train", train_d), ("val", val_d),
                          ("test", test_d)):
        save_packed(arrays, out / split)
        logger.info("%s: %d rows -> %s", split, len(arrays), out / split)
    logger.info(
        "Packed dataset written to %s (train with data.dataset_name="
        "packed data.data_dir=%s)", out, out,
    )


def synth_packed_command(args) -> None:
    import dataclasses

    from deepfm_tpu_torch.config import DataConfig
    from deepfm_tpu_torch.data.store import write_synthetic_packed

    dcfg = dataclasses.replace(
        DataConfig(),
        dataset_name="criteo_synthetic",
        synthetic_num_rows=args.rows,
        synthetic_num_fields=args.fields,
        synthetic_vocab_size=args.vocab,
    )
    path = write_synthetic_packed(args.dir, dcfg, seed=args.seed,
                                  chunk_rows=args.chunk_rows)
    print(f"Packed synthetic dataset written to {path}")


def synth_data_command(args) -> None:
    from deepfm_tpu_torch.data.synthetic import generate_movielens_like

    path = generate_movielens_like(
        args.dir,
        num_users=args.users,
        num_items=args.items,
        num_rows=args.rows,
        seed=args.seed,
    )
    print(f"Synthetic ML-100K-format dataset written to {path}")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="deepfm_tpu_torch",
        description="CTR prediction on PyTorch/CUDA: DeepFM, xDeepFM, "
        "AttentionDeepFM, AutoInt and the LR / FM / DNN baselines",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    for name, help_ in [
        ("train", "Train a model"),
        ("evaluate", "Evaluate a saved model"),
        ("predict", "Batch-score an interactions file (serving)"),
        ("pack-data", "Convert the configured dataset to a packed dir"),
        ("recommend", "Top-K item retrieval for a user (serving)"),
        ("serve", "JSON-over-HTTP scoring/retrieval endpoint (serving)"),
        ("export", "Export a torch.export scoring artifact (serving)"),
    ]:
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", required=True, help="Path to YAML config")
        p.add_argument(
            "--override", nargs="*", default=[],
            help="Override config values, e.g. training.num_epochs=10",
        )
        if name == "pack-data":
            p.add_argument(
                "--out", required=True,
                help="Output directory for the packed dataset",
            )
        if name == "recommend":
            p.add_argument(
                "--user", type=int, required=True, help="Raw user id"
            )
            p.add_argument("--k", type=int, default=10)
            p.add_argument(
                "--include-seen", action="store_true",
                help="Rank already-interacted items too",
            )
        if name == "predict":
            p.add_argument(
                "--input", required=True,
                help="u.data-format file (user\\titem\\trating\\tts; "
                "rating may be 0 for unlabeled traffic)",
            )
            p.add_argument(
                "--output", required=True,
                help="Output TSV path (user\\titem\\tscore per kept row)",
            )
        if name == "export":
            p.add_argument(
                "--output", required=True,
                help="Artifact path (e.g. model.pt2)",
            )
            p.add_argument(
                "--platforms", default=None,
                help="The one platform the program runs on: cpu or cuda "
                "(default: the config's device)",
            )
            p.add_argument(
                "--batch-size", type=int, default=None,
                help="Pin a static batch size (default: symbolic batch)",
            )
            p.add_argument(
                "--quantize", default=None, choices=["int8"],
                help="Quantize embedding tables (per-row int8 scales; "
                "~3.2x smaller artifact)",
            )
        if name == "serve":
            p.add_argument("--host", default="127.0.0.1")
            p.add_argument("--port", type=int, default=8080)
            p.add_argument(
                "--batch-window-ms", type=float, default=0.0,
                help="coalesce concurrent /score requests arriving within "
                "this window into one device dispatch (0=off)",
            )
            p.add_argument(
                "--max-rows", type=int, default=None,
                help="max rows per /score request (default 16384)",
            )

    cmp_p = sub.add_parser("compare", help="Compare experiment results")
    cmp_p.add_argument("--dir", default="outputs")

    sd = sub.add_parser(
        "synth-data", help="Generate an ML-100K-format synthetic dataset"
    )
    sd.add_argument("--dir", default="data/ml-100k-synth")
    sd.add_argument("--users", type=int, default=300)
    sd.add_argument("--items", type=int, default=400)
    sd.add_argument("--rows", type=int, default=20000)
    sd.add_argument("--seed", type=int, default=0)

    sp = sub.add_parser(
        "synth-packed",
        help="Generate an on-disk packed Criteo-scale dataset "
        "(bounded-memory; train with data.dataset_name=packed)",
    )
    sp.add_argument("--dir", default="data/criteo-packed")
    sp.add_argument("--rows", type=int, default=1_000_000)
    sp.add_argument("--fields", type=int, default=26)
    sp.add_argument("--vocab", type=int, default=100_000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--chunk-rows", type=int, default=1_000_000)

    args = parser.parse_args(argv)
    if args.command == "compare":
        compare_command(args)
        return
    if args.command == "synth-data":
        synth_data_command(args)
        return
    if args.command == "synth-packed":
        synth_packed_command(args)
        return
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    config = load_config(args.config, args.override or None)
    if args.command == "train":
        train_command(config)
    elif args.command == "evaluate":
        evaluate_command(config)
    elif args.command == "predict":
        predict_command(config, args.input, args.output)
    elif args.command == "recommend":
        recommend_command(config, args.user, args.k, args.include_seen)
    elif args.command == "pack-data":
        pack_data_command(config, args.out)
    elif args.command == "export":
        export_command(config, args.output, args.platforms, args.batch_size,
                       args.quantize)
    else:
        serve_command(
            config, args.host, args.port,
            batch_window_ms=args.batch_window_ms,
            max_rows=args.max_rows,
        )


if __name__ == "__main__":
    main()
