"""CLI of the port: ``train``, ``evaluate``, ``compare``, ``serve`` and
``synth-data``.

Port of the matching parts of ``deepfm_tpu/cli.py``: ``train`` (the data
pipeline, the model and ``Trainer.train``, which writes best checkpoints,
the resume state and results.json under ``output_dir``), ``evaluate`` (the
best checkpoint on the val and test splits: with the same seed the same
eval negatives, so it reproduces the test metrics ``train`` wrote when its
last epoch was its best), ``compare`` (the results.json table), ``serve``
with its ``_build_data`` / ``_restore_predictor`` prologue, and
``synth-data``. ``predict``, ``recommend``, ``export``, ``pack-data`` and
``synth-packed`` come with later slices.

    python -m deepfm_tpu_torch train --config configs/xdeepfm_movielens_cin_tuned.yaml \\
        --override data.data_dir=DIR output_dir=RUN
    python -m deepfm_tpu_torch evaluate --config ... --override ... (the same)
    python -m deepfm_tpu_torch compare --dir RUN

The model runs on CUDA (``device: auto`` or ``cuda``) or, with
``--override device=cpu``, on the host.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

from deepfm_tpu_torch.config import ExperimentConfig, load_config
from deepfm_tpu_torch.utils import get_logger, seed_everything

logger = logging.getLogger("deepfm_tpu_torch")


def _build_data(config: ExperimentConfig):
    """Fit the dataset's adapter and pack its splits: (adapter, schema,
    packed, train, val, test)."""
    from deepfm_tpu_torch.data.packing import pack_schema
    from deepfm_tpu_torch.data.synthetic import build_adapter

    adapter = build_adapter(config.data, seed=config.seed)
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


def train_command(config: ExperimentConfig):
    """Train ``config``'s model on its dataset (``Trainer.train``), its log
    lines also in ``output_dir/train.log``; returns the trainer."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    log = get_logger("deepfm_tpu_torch",
                     log_file=f"{config.output_dir}/train.log")
    seed_everything(config.seed)
    log.info("Loading and preparing data...")
    adapter, schema, packed, train_d, val_d, test_d = _build_data(config)
    log.info(f"Data ready: train={len(train_d)}, val={len(val_d)}, "
             f"test={len(test_d)}")
    log.info(f"Schema: {schema.field_names}")
    model = create_model(config.model_name, packed, config,
                         device=config.device)
    trainer = Trainer(
        model, packed, config, train_data=train_d, val_data=val_d,
        test_data=test_d,
        # the adapter drives per-epoch train resampling
        adapter=adapter if hasattr(adapter, "resample_train") else None,
    )
    log.info(f"Device: {trainer.device}")
    log.info(f"Model: {config.model_name} "
             f"({trainer.predictor.n_params:,} parameters)")
    trainer.train()
    return trainer


def evaluate_command(config: ExperimentConfig) -> dict[str, dict]:
    """The best checkpoint's metrics on the val and test splits, logged;
    returns {"val": ..., "test": ...}."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.trainer import Trainer

    log = get_logger("deepfm_tpu_torch")
    seed_everything(config.seed)
    _, _, packed, _, val_d, test_d = _build_data(config)
    model = create_model(config.model_name, packed, config,
                         device=config.device)
    trainer = Trainer(model, packed, config, val_data=val_d,
                      test_data=test_d)
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
):
    """Shared serving prologue: build the fitted data pipeline, the model
    on ``config.device``, load the best checkpoint, and wrap it in a
    ``Predictor``. Returns (adapter, packed, val_d, test_d, model,
    predictor). ``require=(command, *adapter_methods)`` fails fast, before
    the model build, when the dataset's adapter lacks a serving method."""
    from deepfm_tpu_torch.models import create_model
    from deepfm_tpu_torch.training.persistence import load_best
    from deepfm_tpu_torch.training.predict import Predictor

    adapter, schema, packed, train_d, val_d, test_d = _build_data(config)
    if require is not None:
        missing = [m for m in require[1:] if not hasattr(adapter, m)]
        if missing:
            raise SystemExit(
                f"{require[0]}: dataset {config.data.dataset_name!r} has no "
                f"{'/'.join(missing)} path (movielens-format only)"
            )
    model = create_model(config.model_name, packed, config,
                         device=config.device)
    load_best(model, config.output_dir)
    predictor = Predictor(model, packed, config, device=config.device)
    return adapter, packed, val_d, test_d, model, predictor


def serve_command(
    config: ExperimentConfig,
    host: str,
    port: int,
    batch_window_ms: float = 0.0,
    max_rows: int | None = None,
) -> None:
    """Local JSON-over-HTTP scoring server over the best checkpoint:
    GET /health, POST /score, GET /recommend (see serving.py)."""
    from deepfm_tpu_torch.serving import (
        DEFAULT_MAX_ROWS,
        ScoringService,
        make_http_server,
    )

    adapter, packed, _, _, model, predictor = _restore_predictor(
        config,
        require=(
            "serve", "score_id_pairs", "known_pair", "now_timestamp",
            "recommend_candidates",
        ),
    )
    service = ScoringService(
        adapter, packed, predictor, config.model_name,
        max_rows=max_rows if max_rows is not None else DEFAULT_MAX_ROWS,
        batch_window_ms=batch_window_ms,
    )
    logger.info("Warming up (kernel build and first launch)...")
    service.warmup()
    server = make_http_server(service, host, port)
    bound = server.server_address
    logger.info(
        "Serving %s on http://%s:%d  (GET /health, POST /score, "
        "GET /recommend?user=U&k=K)",
        config.model_name, bound[0], bound[1],
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("Shutting down")
    finally:
        server.server_close()


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
        "AttentionDeepFM",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    for name, help_ in [
        ("train", "Train a model"),
        ("evaluate", "Evaluate a saved model"),
        ("serve", "JSON-over-HTTP scoring/retrieval endpoint (serving)"),
    ]:
        p = sub.add_parser(name, help=help_)
        p.add_argument("--config", required=True, help="Path to YAML config")
        p.add_argument(
            "--override", nargs="*", default=[],
            help="Override config values, e.g. training.num_epochs=10",
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

    args = parser.parse_args(argv)
    if args.command == "compare":
        compare_command(args)
        return
    if args.command == "synth-data":
        synth_data_command(args)
        return
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    config = load_config(args.config, args.override or None)
    if args.command == "train":
        train_command(config)
    elif args.command == "evaluate":
        evaluate_command(config)
    else:
        serve_command(
            config, args.host, args.port,
            batch_window_ms=args.batch_window_ms,
            max_rows=args.max_rows,
        )


if __name__ == "__main__":
    main()
