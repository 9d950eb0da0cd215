"""CLI of the port: ``serve`` and ``synth-data``.

Port of the matching parts of ``deepfm_tpu/cli.py``: the ``serve``
command with its ``_build_data`` / ``_restore_predictor`` prologue, and
``synth-data``. The other subcommands (train, evaluate, predict, export,
recommend, compare, pack-data, synth-packed) come with later slices.

    python -m deepfm_tpu_torch serve --config configs/xdeepfm_movielens_cin_tuned.yaml \\
        --override data.data_dir=DIR output_dir=RUN

The model runs on CUDA (``device: auto`` or ``cuda``) or, with
``--override device=cpu``, on the host.
"""

from __future__ import annotations

import argparse
import logging

from deepfm_tpu_torch.config import ExperimentConfig, load_config

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
        description="CTR prediction on PyTorch/CUDA: xDeepFM serving",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "serve", help="JSON-over-HTTP scoring/retrieval endpoint (serving)"
    )
    p.add_argument("--config", required=True, help="Path to YAML config")
    p.add_argument(
        "--override", nargs="*", default=[],
        help="Override config values, e.g. data.data_dir=/path",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument(
        "--batch-window-ms", type=float, default=0.0,
        help="coalesce concurrent /score requests arriving within this "
        "window into one device dispatch (0=off)",
    )
    p.add_argument(
        "--max-rows", type=int, default=None,
        help="max rows per /score request (default 16384)",
    )

    sd = sub.add_parser(
        "synth-data", help="Generate an ML-100K-format synthetic dataset"
    )
    sd.add_argument("--dir", default="data/ml-100k-synth")
    sd.add_argument("--users", type=int, default=300)
    sd.add_argument("--items", type=int, default=400)
    sd.add_argument("--rows", type=int, default=20000)
    sd.add_argument("--seed", type=int, default=0)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    if args.command == "synth-data":
        synth_data_command(args)
        return
    config = load_config(args.config, args.override or None)
    serve_command(
        config, args.host, args.port,
        batch_window_ms=args.batch_window_ms,
        max_rows=args.max_rows,
    )


if __name__ == "__main__":
    main()
