"""Training: the trainer and its epoch loop (``trainer.py``), the train
step (``steps.py``, ``optim.py``, ``sparse_opt.py``), schedulers, metrics,
engagement telemetry, persistence (best checkpoints, resume, results.json)
and batched prediction."""
