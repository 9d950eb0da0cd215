"""Training: the DeepFM train step (``trainer.py``, ``steps.py``,
``optim.py``, ``sparse_opt.py``), best-checkpoint persistence and batched
prediction. The epoch loop, eval and resume come with a later slice."""
