"""deepfm_tpu_torch: the PyTorch/CUDA port of deepfm_tpu.

A package of its own beside the JAX package, which stays the reference.
It imports torch, numpy and pyyaml, never JAX and nothing of
``deepfm_tpu``. It serves xDeepFM (config, data pipeline, embedding
engine, DNN, the CIN stack as a hand-written CUDA kernel, best-checkpoint
loading, batched scoring, the HTTP scoring service and the ``serve`` /
``synth-data`` CLI) and trains DeepFM one step at a time
(``training/trainer.py``), with the table update in hand-written CUDA
kernels (``ops/kernels/{grad,adam,sparse_adam}.py``). Entry points run on
CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
