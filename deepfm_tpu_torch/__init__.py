"""deepfm_tpu_torch: the PyTorch/CUDA port of deepfm_tpu.

A package of its own beside the JAX package, which stays the reference.
It imports torch, numpy and pyyaml, never JAX and nothing of
``deepfm_tpu``. This slice serves xDeepFM: config, data pipeline,
embedding engine, DNN, the CIN stack (a hand-written CUDA kernel,
``ops/kernels/cin_stack.py``), best-checkpoint loading, batched scoring,
the HTTP scoring service and the ``serve`` / ``synth-data`` CLI.
Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
