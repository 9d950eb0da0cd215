"""deepfm_tpu_torch: the PyTorch/CUDA port of deepfm_tpu.

A package of its own beside the JAX package, which stays the reference.
It imports torch, numpy and pyyaml, never JAX and nothing of
``deepfm_tpu``. It trains DeepFM, xDeepFM and AttentionDeepFM
(``training/trainer.py``: the step, the epoch loop, evaluation, resume and
results.json) and serves xDeepFM and AttentionDeepFM, through the
``train``, ``evaluate``, ``compare``, ``serve`` and ``synth-data``
commands, with every TPU kernel of the JAX package rewritten by hand in
CUDA (``csrc/``, bound by ``ops/kernels/``). Entry points run on CUDA
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
