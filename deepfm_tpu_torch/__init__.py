"""deepfm_tpu_torch: the PyTorch/CUDA port of deepfm_tpu.

A package of its own beside the JAX package, which stays the reference.
It imports torch, numpy and pyyaml, never JAX and nothing of
``deepfm_tpu``. It trains DeepFM, xDeepFM, AttentionDeepFM, the LR /
FM / DNN baselines and a model of its own, AutoInt (``models/autoint.py``;
``training/trainer.py``: the step, with Adam or lazy_adam, the epoch loop,
evaluation, resume and results.json), from
MovieLens, synthetic or on-disk packed data, and scores and serves them,
through the ``train``, ``evaluate``, ``compare``, ``predict``,
``recommend``, ``serve``, ``pack-data``, ``synth-data`` and
``synth-packed`` commands, with every TPU kernel of the JAX package
rewritten by hand in CUDA (``csrc/``, bound by ``ops/kernels/``) and its
native negative sampler (``native/``). Entry points run on CUDA unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
