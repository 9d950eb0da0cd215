"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each kernel lives in ``deepfm_tpu_torch/csrc/`` and is compiled by
``build.py`` at first use (nvcc, sm_90a, plain C interface, ctypes). Each
wrapper dispatches on its input's device: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in a ``launches`` attribute.
"""
