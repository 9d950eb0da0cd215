"""Compile the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface, built for Hopper (``sm_90a``) into ``build/deepfm_tpu_torch/``
at the root of the checkout. The library's file name carries a hash of its
source, of every header in ``csrc/`` (``*.cuh``, which the sources share)
and of the flags, so an edited source or header is rebuilt and a stale
library is never loaded. ``build()`` starts one nvcc per source, all at once.
Importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "deepfm_tpu_torch"
SOURCES = (
    "attention_block.cu",
    "attention_bwd.cu",
    "cin_compress.cu",
    "cin_stack_bwd.cu",
    "cin_stack_bwd_mma.cu",
    "cin_stack_fwd.cu",
    "cin_stack_fwd_mma.cu",
    "densify_rows_grad.cu",
    "densify_rows_grad_packed.cu",
    "fused_table_adam.cu",
    "row_gather.cu",
    "sparse_table_adam.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, per kernel
)
# never --use_fast_math: the table-update kernels round every f32 operation
# as PyTorch's separate elementwise ops do (see csrc/table_update.cuh)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of deepfm_tpu_torch are built at first use and need the "
        "CUDA toolkit"
    )


def library_path(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: tuple[str, ...] = SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, in parallel.

    Returns {source: nvcc's diagnostic output} ("" for a library that was
    already built). Raises RuntimeError naming the source if nvcc fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        target = library_path(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    logs = {src: "" for src in sources}
    failed = []
    for src, (proc, tmp, target) in procs.items():
        logs[src], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(src)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[s] for s in failed)
        )
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build((source,))
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        return lib


def bind(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library of ``source``, with the argtypes of each entry point in
    ``signatures`` set once (every entry point returns a cudaError_t as a
    C int) and ``<stem>_error_string`` bound for ``check``."""
    lib = load(source)
    with _lock:
        if not getattr(lib, "_bound", False):
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            errs = getattr(lib, f"{Path(source).stem}_error_string")
            errs.argtypes = [ctypes.c_int]
            errs.restype = ctypes.c_char_p
            lib._bound = True
    return lib


def check(lib: ctypes.CDLL, source: str, entry: str, err: int) -> None:
    """Raise RuntimeError if a launch through ``entry`` returned an error."""
    if err != 0:
        msg = getattr(lib, f"{Path(source).stem}_error_string")(err).decode()
        raise RuntimeError(f"{entry} launch failed: {msg}")


def sm_count(t) -> int:
    """The number of SMs of ``t``'s device."""
    import torch

    return torch.cuda.get_device_properties(t.device).multi_processor_count


def launch_device(t):
    """The device context of a launch on ``t``'s device (``t`` a tensor or a
    CUDA device), after a guard: that device must be the current one. A
    process drives one card (a rank sets its own with
    ``torch.cuda.set_device`` before it launches anything), so a kernel's
    tensors on another card are a placement fault, which raises here
    rather than launching on the wrong card or stream."""
    import torch

    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    check_current(dev.index)
    return torch.cuda.device(dev)


def check_current(index: int) -> None:
    """Raise RuntimeError unless ``cuda:index`` is the current device."""
    import torch

    current = torch.cuda.current_device()
    if index != current:
        raise RuntimeError(
            f"a kernel's tensors are on cuda:{index}, but this process's "
            f"current device is cuda:{current} (torch.cuda.set_device)")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a C pointer, read
    without building a ``torch.cuda.Stream`` object (the call PyTorch's own
    generated kernels use)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
