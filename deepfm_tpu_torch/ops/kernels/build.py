"""Compile the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file becomes one shared library with a plain C
interface, built for Hopper (``sm_90a``) into ``build/deepfm_tpu_torch/``
at the root of the checkout. The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is
never loaded. ``build()`` starts one nvcc per source, all at once.
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
SOURCES = ("cin_stack_fwd.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, per kernel
)

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
    text = (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
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
