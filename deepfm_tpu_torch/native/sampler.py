"""ctypes bindings of the native C++ negative sampler.

The port's own copy of ``deepfm_tpu/native/sampler.py``, over its own copy
of the source (``sampler.cc``: Walker alias tables for the
popularity-weighted draws, a byte matrix for the "unseen" test, one
splitmix64 stream a call). The same two entry points with the same
signatures, so a seed draws the same arrays as the JAX package's library.

The library is built at first use with the JAX package's g++ flags
(``-O3 -march=native -shared -fPIC -std=c++17``) into
``build/deepfm_tpu_torch/`` at the root of the checkout, under a file name
that hashes the source and the flags (so an edited source is rebuilt and a
stale library never loaded), through a temporary file renamed into place,
under a lock. A library that cannot be built raises: there is no numpy
fallback here (``data.use_native_sampler: false`` is the numpy path, a
config choice). Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sampler.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deepfm_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
COMPILER = "g++"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_I64 = ctypes.c_longlong
_P_I64 = ctypes.POINTER(ctypes.c_longlong)
_P_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"sampler-{digest}.so"


def build() -> Path:
    """Compile the library if it is missing; returns its path. Raises
    RuntimeError when there is no compiler or the compiler fails."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which(COMPILER)
    if cxx is None:
        raise RuntimeError(
            f"{COMPILER} not found on PATH: the native negative sampler "
            "(data.use_native_sampler: true, the default) is built at first "
            "use; set data.use_native_sampler=false for the numpy sampler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{COMPILER} failed to build the native negative sampler "
            f"({SOURCE}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a file
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.weighted_unseen_batch.restype = _I64
            lib.weighted_unseen_batch.argtypes = [
                _P_U8,  # seen (U*M row-major)
                _I64,  # n_items
                ctypes.POINTER(ctypes.c_double),  # weights (M,)
                _P_I64,  # uids (K,)
                _I64,  # n_uids
                _I64,  # num_neg
                ctypes.c_ulonglong,  # seed
                _P_I64,  # out items (K*num_neg,)
                _P_I64,  # out per-uid counts (K,)
            ]
            lib.uniform_unseen_batch.restype = _I64
            lib.uniform_unseen_batch.argtypes = [
                _P_U8, _I64, _P_I64, _I64, _I64, ctypes.c_ulonglong, _P_I64,
            ]
            _lib = lib
        return _lib


def weighted_unseen_batch(
    seen: np.ndarray,
    weights: np.ndarray,
    uids: np.ndarray,
    num_neg: int,
    seed: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-uid popularity-weighted with-replacement sampling of unseen items.

    Returns (flat_items, per_uid_counts); counts < num_neg only when a user
    has fewer unseen items than num_neg.
    """
    lib = _load()
    seen_u8 = np.ascontiguousarray(seen, dtype=np.uint8)
    w = np.ascontiguousarray(weights, dtype=np.float64)
    u = np.ascontiguousarray(uids, dtype=np.int64)
    k = len(u)
    out = np.empty(k * num_neg, dtype=np.int64)
    counts = np.empty(k, dtype=np.int64)
    total = lib.weighted_unseen_batch(
        seen_u8.ctypes.data_as(_P_U8),
        seen.shape[1],
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        u.ctypes.data_as(_P_I64),
        k,
        num_neg,
        np.uint64(seed % (2**64)),
        out.ctypes.data_as(_P_I64),
        counts.ctypes.data_as(_P_I64),
    )
    return out[:total].copy(), counts


def uniform_unseen_batch(
    seen: np.ndarray, uids: np.ndarray, num_neg: int, seed: int
) -> np.ndarray:
    """(K, num_neg) uniform unseen items, without replacement per row."""
    lib = _load()
    seen_u8 = np.ascontiguousarray(seen, dtype=np.uint8)
    u = np.ascontiguousarray(uids, dtype=np.int64)
    k = len(u)
    out = np.empty(k * num_neg, dtype=np.int64)
    lib.uniform_unseen_batch(
        seen_u8.ctypes.data_as(_P_U8),
        seen.shape[1],
        u.ctypes.data_as(_P_I64),
        k,
        num_neg,
        np.uint64(seed % (2**64)),
        out.ctypes.data_as(_P_I64),
    )
    return out.reshape(k, num_neg)
