"""ctypes wrapper for the native GF(2) eliminator (``gf2_eliminate.cc``).

Copy of ``kmldpc_tpu/native/gf2_native.py`` kept by the port, with two
differences:

* the build is safe under concurrency: the library is named by a hash of
  its source, the compiler flags and the host, and is compiled into a temp
  file of its own in the code cache directory (``code/ldpc.py::_cache_dir``)
  before an atomic rename, so any number of processes building into a cold
  directory all succeed;
* a failed build or load is not silent: the first caller gets the reason
  (the compiler's stderr, trimmed) as a ``RuntimeWarning``, and
  :func:`available` says which route the caller takes.

Importing this module runs no compiler; the first :func:`available` or
:func:`systematize` call builds the library, once per process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import warnings

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gf2_eliminate.cc")
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failure: str | None = None


def library_path() -> str:
    """Where the library for the current source lives once built.

    ``-march=native`` code runs only on CPUs like the compiling host's, and an
    illegal instruction kills the process before any fallback can act, so
    the name carries the host's name too: a cache directory shared between
    machines of different names never hands one another's library.
    """
    from ..code.ldpc import _cache_dir  # noqa: PLC0415 (code/ldpc.py imports this module)

    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, platform.node())).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_cache_dir(), f"libgf2_eliminate-{h.hexdigest()[:16]}.so")


def _build() -> str:
    """Compile the source unless its library exists; return the library."""
    out = library_path()
    if os.path.exists(out):
        return out
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} exited {proc.returncode}: {proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> ctypes.CDLL:
    """Build if needed and load once per process; raise if that failed."""
    global _lib, _failure
    with _lock:
        if _lib is None and _failure is None:
            try:
                lib = ctypes.CDLL(_build())
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _failure = str(e)
                warnings.warn(
                    f"native GF(2) eliminator unavailable, codes are systematised "
                    f"with NumPy (same tables, slower): {_failure}",
                    RuntimeWarning, stacklevel=3)
            else:
                lib.gf2_systematize.restype = ctypes.c_int
                lib.gf2_systematize.argtypes = [
                    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                ]
                _lib = lib
        if _lib is None:
            raise RuntimeError(f"native GF(2) eliminator unavailable: {_failure}")
        return _lib


def available() -> bool:
    """Whether the native eliminator runs in this process (builds it on first call)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def systematize(h: np.ndarray, reverse: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """Drop-in for gf2.systematize_{forward,reverse}: (enc_h, perm, rank)."""
    lib = _load()
    h = np.ascontiguousarray(h, dtype=np.uint8)
    if h.ndim != 2:
        raise ValueError(f"expected a 2-D parity-check matrix, got shape {h.shape}")
    rows, cols = h.shape
    enc = np.empty((rows, cols), dtype=np.uint8)
    perm = np.empty(cols, dtype=np.int64)
    rank = lib.gf2_systematize(
        h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rows, cols, int(reverse),
        enc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rank < 0:
        raise RuntimeError("gf2_systematize failed")
    return enc, perm, rank
