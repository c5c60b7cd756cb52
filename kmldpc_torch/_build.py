"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kmldpc_torch/libkmldpc_torch-<hash>.so csrc/*.cu

The build runs at first use, keyed by a hash of the sources and flags, into
``build/kmldpc_torch/`` beside the package (ignored by git).  Importing the
package never needs ``nvcc``; a missing ``nvcc`` or a failed build raises
when a CUDA path first asks for the library.  No fast-math flags: the
kernels rely on IEEE division and math functions, and on the float rounding
they spell out.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kmldpc_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = pathlib.Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of kmldpc_torch cannot be built"
        )
    return nvcc


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkmldpc_torch-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for them exists; return it."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kmldpc_kmeans.argtypes = [p, p, p, p, i, i, p, p, i, i, i, i, i, p, p]
    lib.kmldpc_kmeans.restype = ctypes.c_int
    lib.kmldpc_kmeans_rows_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.kmldpc_kmeans_rows_per_sm.restype = ctypes.c_int
    f = ctypes.c_float
    lib.kmldpc_bp_flood.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, f, p]
    lib.kmldpc_bp_flood.restype = ctypes.c_int
    lib.kmldpc_bp_flood_words_per_sm.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.kmldpc_bp_flood_words_per_sm.restype = ctypes.c_int
    ip = ctypes.POINTER(i)  # a host array of class degrees or node counts
    lib.kmldpc_bp_flood_classes.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                            ip, ip, i, ip, ip, i, i, f, f, f, p]
    lib.kmldpc_bp_flood_classes.restype = ctypes.c_int
    lib.kmldpc_bp_flood_classes_words_per_sm.argtypes = [i, i, ip, ip, i, ip, ip, i, ip, ip]
    lib.kmldpc_bp_flood_classes_words_per_sm.restype = ctypes.c_int
    return lib
