"""Record export: the reference's optional ``.mat`` writer.

The reference wraps matio to dump scalars/vectors for MATLAB inspection
(``lab::Mat``, mat.h:14-37 / mat.cc:4-197, compiled under ``USE_MATIO``),
and ``KMeans::DumpToMat`` (kmeans.cc:96-111) writes the blind-detection
state (received symbols, clusters, assignments, constellation, ĥ candidates,
true h) per block.

Here: scipy's ``savemat`` when available (MATLAB v5 files, like matio),
falling back to ``.npz`` — same variable names either way.  Copy of
``kmldpc_tpu/utils/records.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import numpy as np


class RecordWriter:
    """Accumulates named arrays/scalars, then writes one file.

    Mirrors the Mat::Open/Write*/Close flow; complex data is kept complex
    (matio wrote split real/imag pairs, savemat handles complex natively).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._data: dict[str, np.ndarray] = {}

    def write_int(self, name: str, value: int) -> None:
        self._data[name] = np.asarray(value, dtype=np.int64)

    def write_double(self, name: str, value: float) -> None:
        self._data[name] = np.asarray(value, dtype=np.float64)

    def write_complex(self, name: str, value: complex) -> None:
        self._data[name] = np.asarray(value, dtype=np.complex128)

    def write_vector(self, name: str, value) -> None:
        self._data[name] = np.asarray(value)

    def close(self) -> str:
        """Write the file; returns the actual path used (.mat or .npz)."""
        try:
            from scipy.io import savemat  # noqa: PLC0415

            path = self.path if self.path.endswith(".mat") else self.path + ".mat"
            savemat(path, self._data)
            return path
        except ImportError:
            path = self.path.removesuffix(".mat") + ".npz"
            np.savez(path, **self._data)
            return path


def dump_kmeans(
    path: str,
    data: np.ndarray,
    clusters: np.ndarray,
    idx: np.ndarray,
    constellations: np.ndarray,
    h_hats: np.ndarray,
    real_h: complex,
) -> str:
    """KMeans::DumpToMat parity: same variable names (kmeans.cc:99-107)."""
    w = RecordWriter(path)
    w.write_vector("data", np.asarray(data, dtype=np.complex128))
    w.write_vector("cluster", np.asarray(clusters, dtype=np.complex128))
    w.write_vector("idx", np.asarray(idx, dtype=np.int64))
    w.write_vector("constellations", np.asarray(constellations, dtype=np.complex128))
    w.write_vector("hHats", np.asarray(h_hats, dtype=np.complex128)[:4])
    w.write_complex("realH", real_h)
    return w.close()
