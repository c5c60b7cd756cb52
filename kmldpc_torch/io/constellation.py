"""Parser for constellation table files.

Format (see ``assets/2bits_QPSK.txt`` and the reference loader
``modem.cc:87-129``): three ``label value`` pairs give bits/symbol and
symbols-per-point, then one row per constellation point:

    decimal  b_0 ... b_{m-1}  real  imag

The loader performs the same self-check as the reference (decimal index must
equal both the binary expression and the row order, ``modem.cc:106-118``) and
the same unit-average-energy normalization (``modem.cc:125-128``).  Copy of
``kmldpc_tpu/io/constellation.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Constellation:
    bits_per_symbol: int  # reference: input_len_
    points: np.ndarray  # [M] complex128, unit average energy
    bits: np.ndarray  # [M, m] int8; bits[k] is the MSB-first label of point k

    @property
    def num_points(self) -> int:
        return int(self.points.shape[0])

    def bit0_mask(self) -> np.ndarray:
        """[M, m] float mask: 1 where bit j of symbol k is 0.

        Used by the demapper's bit marginalization (modem.cc:60-70).
        """
        return (self.bits == 0).astype(np.float64)


def parse_constellation(path: str) -> Constellation:
    with open(path) as f:
        tokens = f.read().split()

    numeric = [t for t in tokens if _is_number(t)]
    cursor = 0

    def nxt() -> str:
        nonlocal cursor
        v = numeric[cursor]
        cursor += 1
        return v

    bits_per_symbol = int(nxt())
    _symbols_per_point = int(nxt())  # always 2 (real, imag) in shipped assets
    num_points = 1 << bits_per_symbol
    points = np.zeros(num_points, dtype=np.complex128)
    bits = np.zeros((num_points, bits_per_symbol), dtype=np.int8)
    for i in range(num_points):
        dec = int(nxt())
        label = 0
        for j in range(bits_per_symbol):
            b = int(nxt())
            bits[i, j] = b
            label = (label << 1) + b
        if dec != label or dec != i:
            raise ValueError(
                f"{path}: row {i}: decimal {dec} != binary expression {label}"
            )
        real = float(nxt())
        imag = float(nxt())
        points[i] = complex(real, imag)

    # Unit-average-energy normalization (modem.cc:125-128).
    energy = float(np.mean(np.abs(points) ** 2))
    points = points / np.sqrt(energy)
    return Constellation(bits_per_symbol=bits_per_symbol, points=points, bits=bits)


def _is_number(token: str) -> bool:
    try:
        float(token)
        return True
    except ValueError:
        return False
