"""Plain LDPC code and constellation tables, worked out from the raw asset
files (NumPy only).

The parity-check file is systematised by dense GF(2) elimination with the
pivot order of the C++ simulator the project follows (classic codes:
forward, pivot column i then the first later column with a one in rows
i.., first such row; 5G codes: reverse, pivot position i + C - R, columns
scanned downward, last row with a one).  Its column permutation is the
code's bit order: the decode graph is H with columns permuted, a classic
codeword is ``[parity | info]``, a 5G one ``[info | parity]`` with its first
2Z columns punctured.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Code:
    num_row: int
    num_col: int
    info_bits: int  # K
    punct: int  # leading punctured columns (2Z for 5G, else 0)
    lifting: int  # Z, 0 for classic codes
    is_5g: bool
    parity_gen: np.ndarray  # [chk, K] uint8: parity = parity_gen @ info mod 2
    row_cols: np.ndarray  # [num_row, dr_max] int64 column of each row slot, num_col = pad
    row_mask: np.ndarray  # [num_row, dr_max] bool
    col_slots: np.ndarray  # [num_col, dc_max] int64 flat row slot of each column edge, pad = R*dr

    @property
    def tx_len(self) -> int:
        return self.num_col - self.punct

    @property
    def info_start(self) -> int:
        return 0 if self.is_5g else self.num_col - self.info_bits

    @property
    def num_edges(self) -> int:
        return int(self.row_mask.sum())


@dataclasses.dataclass(frozen=True)
class Constellation:
    bits_per_symbol: int
    points: np.ndarray  # [M] complex128, unit mean energy
    bits: np.ndarray  # [M, m] uint8, MSB first


def parse_hmatrix(path: str):
    """(num_row, num_col, lifting or 0, rows, cols) of a parity-check file:
    a header word, ``R C rank [Z]``, a header word, then per row
    ``row degree col...``."""
    tokens = open(path).read().split()
    ints, pos = [], 1
    while len(ints) < 4 and tokens[pos].lstrip("-").isdigit():
        ints.append(int(tokens[pos]))
        pos += 1
    num_row, num_col = ints[0], ints[1]
    lifting = ints[3] if len(ints) == 4 else 0
    if not tokens[pos].lstrip("-").isdigit():
        pos += 1
    body = [int(t) for t in tokens[pos:]]
    rows, cols, at = [], [], 0
    for _ in range(num_row):
        r, d = body[at], body[at + 1]
        rows += [r] * d
        cols += body[at + 2 : at + 2 + d]
        at += 2 + d
    return num_row, num_col, lifting, np.array(rows), np.array(cols)


def _col(hp: np.ndarray, j: int) -> np.ndarray:
    return (hp[:, j >> 3] >> (j & 7)) & 1


def _put_col(hp: np.ndarray, j: int, bits: np.ndarray) -> None:
    mask = np.uint8(~(1 << (j & 7)) & 0xFF)
    hp[:, j >> 3] = (hp[:, j >> 3] & mask) | (bits.astype(np.uint8) << (j & 7))


def systematize(h: np.ndarray, reverse: bool) -> tuple[np.ndarray, np.ndarray, int]:
    """(eliminated H, column permutation, rank) by the pivot order above."""
    num_row, num_col = h.shape
    hp = np.packbits(h.astype(np.uint8), axis=1, bitorder="little")
    perm = np.arange(num_col)
    rank = 0
    order = range(num_row - 1, -1, -1) if reverse else range(num_row)
    for i in order:
        target = i + num_col - num_row if reverse else i
        cols = range(target, -1, -1) if reverse else range(target, num_col)
        found = None
        for j in cols:
            col = _col(hp, j)
            nz = np.nonzero(col[: i + 1] if reverse else col[i:])[0]
            if nz.size:
                found = (j, int(nz[-1]) if reverse else i + int(nz[0]))
                break
        if found is None:
            break
        j, row = found
        rank += 1
        if row != i:
            hp[[i, row]] = hp[[row, i]]
        if j != target:
            perm[[target, j]] = perm[[j, target]]
            a, b = _col(hp, target), _col(hp, j)
            _put_col(hp, target, b)
            _put_col(hp, j, a)
        col = _col(hp, target)
        col[i] = 0
        hp[np.nonzero(col)[0]] ^= hp[i]
    return np.unpackbits(hp, axis=1, count=num_col, bitorder="little"), perm, rank


def load_code(path: str) -> Code:
    num_row, num_col, lifting, rows, cols = parse_hmatrix(path)
    h = np.zeros((num_row, num_col), dtype=np.uint8)
    h[rows, cols] = 1
    is_5g = lifting > 0
    enc, perm, rank = systematize(h, reverse=is_5g)
    k = num_col - rank
    parity_gen = enc[:rank, :k] if is_5g else enc[:rank, rank:]
    dec = h[:, perm]  # decode graph: column j is original column perm[j]
    deg_r = dec.sum(axis=1)
    dr = int(deg_r.max())
    row_cols = np.full((num_row, dr), num_col, dtype=np.int64)
    row_mask = np.zeros((num_row, dr), dtype=bool)
    for r in range(num_row):
        c = np.nonzero(dec[r])[0]  # ascending column order
        row_cols[r, : c.size] = c
        row_mask[r, : c.size] = True
    dc = int(dec.sum(axis=0).max())
    col_slots = np.full((num_col, dc), num_row * dr, dtype=np.int64)
    fill = np.zeros(num_col, dtype=np.int64)
    for flat in np.nonzero(row_mask.reshape(-1))[0]:
        c = row_cols.reshape(-1)[flat]
        col_slots[c, fill[c]] = flat
        fill[c] += 1
    return Code(num_row, num_col, k, 2 * lifting if is_5g else 0, lifting, is_5g,
                parity_gen.astype(np.uint8), row_cols, row_mask, col_slots)


def load_constellation(path: str) -> Constellation:
    """``m``, the symbols per point, then per point ``index bits... re im``;
    scaled to unit mean energy."""
    nums = []
    for t in open(path).read().split():
        try:
            nums.append(float(t))
        except ValueError:
            pass
    m = int(nums[0])
    rows = np.array(nums[2 : 2 + (1 << m) * (m + 3)]).reshape(1 << m, m + 3)
    if not (rows[:, 0] == np.arange(1 << m)).all():
        raise ValueError(f"{path}: points out of order")
    points = rows[:, m + 1] + 1j * rows[:, m + 2]
    points = points / np.sqrt(np.mean(np.abs(points) ** 2))
    return Constellation(m, points, rows[:, 1 : m + 1].astype(np.uint8))
