"""GF(2) dense linear algebra for offline code systematization.

The reference systematizes H once at startup with a dense Gaussian
elimination that performs row swaps and *column* swaps, tracking the column
permutation ``tempP`` (``binaryldpccodec.cc:346-492`` classic/forward,
``binary5gldpccodec.cc:240-391`` 5G/reverse).  Both the resulting encoder
table and the column permutation (which re-labels the Tanner graph used for
decoding) depend on the exact pivoting order, so we replicate it faithfully —
but on a bit-packed uint64 representation so the one-time cost is seconds,
not minutes, even for PEG8064 (4032x8064).

This module is NumPy-only; it runs on the host at asset-compile time.
Copy of ``kmldpc_tpu/code/gf2.py``; the port has no native eliminator.
"""

from __future__ import annotations

import numpy as np


def pack_rows(h: np.ndarray) -> np.ndarray:
    """Pack a [R, C] 0/1 uint8 matrix into [R, ceil(C/64)] uint64 words.

    Bit j of the row lives in word j//64 at bit position j%64 (LSB-first).
    """
    r, c = h.shape
    words = (c + 63) // 64
    padded = np.zeros((r, words * 64), dtype=np.uint8)
    padded[:, :c] = h
    bits = padded.reshape(r, words, 8, 8)
    # np.packbits packs MSB-first within each byte; we want LSB-first bit
    # order so that bit j maps to (word j//64, bit j%64).
    packed_bytes = np.packbits(bits, axis=-1, bitorder="little")  # [R, W, 8, 1]
    packed_bytes = packed_bytes.reshape(r, words, 8)
    return packed_bytes.view(np.uint64).reshape(r, words)


def unpack_rows(hp: np.ndarray, num_col: int) -> np.ndarray:
    """Inverse of :func:`pack_rows` -> [R, num_col] uint8."""
    r, words = hp.shape
    as_bytes = hp.view(np.uint8).reshape(r, words * 8)
    bits = np.unpackbits(as_bytes, axis=-1, bitorder="little")
    return bits[:, :num_col].copy()


def get_col(hp: np.ndarray, j: int) -> np.ndarray:
    """Extract bit-column j -> uint8[R]."""
    w, b = j >> 6, np.uint64(j & 63)
    return ((hp[:, w] >> b) & np.uint64(1)).astype(np.uint8)


def set_col(hp: np.ndarray, j: int, bits: np.ndarray) -> None:
    w, b = j >> 6, np.uint64(j & 63)
    mask = ~(np.uint64(1) << b)
    hp[:, w] = (hp[:, w] & mask) | (bits.astype(np.uint64) << b)


def swap_cols(hp: np.ndarray, j1: int, j2: int) -> None:
    if j1 == j2:
        return
    c1 = get_col(hp, j1)
    c2 = get_col(hp, j2)
    set_col(hp, j1, c2)
    set_col(hp, j2, c1)


def _eliminate(hp: np.ndarray, pivot_row: int, pivot_col: int) -> None:
    """XOR pivot row into every other row with a 1 in pivot_col."""
    col = get_col(hp, pivot_col)
    col[pivot_row] = 0
    rows = np.nonzero(col)[0]
    if rows.size:
        hp[rows] ^= hp[pivot_row]


def systematize_forward(h: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Replicates the classic codec's ``SystemMatrixH``.

    Forward elimination with column swaps: for pivot i, scan columns
    jj = i..C-1 for the first with a nonzero in rows i..R-1, take the first
    such row (binaryldpccodec.cc:381-400), swap row/col, eliminate.

    Returns ``(enc_h, perm, rank)`` where ``enc_h`` is the [R, C] eliminated
    matrix ([I | P] in its top-left for a full-rank H), ``perm`` is ``tempP``
    (new column j holds original column ``perm[j]``) and ``rank`` is the
    number of pivots found (the reference's recomputed ``code_chk_``).
    """
    num_row, num_col = h.shape
    hp = pack_rows(h)
    perm = np.arange(num_col, dtype=np.int64)
    rank = 0
    for i in range(num_row):
        # Fast path: pivot column == i (overwhelmingly common).
        col = get_col(hp, i)
        nz = np.nonzero(col[i:])[0]
        if nz.size:
            jj, ii = i, i + int(nz[0])
        else:
            jj = -1
            for j in range(i + 1, num_col):
                col = get_col(hp, j)
                nz = np.nonzero(col[i:])[0]
                if nz.size:
                    jj, ii = j, i + int(nz[0])
                    break
            if jj < 0:
                break
        rank += 1
        if ii != i:
            hp[[i, ii]] = hp[[ii, i]]
        if jj != i:
            perm[[i, jj]] = perm[[jj, i]]
            swap_cols(hp, i, jj)
        _eliminate(hp, i, i)
    return unpack_rows(hp, num_col), perm, rank


def systematize_reverse(h: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Replicates the 5G codec's ``SystemMatrixH`` (reverse order).

    For pivot i = R-1..0 the pivot column position is ``i + C - R``; columns
    are scanned downward from there and rows downward from i
    (binary5gldpccodec.cc:281-300).  Produces [A | I] with the identity in
    the rightmost R columns for a full-rank H, i.e. parity bits at the tail.
    """
    num_row, num_col = h.shape
    off = num_col - num_row
    hp = pack_rows(h)
    perm = np.arange(num_col, dtype=np.int64)
    rank = 0
    for i in range(num_row - 1, -1, -1):
        target = i + off
        col = get_col(hp, target)
        nz = np.nonzero(col[: i + 1])[0]
        if nz.size:
            jj, ii = target, int(nz[-1])
        else:
            jj = -1
            for j in range(target - 1, -1, -1):
                col = get_col(hp, j)
                nz = np.nonzero(col[: i + 1])[0]
                if nz.size:
                    jj, ii = j, int(nz[-1])
                    break
            if jj < 0:
                break
        rank += 1
        if ii != i:
            hp[[i, ii]] = hp[[ii, i]]
        if jj != target:
            perm[[target, jj]] = perm[[jj, target]]
            swap_cols(hp, target, jj)
        _eliminate(hp, i, target)
    return unpack_rows(hp, num_col), perm, rank


def gf2_matvec(mat: np.ndarray, vec: np.ndarray) -> np.ndarray:
    """(mat @ vec) mod 2 for 0/1 arrays; test helper."""
    return (mat.astype(np.int64) @ vec.astype(np.int64)) % 2
