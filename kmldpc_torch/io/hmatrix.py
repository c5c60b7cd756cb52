"""Parser for the sparse parity-check-matrix text format.

Format (see ``assets/PEG2304regular0.5.txt`` and the reference
loader ``binaryldpccodec.cc:81-124`` / ``binary5gldpccodec.cc:28-75``):

    line 1: header string (ignored)
    line 2: num_row num_col rank [lifting_factor]      (lifting only for 5G)
    line 3: header string (ignored)
    then per row:  row_no  degree  col_0 col_1 ... col_{degree-1}

The reference parses with ``fscanf`` so tokens may be split across lines
arbitrarily; we therefore tokenize the whole file.  Copy of
``kmldpc_tpu/io/hmatrix.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParityCheckMatrix:
    """A sparse H in coordinate form, row-major by parse order."""

    num_row: int
    num_col: int
    rank: int  # third header field; reference reads it into code_chk_
    lifting_factor: int | None  # present only for 5G files
    row_idx: np.ndarray  # [E] int32, row of each edge (nondecreasing)
    col_idx: np.ndarray  # [E] int32, column of each edge

    @property
    def num_edges(self) -> int:
        return int(self.row_idx.shape[0])

    def to_dense(self) -> np.ndarray:
        h = np.zeros((self.num_row, self.num_col), dtype=np.uint8)
        h[self.row_idx, self.col_idx] = 1
        return h

    def row_degrees(self) -> np.ndarray:
        return np.bincount(self.row_idx, minlength=self.num_row).astype(np.int32)

    def col_degrees(self) -> np.ndarray:
        return np.bincount(self.col_idx, minlength=self.num_col).astype(np.int32)


def parse_hmatrix(path: str) -> ParityCheckMatrix:
    with open(path) as f:
        text = f.read()
    tokens = text.split()
    # First token is the header word; following ints are the size line.  The
    # 5G format has 4 ints before the next header word, classic has 3.
    pos = 1  # skip header token
    ints: list[int] = []
    while pos < len(tokens) and len(ints) < 4:
        tok = tokens[pos]
        try:
            ints.append(int(tok))
            pos += 1
        except ValueError:
            break
    if len(ints) < 3:
        raise ValueError(f"{path}: malformed header line: {ints}")
    num_row, num_col, rank = ints[0], ints[1], ints[2]
    lifting = ints[3] if len(ints) == 4 else None
    # Skip the second header token ("no_of_row--degree_of_row--no_of_col").
    if pos < len(tokens) and not _is_int(tokens[pos]):
        pos += 1
    body = np.array([int(t) for t in tokens[pos:]], dtype=np.int64)

    rows: list[np.ndarray] = []
    cols: list[np.ndarray] = []
    cursor = 0
    for r in range(num_row):
        if cursor + 2 > body.shape[0]:
            raise ValueError(
                f"{path}: truncated at row {r}/{num_row} (missing row header)"
            )
        row_no = int(body[cursor])
        degree = int(body[cursor + 1])
        cursor += 2
        if cursor + degree > body.shape[0]:
            raise ValueError(
                f"{path}: truncated at row {r}/{num_row} "
                f"(expected {degree} column indices)"
            )
        cs = body[cursor : cursor + degree]
        cursor += degree
        rows.append(np.full(degree, row_no, dtype=np.int32))
        cols.append(cs.astype(np.int32))
    row_idx = np.concatenate(rows)
    col_idx = np.concatenate(cols)
    if row_idx.max() >= num_row or col_idx.max() >= num_col:
        raise ValueError(f"{path}: edge indices out of bounds")
    return ParityCheckMatrix(
        num_row=num_row,
        num_col=num_col,
        rank=rank,
        lifting_factor=lifting,
        row_idx=row_idx,
        col_idx=col_idx,
    )


def _is_int(token: str) -> bool:
    try:
        int(token)
        return True
    except ValueError:
        return False
