"""LDPC code compilation: parity-check file -> static index tables.

Copy of ``kmldpc_tpu/code/ldpc.py`` kept by the port so that it imports
nothing of the JAX package; ``tests/test_torch_host.py`` holds the two equal.
It systematises with the port's native eliminator (``native/gf2_native.py``,
built with g++ at first use) and falls back, with a warning, to the NumPy
elimination of ``gf2.py``, which gives the same tables; it caches compiled
codes in its own directory (``.cache/kmldpc_torch/``).

The reference builds, per process, a pointer-linked Tanner graph plus a dense
systematized encoder matrix (``binaryldpccodec.cc:62-141,346-492``).  Here the
whole thing is compiled *offline* (NumPy on host, cached to disk) into static
padded index arrays that the batched decoder consumes:

* ``parity_gen`` — dense GF(2) generator for the parity bits; the runtime
  encoder is one matmul.
* column-sorted edge list + padded per-column / per-row gather tables with
  masks — the flooding BP decoder's entire addressing scheme; no pointer
  chasing, no scatters (everything is gathers + reductions).
* the 5G puncturing map (first ``2*Z`` columns carry no channel observation,
  codeword is transmitted from offset ``2*Z``; ``binary5gldpccodec.cc:86-109,
  126-132``).

Codeword conventions (in the *permuted* column domain produced by the
Gaussian elimination — identical to the reference):

* classic:  cc = [parity | info],  info bits are cols [chk, N);  uu_hat is
  the tail (binaryldpccodec.cc:144-162,214-216).
* 5G:       cc_full = [info | parity], uu_hat is the head, transmitted
  codeword is cc_full[2Z:] (binary5gldpccodec.cc:86-109,167-170).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

import numpy as np

from ..io.hmatrix import ParityCheckMatrix, parse_hmatrix
from ..native import gf2_native
from . import gf2

_CACHE_VERSION = 3


@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """All static tables for one LDPC code. NumPy arrays, host-resident."""

    name: str
    is_5g: bool
    num_row: int
    num_col: int  # N (classic) / N_no_puncture (5G)
    code_dim: int  # K
    code_chk: int  # N - K (recomputed rank, as in the reference)
    lifting_factor: int  # Z; 0 for classic codes
    # --- encoder ---
    # [code_chk, code_dim] uint8. classic: parity = parity_gen @ uu (mod 2),
    # cc = [parity | uu]. 5G: cc_full = [uu | parity_gen @ uu].
    parity_gen: np.ndarray
    # --- decoder graph (column-sorted edge order) ---
    edge_col: np.ndarray  # [E] int32 — column of edge e
    edge_row: np.ndarray  # [E] int32 — row of edge e
    col_edge_idx: np.ndarray  # [num_col, dc_max] int32, E = pad
    col_mask: np.ndarray  # [num_col, dc_max] bool
    row_edge_idx: np.ndarray  # [num_row, dr_max] int32, E = pad
    row_mask: np.ndarray  # [num_row, dr_max] bool
    edge_rowslot: np.ndarray  # [E] int32 — flat (row * dr_max + slot) of edge e
    row_edge_col: np.ndarray  # [num_row, dr_max] int32 — column of that slot, num_col = pad

    @property
    def num_edges(self) -> int:
        return int(self.edge_col.shape[0])

    @property
    def dc_max(self) -> int:
        return int(self.col_edge_idx.shape[1])

    @property
    def dr_max(self) -> int:
        return int(self.row_edge_idx.shape[1])

    @property
    def punct(self) -> int:
        """Number of leading punctured columns (5G: 2Z; classic: 0)."""
        return 2 * self.lifting_factor if self.is_5g else 0

    @property
    def tx_len(self) -> int:
        """Transmitted codeword length (5G: code_len_puncture_)."""
        return self.num_col - self.punct

    @property
    def rate(self) -> float:
        return self.code_dim / self.tx_len

    @property
    def info_slice(self) -> slice:
        """Position of the info bits inside the full codeword."""
        if self.is_5g:
            return slice(0, self.code_dim)
        return slice(self.code_chk, self.num_col)

    def dense_h(self) -> np.ndarray:
        """The (permuted) decoding H as dense uint8 — test helper."""
        h = np.zeros((self.num_row, self.num_col), dtype=np.uint8)
        h[self.edge_row, self.edge_col] = 1
        return h

    def encode_reference(self, uu: np.ndarray) -> np.ndarray:
        """NumPy oracle encoder for a single info word -> full codeword."""
        parity = gf2.gf2_matvec(self.parity_gen, uu).astype(np.uint8)
        if self.is_5g:
            return np.concatenate([uu.astype(np.uint8), parity])
        return np.concatenate([parity, uu.astype(np.uint8)])


def _build_adjacency(
    edge_row: np.ndarray, edge_col: np.ndarray, num_row: int, num_col: int
) -> dict[str, np.ndarray]:
    e = edge_row.shape[0]
    order = np.lexsort((edge_row, edge_col))  # sort by col, then row
    edge_col = edge_col[order]
    edge_row = edge_row[order]

    col_deg = np.bincount(edge_col, minlength=num_col)
    row_deg = np.bincount(edge_row, minlength=num_row)
    dc_max = int(col_deg.max())
    dr_max = int(row_deg.max())

    col_edge_idx = np.full((num_col, dc_max), e, dtype=np.int32)
    col_mask = np.zeros((num_col, dc_max), dtype=bool)
    slot = np.zeros(num_col, dtype=np.int64)
    for idx in range(e):
        c = edge_col[idx]
        col_edge_idx[c, slot[c]] = idx
        col_mask[c, slot[c]] = True
        slot[c] += 1

    row_edge_idx = np.full((num_row, dr_max), e, dtype=np.int32)
    row_mask = np.zeros((num_row, dr_max), dtype=bool)
    row_edge_col = np.full((num_row, dr_max), num_col, dtype=np.int32)
    edge_rowslot = np.zeros(e, dtype=np.int32)
    slot = np.zeros(num_row, dtype=np.int64)
    for idx in range(e):
        r = edge_row[idx]
        s = slot[r]
        row_edge_idx[r, s] = idx
        row_mask[r, s] = True
        row_edge_col[r, s] = edge_col[idx]
        edge_rowslot[idx] = r * dr_max + s
        slot[r] += 1

    return dict(
        edge_col=edge_col.astype(np.int32),
        edge_row=edge_row.astype(np.int32),
        col_edge_idx=col_edge_idx,
        col_mask=col_mask,
        row_edge_idx=row_edge_idx,
        row_mask=row_mask,
        edge_rowslot=edge_rowslot,
        row_edge_col=row_edge_col,
    )


def compile_code(
    hmat: ParityCheckMatrix, name: str = "", encoder_active: bool = True
) -> LDPCCode:
    """Systematize + build all static tables for one parity-check matrix."""
    is_5g = hmat.lifting_factor is not None
    h_dense = hmat.to_dense()
    enc_h, perm, rank = _native_or_numpy_systematize(h_dense, reverse=is_5g)
    num_row, num_col = hmat.num_row, hmat.num_col
    code_chk = rank
    code_dim = num_col - code_chk

    if is_5g:
        # enc_h = [A | I]; parity_t = A[t, :code_dim] . uu
        # (binary5gldpccodec.cc:97-102).
        parity_gen = enc_h[:code_chk, :code_dim].copy()
    else:
        # enc_h = [I | P]; parity_t = P[t] . uu over info cols
        # (binaryldpccodec.cc:150-156: XOR over j >= code_chk of cc[j]&enc_h[t][j]).
        parity_gen = enc_h[:code_chk, code_chk:].copy()

    # Decoding graph: dec_h[:, j] = H_orig[:, perm[j]]
    # (binaryldpccodec.cc:494-501 rebuild), i.e. an edge (r, c) of the parsed
    # H becomes (r, perm_inv[c]).
    perm_inv = np.empty(num_col, dtype=np.int64)
    perm_inv[perm] = np.arange(num_col)
    edge_row = hmat.row_idx.astype(np.int64)
    edge_col = perm_inv[hmat.col_idx.astype(np.int64)]

    adj = _build_adjacency(edge_row, edge_col, num_row, num_col)
    return LDPCCode(
        name=name or "ldpc",
        is_5g=is_5g,
        num_row=num_row,
        num_col=num_col,
        code_dim=code_dim,
        code_chk=code_chk,
        lifting_factor=hmat.lifting_factor or 0,
        parity_gen=parity_gen,
        **adj,
    )


def _numpy_systematize(h: np.ndarray, reverse: bool):
    if reverse:
        return gf2.systematize_reverse(h)
    return gf2.systematize_forward(h)


def _native_or_numpy_systematize(h: np.ndarray, reverse: bool):
    """Use the C++ eliminator when it builds; NumPy's, bitwise the same, otherwise."""
    if gf2_native.available():
        return gf2_native.systematize(h, reverse)
    return _numpy_systematize(h, reverse)



# ---------------------------------------------------------------------------
# Disk cache — the elimination for PEG8064 costs seconds; tests/benches load
# codes repeatedly, so cache the compiled tables keyed by file content.
# ---------------------------------------------------------------------------

_MEM_CACHE: dict[str, LDPCCode] = {}


def _cache_dir() -> str:
    d = os.environ.get(
        "KMLDPC_TORCH_CACHE",
        os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "..", ".cache", "kmldpc_torch"
        ),
    )
    os.makedirs(d, exist_ok=True)
    return d


def load_code(path: str) -> LDPCCode:
    """Parse + compile (with mem/disk caching) a parity-check matrix file."""
    key = os.path.abspath(path)
    if key in _MEM_CACHE:
        return _MEM_CACHE[key]
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(path))[0]
    cache_file = os.path.join(_cache_dir(), f"{name}-{digest}-v{_CACHE_VERSION}.npz")
    if os.path.exists(cache_file):
        code = _from_npz(cache_file, name)
    else:
        code = compile_code(parse_hmatrix(path), name=name)
        _to_npz(cache_file, code)
    _MEM_CACHE[key] = code
    return code


_ARRAY_FIELDS = [
    "parity_gen",
    "edge_col",
    "edge_row",
    "col_edge_idx",
    "col_mask",
    "row_edge_idx",
    "row_mask",
    "edge_rowslot",
    "row_edge_col",
]
_SCALAR_FIELDS = ["is_5g", "num_row", "num_col", "code_dim", "code_chk", "lifting_factor"]


def _to_npz(path: str, code: LDPCCode) -> None:
    data = {f: getattr(code, f) for f in _ARRAY_FIELDS}
    data.update({f: np.asarray(getattr(code, f)) for f in _SCALAR_FIELDS})
    # a temp file of its own per writer: processes that compile the same
    # code at once each write whole and the last rename wins
    fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _from_npz(path: str, name: str) -> LDPCCode:
    z = np.load(path)
    kwargs = {f: z[f] for f in _ARRAY_FIELDS}
    kwargs.update({f: z[f].item() for f in _SCALAR_FIELDS})
    return LDPCCode(name=name, **kwargs)
