"""Decoder tables, Gallager's phi and parity counting (port of
``kmldpc_tpu/decoder/bp.py``).

Two message layouts, both built in NumPy from the host-side ``LDPCCode``
exactly as the JAX package builds them:

* slot-major (regular codes: PEG2304, PEG8064): c2v messages live as
  ``[dr, num_row, B]`` (batch-minor), so merging the two leading axes is
  free and the only data movement per iteration is two row gathers
  (``perm_sm_c2r`` and ``row_col_sm``);
* degree-class (irregular codes: the 5G BG2 code): columns and rows sorted
  by degree, each degree class owning a contiguous span of one flat
  ``[E, B]`` message array, so no slot is padding (``perm_cf_c2r`` and
  ``row_col_cf``).

5G codes puncture their first ``punct = 2Z`` columns: they carry LLR 0.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import numpy as np
import torch

from ..code.ldpc import LDPCCode

# Guard for phi(0) = inf.  Must stay >= ~1e-6: below that exp(-x) rounds to
# exactly 1.0 in f32 and log1p(-exp(-x)) returns -inf.
PHI_ARG_MIN = 1e-6


def phi(x: torch.Tensor) -> torch.Tensor:
    """Gallager's self-inverse phi(x) = -log tanh(x/2), f32-stable for x > 0.

    Piecewise at 5.0: tanh directly below, log1p(e^-x) - log1p(-e^-x)
    above (where tanh(x/2) rounds to 1 in f32).  Each branch's input is
    clamped so the untaken branch never produces inf.
    """
    small = -torch.log(torch.tanh(torch.clamp(x, max=5.0) * 0.5))
    e = torch.exp(-torch.clamp(x, min=5.0))
    large = torch.log1p(e) - torch.log1p(-e)
    return torch.where(x < 5.0, small, large)


class DecodeResult(NamedTuple):
    uu_hat: torch.Tensor  # [B, K] int8
    cc_hat: torch.Tensor  # [B, num_col] int8
    converged: torch.Tensor  # [B] bool
    iters: torch.Tensor  # [B] int32
    soft_syndrome: torch.Tensor  # [B, num_row] f32


_INDEX_FIELDS = ("perm_sm_c2r", "row_edge_col", "col_sort", "col_unsort", "row_unsort",
                 "perm_cf_c2r", "row_col_cf")


@dataclasses.dataclass(frozen=True)
class DecoderTables:
    """Graph tables of one code on one device."""

    num_col: int
    num_row: int
    num_edges: int
    code_dim: int
    punct: int  # leading punctured columns: 2Z for 5G, 0 for classic codes
    is_5g: bool
    info_start: int  # first info column: 0 for 5G [info | parity], code_chk for [parity | info]
    dc: int  # column degree of a regular code; 0 if irregular
    dr: int  # row degree of a regular code; 0 if irregular
    col_classes: tuple  # ((degree, columns), ...) ascending by degree
    row_classes: tuple  # ((degree, rows), ...)
    # slot-major layout.  perm_sm_c2r[q]: slot-major row-flat position of the
    # edge at slot-major column-flat position q (pads point at 0)
    perm_sm_c2r: torch.Tensor  # [dc_max*num_col] int64
    row_edge_col: torch.Tensor  # [num_row, dr_max] int64 — column of each row slot, num_col = pad
    row_col_sm: torch.Tensor  # [dr_max*num_row] int64 — row_edge_col.T flattened
    # degree-class layout
    col_sort: torch.Tensor  # [num_col] — sorted position -> column
    col_unsort: torch.Tensor  # [num_col] — column -> sorted position
    row_unsort: torch.Tensor  # [num_row] — row -> sorted position
    perm_cf_c2r: torch.Tensor  # [E] — class column-flat position -> row-flat position
    row_col_cf: torch.Tensor  # [E] — class row-flat position -> sorted column

    # the host values a DecoderTables is built from, named as the fields of
    # the JAX package's DecoderTables
    HOST_FIELDS: ClassVar[tuple[str, ...]] = (
        "num_col", "num_row", "num_edges", "code_dim", "punct", "is_5g", "info_start",
        "dc", "dr", "col_classes", "row_classes", *_INDEX_FIELDS,
    )

    @property
    def is_regular(self) -> bool:
        return self.dc > 0

    @staticmethod
    def from_code(code: LDPCCode, device: torch.device | str = "cpu") -> "DecoderTables":
        regular = bool(code.col_mask.all() and code.row_mask.all())
        return DecoderTables.from_arrays(
            device=device,
            num_col=code.num_col,
            num_row=code.num_row,
            num_edges=code.num_edges,
            code_dim=code.code_dim,
            punct=code.punct,
            is_5g=code.is_5g,
            info_start=0 if code.is_5g else code.code_chk,
            dc=code.dc_max if regular else 0,
            dr=code.dr_max if regular else 0,
            perm_sm_c2r=slot_major_perm(code),
            row_edge_col=code.row_edge_col,
            **class_tables(code),
        )

    @staticmethod
    def from_arrays(device: torch.device | str = "cpu", **host) -> "DecoderTables":
        """Build from host values named as the fields of the JAX package's
        ``DecoderTables``: Python scalars and class tuples, and index arrays
        as anything ``np.asarray`` takes."""
        idx = {
            f: torch.tensor(np.asarray(host[f]).astype(np.int64), device=device)
            for f in _INDEX_FIELDS
        }
        classes = {
            f: tuple((int(d), int(n)) for d, n in host[f]) for f in ("col_classes", "row_classes")
        }
        return DecoderTables(
            num_col=int(host["num_col"]),
            num_row=int(host["num_row"]),
            num_edges=int(host["num_edges"]),
            code_dim=int(host["code_dim"]),
            punct=int(host["punct"]),
            is_5g=bool(host["is_5g"]),
            info_start=int(host["info_start"]),
            dc=int(host["dc"]),
            dr=int(host["dr"]),
            **classes,
            **idx,
            row_col_sm=idx["row_edge_col"].T.reshape(-1).contiguous(),
        )


def slot_major_perm(code: LDPCCode) -> np.ndarray:
    """``perm_sm_c2r`` of ``code`` (NumPy), as
    ``kmldpc_tpu.decoder.bp.DecoderTables.from_code`` builds it: edge e
    (column-sorted) sits at slot = its rank within its column, and at
    (row, slot) from ``edge_rowslot`` on the row side.  Pad positions
    point at index 0."""
    dcm, drm = code.dc_max, code.dr_max
    col_of = code.edge_col.astype(np.int64)
    cd = np.bincount(col_of, minlength=code.num_col)
    slot_c = np.arange(code.num_edges, dtype=np.int64) - (np.cumsum(cd) - cd)[col_of]
    col_sm = slot_c * code.num_col + col_of
    r = (code.edge_rowslot // drm).astype(np.int64)
    s = (code.edge_rowslot % drm).astype(np.int64)
    perm_sm_c2r = np.zeros(dcm * code.num_col, dtype=np.int32)
    perm_sm_c2r[col_sm] = s * code.num_row + r
    return perm_sm_c2r


def _class_layout(degrees: np.ndarray):
    """Sort nodes ascending by degree and give each node's edge slots a
    contiguous flat span per degree class (``kmldpc_tpu``'s ``_class_layout``).

    Returns (classes, sort, unsort, slot_base, stride): ``classes`` is
    ``((degree, count), ...)``, ``sort[p]`` the node at sorted position p,
    ``unsort`` its inverse, and slot s of a node sits at flat index
    ``slot_base[node] + s * stride[node]``.
    """
    sort = np.argsort(degrees, kind="stable").astype(np.int32)
    unsort = np.empty_like(sort)
    unsort[sort] = np.arange(sort.shape[0], dtype=np.int32)
    degs, counts = np.unique(degrees, return_counts=True)
    classes = tuple((int(d), int(n)) for d, n in zip(degs, counts))
    base = np.cumsum(counts) - counts  # first sorted node of each class
    off = np.cumsum(degs * counts) - degs * counts  # first flat index of each class
    cls_of = np.searchsorted(degs, degrees)
    slot_base = off[cls_of] - base[cls_of] + unsort.astype(np.int64)
    stride = counts.astype(np.int64)[cls_of]
    return classes, sort, unsort, slot_base, stride


def class_tables(code: LDPCCode) -> dict:
    """The degree-class tables of ``code`` (NumPy and tuples), as
    ``kmldpc_tpu``'s ``_build_class_tables`` builds them."""
    cd = np.bincount(code.edge_col, minlength=code.num_col)
    rd = np.bincount(code.edge_row, minlength=code.num_row)
    ccls, csort, cunsort, cslot_base, cstride = _class_layout(cd)
    rcls, _, runsort, rslot_base, rstride = _class_layout(rd)
    # edges are column-sorted, so the slot (rank within column) is positional
    slot_c = np.arange(code.num_edges, dtype=np.int64) - (np.cumsum(cd) - cd)[code.edge_col]
    colflat = cslot_base[code.edge_col] + slot_c * cstride[code.edge_col]
    slot_r = (code.edge_rowslot % code.dr_max).astype(np.int64)
    rowflat = rslot_base[code.edge_row] + slot_r * rstride[code.edge_row]
    perm_cf_c2r = np.empty(code.num_edges, dtype=np.int32)
    perm_cf_c2r[colflat] = rowflat
    row_col_cf = np.empty(code.num_edges, dtype=np.int32)
    row_col_cf[rowflat] = cunsort[code.edge_col]
    return dict(col_classes=ccls, row_classes=rcls, col_sort=csort, col_unsort=cunsort,
                row_unsort=runsort, perm_cf_c2r=perm_cf_c2r, row_col_cf=row_col_cf)


def channel_llr_to_columns(t: DecoderTables, chan_llr: torch.Tensor) -> torch.Tensor:
    """[B, tx_len] transmitted-position LLRs -> [B, num_col] graph columns:
    the punctured leading columns get LLR 0."""
    if t.punct == 0:
        return chan_llr
    zeros = torch.zeros((chan_llr.shape[0], t.punct), dtype=chan_llr.dtype, device=chan_llr.device)
    return torch.cat([zeros, chan_llr], dim=1)


def count_failed_checks(t: DecoderTables, bits: torch.Tensor) -> torch.Tensor:
    """Number of unsatisfied parity checks of a [B, num_col] 0/1 word, int32."""
    zero = torch.zeros((bits.shape[0], 1), dtype=torch.int8, device=bits.device)
    bits_pad = torch.cat([bits.to(torch.int8), zero], dim=1)  # pad column = 0
    per_row = bits_pad[:, t.row_edge_col]  # [B, num_row, dr]
    parity = per_row.sum(dim=-1, dtype=torch.int32) % 2
    return parity.sum(dim=-1, dtype=torch.int32)
