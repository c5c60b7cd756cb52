"""Decoder tables, Gallager's phi and parity counting (port of
``kmldpc_tpu/decoder/bp.py``).

The tables are the slot-major ones the flooding core uses: c2v messages
live as ``[dr, num_row, B]`` (batch-minor), so merging the two leading
axes is free and the only data movement per iteration is two row gathers
(``perm_sm_c2r`` and ``row_col_sm``).  They are built in NumPy from the
host-side ``LDPCCode``, in the same way as the JAX package builds them.

Classic codes only.  Regular codes (PEG2304, PEG8064) need no masks;
an irregular classic code runs on the same padded layout with its pad
slots masked, as in the JAX padded core.  The degree-class layout (the
JAX package's fast path for irregular codes) and 5G puncturing are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from kmldpc_tpu.code.ldpc import LDPCCode

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


@dataclasses.dataclass(frozen=True)
class DecoderTables:
    """Slot-major graph tables of one classic code on one device."""

    num_col: int
    num_row: int
    code_dim: int
    info_start: int  # first info column of [parity | info]
    dc: int  # max column degree (slots per column)
    dr: int  # max row degree (slots per row)
    regular: bool  # every slot is a real edge: the masks are skipped
    # perm_sm_c2r[q]: slot-major row-flat position of the edge at slot-major
    # column-flat position q (the c2v -> column-view gather)
    perm_sm_c2r: torch.Tensor  # [dc*num_col] int64
    col_mask_sm: torch.Tensor  # [dc, num_col] f32 — 1 where a real edge
    row_mask_sm: torch.Tensor  # [dr, num_row] f32
    row_edge_col: torch.Tensor  # [num_row, dr] int64 — column of each row slot, num_col = pad
    row_col_sm: torch.Tensor  # [dr*num_row] int64 — row_edge_col.T flattened

    @staticmethod
    def from_code(code: LDPCCode, device: torch.device | str = "cpu") -> "DecoderTables":
        if code.is_5g:
            raise NotImplementedError(
                f"code {code.name!r} is a 5G code; puncturing and the degree-class "
                "decoder core are not ported yet "
                "(ROADMAP.md Queue 1, 'degree-class core and 5G')"
            )
        return DecoderTables.from_arrays(
            num_col=code.num_col,
            num_row=code.num_row,
            code_dim=code.code_dim,
            info_start=code.code_chk,
            **slot_major_tables(code),
            device=device,
        )

    @staticmethod
    def from_arrays(
        *, num_col, num_row, code_dim, info_start,
        perm_sm_c2r, col_mask_sm, row_mask_sm, row_edge_col,
        device: torch.device | str = "cpu",
    ) -> "DecoderTables":
        """Build from host arrays (NumPy or anything ``np.asarray`` takes)."""
        def idx(a):
            return torch.tensor(np.asarray(a).astype(np.int64), device=device)

        def f32(a):
            return torch.tensor(np.asarray(a).astype(np.float32), device=device)

        col_mask_sm = np.asarray(col_mask_sm)
        row_mask_sm = np.asarray(row_mask_sm)
        row_edge_col = np.asarray(row_edge_col)
        return DecoderTables(
            num_col=int(num_col),
            num_row=int(num_row),
            code_dim=int(code_dim),
            info_start=int(info_start),
            dc=int(col_mask_sm.shape[0]),
            dr=int(row_mask_sm.shape[0]),
            regular=bool(col_mask_sm.all() and row_mask_sm.all()),
            perm_sm_c2r=idx(perm_sm_c2r),
            col_mask_sm=f32(col_mask_sm),
            row_mask_sm=f32(row_mask_sm),
            row_edge_col=idx(row_edge_col),
            row_col_sm=idx(row_edge_col.T.reshape(-1)),
        )


def slot_major_tables(code: LDPCCode) -> dict[str, np.ndarray]:
    """The slot-major permutations and masks of ``code`` (NumPy).

    Same construction as ``kmldpc_tpu.decoder.bp.DecoderTables.from_code``:
    edge e (column-sorted) sits at slot = its rank within its column, and
    at (row, slot) from ``edge_rowslot`` on the row side.  Pad positions
    point at index 0 and are neutralised by the masks.
    """
    dcm, drm = code.dc_max, code.dr_max
    col_of = code.edge_col.astype(np.int64)
    col_starts = np.cumsum(np.bincount(col_of, minlength=code.num_col)) - np.bincount(
        col_of, minlength=code.num_col
    )
    slot_c = np.arange(code.num_edges, dtype=np.int64) - col_starts[col_of]
    col_sm = slot_c * code.num_col + col_of
    r = (code.edge_rowslot // drm).astype(np.int64)
    s = (code.edge_rowslot % drm).astype(np.int64)
    row_sm = s * code.num_row + r
    perm_sm_c2r = np.zeros(dcm * code.num_col, dtype=np.int32)
    perm_sm_c2r[col_sm] = row_sm
    col_mask_sm = np.zeros(dcm * code.num_col, dtype=np.float32)
    col_mask_sm[col_sm] = 1.0
    row_mask_sm = np.zeros(drm * code.num_row, dtype=np.float32)
    row_mask_sm[row_sm] = 1.0
    return dict(
        perm_sm_c2r=perm_sm_c2r,
        col_mask_sm=col_mask_sm.reshape(dcm, code.num_col),
        row_mask_sm=row_mask_sm.reshape(drm, code.num_row),
        row_edge_col=code.row_edge_col,
    )


def count_failed_checks(t: DecoderTables, bits: torch.Tensor) -> torch.Tensor:
    """Number of unsatisfied parity checks of a [B, num_col] 0/1 word, int32."""
    zero = torch.zeros((bits.shape[0], 1), dtype=torch.int8, device=bits.device)
    bits_pad = torch.cat([bits.to(torch.int8), zero], dim=1)  # pad column = 0
    per_row = bits_pad[:, t.row_edge_col]  # [B, num_row, dr]
    parity = per_row.sum(dim=-1, dtype=torch.int32) % 2
    return parity.sum(dim=-1, dtype=torch.int32)
