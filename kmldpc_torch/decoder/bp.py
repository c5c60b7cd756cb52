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
  ``row_col_cf``);
* edge-major (``flooding_decode``, the JAX package's reference decoder):
  messages ``[B, E]`` in column-sorted edge order, gathered per column
  (``col_edge_idx``) and per row (``row_edge_idx``) with a zero pad edge.

5G codes puncture their first ``punct = 2Z`` columns: they carry LLR 0.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple

import numpy as np
import torch

from .. import constants
from ..code.ldpc import LDPCCode
from ..device import resolve_device
from ..utils.trace import count, exit_check

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
                 "perm_cf_c2r", "row_col_cf", "edge_col", "col_edge_idx", "row_edge_idx",
                 "edge_rowslot")


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
    # edge-major layout (edges column-sorted)
    edge_col: torch.Tensor  # [E] — column of each edge
    col_edge_idx: torch.Tensor  # [num_col, dc_max] — edges of each column, E = pad
    row_edge_idx: torch.Tensor  # [num_row, dr_max] — edges of each row, E = pad
    row_mask: torch.Tensor  # [num_row, dr_max] f32 — 1 where a real edge
    edge_rowslot: torch.Tensor  # [E] — flat (row, slot) position of each edge

    # the host values a DecoderTables is built from, named as the fields of
    # the JAX package's DecoderTables
    HOST_FIELDS: ClassVar[tuple[str, ...]] = (
        "num_col", "num_row", "num_edges", "code_dim", "punct", "is_5g", "info_start",
        "dc", "dr", "col_classes", "row_classes", *_INDEX_FIELDS, "row_mask",
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
            edge_col=code.edge_col,
            col_edge_idx=code.col_edge_idx,
            row_edge_idx=code.row_edge_idx,
            row_mask=code.row_mask,
            edge_rowslot=code.edge_rowslot,
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
            row_mask=torch.tensor(np.asarray(host["row_mask"]).astype(np.float32),
                                  device=device),
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


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (slot) axis, left to right, as XLA's reduction
    adds a row's few slots."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def flooding_decode(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
    """Edge-major flooding sum-product decode of [B, tx_len] channel LLRs
    log(P0/P1) (the JAX package's reference ``flooding_decode``, with its
    operation order).

    Per iteration: variable nodes sum their column's messages onto the
    channel LLR (posterior, hard decision ``post <= 0``), the frozen hard
    words are checked, then check nodes apply the phi rule with
    self-exclusion; a codeword's decisions, messages and soft syndrome
    freeze at the iteration its syndrome first passes, and the loop ends
    when every codeword has converged or after ``iter_count`` iterations.
    """
    llr_clip = float(constants.LLR_CLIP)
    b = chan_llr.shape[0]
    dev = chan_llr.device
    llr_col = channel_llr_to_columns(t, chan_llr.to(torch.float32))
    row_real = t.row_mask > 0

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, torch.zeros((b, 1), dtype=x.dtype, device=dev)], dim=1)

    def vn_pass(c2v: torch.Tensor):
        post = llr_col + _sum_last(pad(c2v)[:, t.col_edge_idx])  # [B, num_col]
        v2c = post[:, t.edge_col] - c2v
        # the reference decides bit 0 iff alpha0 > alpha1, i.e. LLR > 0
        return v2c, (post <= 0).to(torch.int8)

    def syndrome_ok(hard: torch.Tensor) -> torch.Tensor:
        per_row = pad(hard.to(torch.int32))[:, t.row_edge_col]
        return (per_row.sum(dim=-1) % 2 == 0).all(dim=-1)

    def cn_pass(v2c: torch.Tensor):
        per_row = pad(v2c)[:, t.row_edge_idx]  # [B, num_row, dr_max]
        sign = torch.where(per_row < 0, -1.0, 1.0)
        sign = torch.where(row_real, sign, 1.0)
        mag = torch.clamp(per_row.abs(), min=PHI_ARG_MIN)
        ph = torch.where(row_real, phi(mag), 0.0)
        phi_sum = _sum_last(ph)  # [B, num_row]
        sign_prod = sign.prod(dim=-1)
        excl_phi = torch.clamp(phi_sum[:, :, None] - ph, min=constants.SMALLEST_PROB)
        excl_sign = sign_prod[:, :, None] * sign
        c2v_row = excl_sign * torch.clamp(phi(excl_phi), max=llr_clip)
        c2v_new = c2v_row.reshape(b, -1)[:, t.edge_rowslot]
        # soft syndrome: P(row XOR = 0) = (1 + prod tanh(v2c/2)) / 2
        return c2v_new, 0.5 * (1.0 + sign_prod * torch.exp(-phi_sum))

    c2v = torch.zeros((b, t.num_edges), dtype=torch.float32, device=dev)
    cc_hat = torch.zeros((b, t.num_col), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((b, t.num_row), dtype=torch.float32, device=dev)
    ran = iter_count
    for i in range(iter_count):
        if exit_check(conv):
            ran = i
            break
        v2c, hard = vn_pass(c2v)
        cc_hat = torch.where(conv[:, None], cc_hat, hard)
        ok = syndrome_ok(cc_hat)
        iters = iters + (~conv).to(torch.int32)
        conv_after = conv | ok
        c2v_new, ss_new = cn_pass(v2c)
        # the reference skips the check update once converged (break before it)
        c2v = torch.where(conv_after[:, None], c2v, c2v_new)
        ss = torch.where(conv_after[:, None], ss, ss_new)
        conv = conv_after
    count("cw_iters_run", b * ran)
    uu_hat = cc_hat[:, t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def make_flooding_decoder(
    code: LDPCCode, device: torch.device | str = "cuda"
) -> Callable[[torch.Tensor, int], DecodeResult]:
    """``decode(chan_llr, iter_count) -> DecodeResult``: the edge-major
    decoder bound to one code's tables on ``device`` (resolved by
    ``resolve_device``: "cuda" without a card raises)."""
    t = DecoderTables.from_code(code, resolve_device(device))

    def decode(chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
        return flooding_decode(t, chan_llr, iter_count)

    decode.tables = t  # type: ignore[attr-defined]
    return decode
