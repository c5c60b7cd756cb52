"""Batch-minor flooding decoder and its exact two-phase schedule (port of
``kmldpc_tpu/decoder/bp_em.py``).

Messages are stored with the Monte-Carlo batch on the minor axis, so every
graph access is a gather of whole rows (coalesced on the GPU).  c2v lives
in row layout; v2c is recomputed in the check pass as ``post_edge - c2v``.
Per iteration: one edge gather (c2v -> column view, summed to posteriors),
one node gather (posteriors -> row slots, serving the syndrome and v2c),
then the check-node update.  Regular codes run the slot-major core,
irregular codes (5G) the degree-class core; both take the check rule
``cn_rule``: "sumprod" (Gallager phi, the reference's rule) or "minsum"
(normalised min-sum with factor ``alpha``), and the message storage type
``msg_dtype`` (float32, or bfloat16 with float32 node arithmetic).
:func:`two_phase_generic` gives any batch decoder (this one, the layered
min-sum decoder) the exact two-phase schedule.

On CUDA tensors the sum-product rule with float32 messages runs a kernel
instead (``decoder/bp_cuda.py``): K2 on a regular code, whose plain version
is the slot-major core, and K3 on an irregular one, whose plain version is
the degree-class core; :func:`flooding_decoder` alone decides, once a
decode.  Both stop each codeword when its syndrome passes, so they need
neither the exit checks below nor the two-phase schedule.

Converged codewords freeze their outputs (hard decisions, iteration
count, soft syndrome); the message array keeps updating, and as every
message is clipped finite the frozen outputs are unaffected.  The loop
exits once the whole batch has converged.  It tests that every
``exit_check_every`` iterations rather than each one (each test is a
host sync on the GPU); the result is the same because frozen outputs do
not change and the loop never runs past ``iter_count``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import constants
from ..utils.trace import count, exit_check, span
from . import bp_cuda
from .bp import PHI_ARG_MIN, DecodeResult, DecoderTables, phi


def _llr_clip() -> float:
    return float(torch.tensor(constants.LLR_CLIP, dtype=torch.float32))


def _cn_sumprod(v2c: torch.Tensor, llr_clip: float, mask: torch.Tensor | None = None):
    """Gallager-phi check-node update over the leading (slot) axis.

    v2c: [d, n, B] f32; ``mask``: [d, n, 1] (1 = real edge) or None when
    every slot is an edge.  Pad slots count as sign +1 and phi 0; their
    outputs are left for the caller to mask.  Returns (c2v_new [d, n, B],
    soft_syndrome [n, B]).
    """
    sign = torch.where(v2c < 0, -1.0, 1.0)
    ph = phi(torch.clamp(v2c.abs(), min=PHI_ARG_MIN))
    if mask is not None:
        sign = torch.where(mask > 0, sign, 1.0)
        ph = ph * mask
    phi_sum = ph.sum(dim=0)  # [n, B]
    sign_prod = sign.prod(dim=0)
    excl_phi = torch.clamp(phi_sum[None] - ph, min=constants.SMALLEST_PROB)
    c2v_new = sign_prod[None] * sign * torch.clamp(phi(excl_phi), max=llr_clip)
    ss_new = 0.5 * (1.0 + sign_prod * torch.exp(-phi_sum))
    return c2v_new, ss_new


def _cn_minsum(
    v2c: torch.Tensor, alpha: float, llr_clip: float, mask: torch.Tensor | None = None
):
    """Normalised min-sum check-node update over the leading (slot) axis.

    Same contract as :func:`_cn_sumprod`.  Each edge gets the smallest
    magnitude of the other edges (min1, or min2 on the edge that holds
    min1; ties go to the first slot, as ``jnp.argmin``), times the sign
    product and ``alpha``; the soft syndrome is ``sigmoid(sign_prod * min1)``.
    Pad slots (``mask`` 0) count as sign +1, take no part in min1 and min2,
    and get message 0.
    """
    d = v2c.shape[0]
    sign = torch.where(v2c < 0, -1.0, 1.0)
    mag = v2c.abs()
    if mask is not None:
        sign = torch.where(mask > 0, sign, 1.0)
        mag = torch.where(mask > 0, mag, 1e30)
    min1 = mag.amin(dim=0)  # [n, B]
    first = torch.argmin(mag, dim=0)  # first minimal slot
    onehot = first[None] == torch.arange(d, device=v2c.device)[:, None, None]
    min2 = torch.where(onehot, 1e30, mag).amin(dim=0)
    excl_min = torch.where(onehot, min2[None], min1[None])
    sign_prod = sign.prod(dim=0)
    c2v_new = alpha * sign_prod[None] * sign * torch.clamp(excl_min, max=llr_clip)
    if mask is not None:
        c2v_new = c2v_new * mask
    return c2v_new, torch.sigmoid(sign_prod * min1)


def _cn(
    v2c: torch.Tensor, cn_rule: str, alpha: float, llr_clip: float,
    mask: torch.Tensor | None = None,
):
    if cn_rule == "minsum":
        return _cn_minsum(v2c, alpha, llr_clip, mask)
    return _cn_sumprod(v2c, llr_clip, mask)


def _insert_punct(t: DecoderTables, llr_tx: torch.Tensor) -> torch.Tensor:
    """[tx_len, B] -> [num_col, B]: the punctured leading columns get LLR 0."""
    if t.punct:
        zeros = torch.zeros((t.punct, llr_tx.shape[1]), dtype=torch.float32, device=llr_tx.device)
        return torch.cat([zeros, llr_tx])
    return llr_tx


def _decode_cols(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, msg_dtype: torch.dtype = torch.float32, exit_check_every: int = 4,
) -> DecodeResult:
    """Column-major core dispatch: regular codes run the slot-major core,
    irregular codes the degree-class core (no pad slots)."""
    if cn_rule not in ("sumprod", "minsum"):
        raise ValueError(f"unknown cn_rule {cn_rule!r}")
    core = _decode_cols_padded if t.is_regular else _decode_cols_classes
    return core(t, llr_col, iter_count, cn_rule, alpha, msg_dtype, exit_check_every)


def _decode_cols_padded(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, msg_dtype: torch.dtype = torch.float32, exit_check_every: int = 4,
) -> DecodeResult:
    """Slot-major flooding core of a regular code on column-major LLRs
    [num_col, B]; c2v lives as [dr, num_row, B].

    Returns a DecodeResult in the column-major layout: cc_hat [num_col, B],
    uu_hat [K, B], soft_syndrome [num_row, B].
    """
    llr_clip = _llr_clip()
    b = llr_col.shape[1]
    dev = llr_col.device
    dc, dr, nc, nr = t.dc, t.dr, t.num_col, t.num_row
    c2v = torch.zeros((dr, nr, b), dtype=msg_dtype, device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    ran = iter_count
    for i in range(iter_count):
        if i > 0 and i % exit_check_every == 0 and exit_check(conv):
            ran = i
            break
        # --- variable nodes on the column-gathered view ---
        c2v_col = c2v.reshape(-1, b)[t.perm_sm_c2r].reshape(dc, nc, b).to(torch.float32)
        post = llr_col + c2v_col.sum(dim=0)  # [nc, B]
        hard = (post <= 0).to(torch.int8)
        cc_hat = torch.where(conv[None, :], cc_hat, hard)
        # --- node gather: posteriors to row slots ---
        post_edge = post[t.row_col_sm].reshape(dr, nr, b)
        parity = (post_edge <= 0).sum(dim=0, dtype=torch.int32) % 2
        ok = (parity == 0).all(dim=0)
        iters = iters + (~conv).to(torch.int32)
        conv = conv | ok
        # --- check nodes; v2c recomputed in place ---
        c2v_new, ss_new = _cn(post_edge - c2v.to(torch.float32), cn_rule, alpha, llr_clip)
        c2v = c2v_new.to(msg_dtype)
        ss = torch.where(conv[None, :], ss, ss_new)
    count("cw_iters_run", b * ran)
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def _decode_cols_classes(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, msg_dtype: torch.dtype = torch.float32, exit_check_every: int = 4,
) -> DecodeResult:
    """Degree-class flooding core of an irregular code; same semantics and
    result layout as :func:`_decode_cols_padded`.

    Columns and rows are sorted by degree (a one-time permutation of the
    LLRs in and the hard/soft outputs out); c2v lives as one row-flat
    [E, B] array in which row class (d, n) owns a contiguous [d*n, B]
    span, viewed as [d, n, B] for its node reductions.  Each class is its
    own reduction and check update, so an iteration launches a few small
    kernels per class.
    """
    llr_clip = _llr_clip()
    b = llr_col.shape[1]
    dev = llr_col.device
    nc, nr = t.num_col, t.num_row
    col_spans = [d * n for d, n in t.col_classes]
    row_spans = [d * n for d, n in t.row_classes]
    llr_s = llr_col[t.col_sort]  # degree-sorted column order
    llr_blocks = llr_s.split([n for _, n in t.col_classes])
    c2v = torch.zeros((t.num_edges, b), dtype=msg_dtype, device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    ran = iter_count
    for i in range(iter_count):
        if i > 0 and i % exit_check_every == 0 and exit_check(conv):
            ran = i
            break
        # --- variable nodes per column class on the column-flat view ---
        c2v_col = c2v[t.perm_cf_c2r].to(torch.float32)  # [E, B]
        post = torch.cat([
            lb + blk.reshape(d, n, b).sum(dim=0)
            for (d, n), lb, blk in zip(t.col_classes, llr_blocks, c2v_col.split(col_spans))
        ])  # [nc, B] sorted
        hard = (post <= 0).to(torch.int8)
        cc_hat = torch.where(conv[None, :], cc_hat, hard)
        # --- node gather: posteriors to row-flat edges ---
        post_edge = post[t.row_col_cf]  # [E, B]
        pe_blocks = [pe.reshape(d, n, b)
                     for (d, n), pe in zip(t.row_classes, post_edge.split(row_spans))]
        parity = torch.cat([(pe <= 0).sum(dim=0, dtype=torch.int32) % 2 for pe in pe_blocks])
        ok = (parity == 0).all(dim=0)
        iters = iters + (~conv).to(torch.int32)
        conv = conv | ok
        # --- check nodes per row class; v2c recomputed in place ---
        news, sss = [], []
        for (d, n), pe, ce in zip(t.row_classes, pe_blocks, c2v.split(row_spans)):
            new, ss_blk = _cn(pe - ce.reshape(d, n, b).to(torch.float32), cn_rule, alpha,
                              llr_clip)
            news.append(new.to(msg_dtype).reshape(d * n, b))
            sss.append(ss_blk)
        c2v = torch.cat(news)
        ss = torch.where(conv[None, :], ss, torch.cat(sss))
    count("cw_iters_run", b * ran)
    cc_orig = cc_hat[t.col_unsort]  # undo the degree sort
    uu_hat = cc_orig[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_orig, conv, iters, ss[t.row_unsort])


def _batch_major(res: DecodeResult) -> DecodeResult:
    return DecodeResult(
        res.uu_hat.T, res.cc_hat.T, res.converged, res.iters, res.soft_syndrome.T
    )


def fused_decode_engages(
    t: DecoderTables, chan_llr: torch.Tensor, cn_rule: str, msg_dtype: torch.dtype
) -> bool:
    """Whether a kernel decodes ``chan_llr``: the sum-product rule, float32
    messages, LLRs on a CUDA device, and a code that K2 (``bp_cuda.fits``:
    regular) or K3 (``bp_cuda.fits_classes``: irregular) takes."""
    return (cn_rule == "sumprod" and msg_dtype == torch.float32
            and chan_llr.device.type == "cuda" and (bp_cuda.fits(t) or bp_cuda.fits_classes(t)))


def flooding_decoder(
    t: DecoderTables, chan_llr: torch.Tensor, cn_rule: str = "sumprod",
    alpha: float = 0.75, msg_dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor, int], DecodeResult]:
    """``decode(llr, iter_count) -> DecodeResult`` for ``chan_llr`` and
    sub-batches of its rows, as :func:`flooding_decode_em` decodes.  It asks
    :func:`fused_decode_engages` once: ``decode.per_codeword`` says whether
    K2 or K3 runs each codeword to its own convergence (else the eager core).
    """
    per_codeword = fused_decode_engages(t, chan_llr, cn_rule, msg_dtype)
    launch = bp_cuda.launch_k2 if t.is_regular else bp_cuda.launch_k3

    def decode(llr: torch.Tensor, iter_count: int) -> DecodeResult:
        llr = llr.to(torch.float32)
        if per_codeword:
            return launch(t, llr, iter_count)
        llr_col = _insert_punct(t, llr.T.contiguous())
        return _batch_major(_decode_cols(t, llr_col, iter_count, cn_rule, alpha, msg_dtype))

    decode.per_codeword = per_codeword  # type: ignore[attr-defined]
    return decode


def flooding_decode_em(
    t: DecoderTables, chan_llr: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, msg_dtype: torch.dtype = torch.float32,
) -> DecodeResult:
    """Flooding BP decode of [B, tx_len] channel LLRs log(P0/P1).

    Same result semantics as ``kmldpc_tpu.decoder.bp_em.flooding_decode_em``;
    batch-major outputs over all ``num_col`` columns.  ``msg_dtype`` is the
    storage type of the c2v messages: float32 (the reference's) or
    bfloat16, which every read widens to float32 and every write rounds to
    nearest even, as XLA's convert does; node arithmetic stays float32.
    Where :func:`fused_decode_engages` holds, kernel K2 (a regular code) or
    K3 (an irregular one) decodes (:func:`flooding_decoder`).
    """
    return flooding_decoder(t, chan_llr, cn_rule, alpha, msg_dtype)(chan_llr, iter_count)


def two_phase_generic(
    decode: Callable[[torch.Tensor, int], DecodeResult],
    chan_llr: torch.Tensor,
    iter_count: int,
    phase1_iters: int = 8,
    tile: int = 128,
) -> DecodeResult:
    """Exact two-phase schedule of a deterministic batch decoder
    ``decode(chan_llr, iter_count) -> DecodeResult`` (batch-major results).

    Phase 1 runs ``phase1_iters`` on the whole batch.  Phase 2 orders the
    codewords unconverged-first (stable argsort, so tiles are
    deterministic) and re-decodes them from scratch in ``tile``-wide
    sub-batches with the full budget.  The decoder is deterministic per
    codeword, so outputs equal ``decode``'s on the whole batch; only wasted
    work changes.  The last tile starts at ``b - tile`` and may re-decode
    converged codewords, which rewrites identical values.  A decoder whose
    ``per_codeword`` attribute is true (:func:`flooding_decoder` on K2 or
    K3) stops each codeword on its own: it gets one call on the whole batch
    with the whole budget.
    """
    b = chan_llr.shape[0]
    tile = min(max(8, tile), b)
    if getattr(decode, "per_codeword", False) or tile >= b or phase1_iters >= iter_count:
        return decode(chan_llr, iter_count)
    with span("decode.phase1"):
        uu_hat, cc_hat, conv, iters, ss = decode(chan_llr, phase1_iters)
    with span("decode.sort"):
        # unconverged (0) first; argsort does not take bool on every device
        order = torch.argsort(conv.to(torch.int32), stable=True)
        count("syncs")
        n_unconv = int((~conv).sum())
    for start in range(0, n_unconv, tile):
        with span("decode.tile"):
            idx = order[min(start, b - tile) :][:tile]
            sub = decode(chan_llr[idx], iter_count)
            uu_hat[idx] = sub.uu_hat
            cc_hat[idx] = sub.cc_hat
            conv[idx] = sub.converged
            iters[idx] = sub.iters
            ss[idx] = sub.soft_syndrome
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)
