"""Batch-minor flooding sum-product decoder and its exact two-phase schedule
(port of ``kmldpc_tpu/decoder/bp_em.py``, classic codes on the padded
slot-major core).

Messages are stored ``[slot, node, B]`` with the Monte-Carlo batch on the
minor axis, so every graph access is a gather of whole rows (coalesced on
the GPU).  c2v lives in row-slot layout; v2c is recomputed in the check
pass as ``post_edge - c2v``.  Per iteration: one edge gather (c2v ->
column view, summed to posteriors), one node gather (posteriors -> row
slots, serving the syndrome and v2c), then the phi check-node update.

Converged codewords freeze their outputs (hard decisions, iteration
count, soft syndrome); the message array keeps updating, and as every
message is clipped finite the frozen outputs are unaffected.  The loop
exits once the whole batch has converged.  It tests that every
``exit_check_every`` iterations rather than each one (each test is a
host sync on the GPU); the result is the same because frozen outputs do
not change and the loop never runs past ``iter_count``.
"""

from __future__ import annotations

import torch

from .. import constants
from .bp import PHI_ARG_MIN, DecodeResult, DecoderTables, phi


def _cn_sumprod(v2c: torch.Tensor, mask: torch.Tensor | None, llr_clip: float):
    """Gallager-phi check-node update over the leading (slot) axis.

    v2c: [dr, n, B] f32; mask: [dr, n, 1] (1 = real edge) or None for a
    regular code.  Returns (c2v_new [dr, n, B], soft_syndrome [n, B]).
    """
    sign = torch.where(v2c < 0, -1.0, 1.0)
    mag = torch.clamp(v2c.abs(), min=PHI_ARG_MIN)
    ph = phi(mag)
    if mask is not None:
        sign = torch.where(mask > 0, sign, 1.0)
        ph = ph * mask
    phi_sum = ph.sum(dim=0)  # [n, B]
    sign_prod = sign.prod(dim=0)
    excl_phi = torch.clamp(phi_sum[None] - ph, min=constants.SMALLEST_PROB)
    excl_sign = sign_prod[None] * sign
    c2v_new = excl_sign * torch.clamp(phi(excl_phi), max=llr_clip)
    ss_new = 0.5 * (1.0 + sign_prod * torch.exp(-phi_sum))
    return c2v_new, ss_new


def _decode_cols_padded(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, exit_check_every: int = 4
) -> DecodeResult:
    """Slot-major flooding core on column-major LLRs [num_col, B].

    Pad slots of an irregular code are neutralised as in the JAX padded
    core: zero on the column side, sign +1 and phi 0 on the row side, and
    pad columns read an appended posterior of +1 (hard 0, no parity).

    Returns a DecodeResult in the column-major layout: cc_hat [num_col, B],
    uu_hat [K, B], soft_syndrome [num_row, B].
    """
    llr_clip = float(torch.tensor(constants.LLR_CLIP, dtype=torch.float32))
    b = llr_col.shape[1]
    dev = llr_col.device
    dc, dr, nc, nr = t.dc, t.dr, t.num_col, t.num_row
    c2v = torch.zeros((dr, nr, b), dtype=torch.float32, device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    cmask = rmask = None
    if not t.regular:
        cmask = t.col_mask_sm[:, :, None]
        rmask = t.row_mask_sm[:, :, None]
        post_pad = torch.ones((1, b), dtype=torch.float32, device=dev)
    for i in range(iter_count):
        if i > 0 and i % exit_check_every == 0 and bool(conv.all()):
            break
        # --- variable nodes on the column-gathered view ---
        c2v_col = c2v.reshape(-1, b)[t.perm_sm_c2r].reshape(dc, nc, b)
        if cmask is not None:
            c2v_col = c2v_col * cmask  # pad slots gathered garbage -> 0
        post = llr_col + c2v_col.sum(dim=0)  # [nc, B]
        hard = (post <= 0).to(torch.int8)
        cc_hat = torch.where(conv[None, :], cc_hat, hard)
        # --- node gather: posteriors to row slots ---
        if rmask is not None:
            post_edge = torch.cat([post, post_pad])[t.row_col_sm].reshape(dr, nr, b)
        else:
            post_edge = post[t.row_col_sm].reshape(dr, nr, b)
        parity = (post_edge <= 0).sum(dim=0, dtype=torch.int32) % 2
        ok = (parity == 0).all(dim=0)
        iters = iters + (~conv).to(torch.int32)
        conv = conv | ok
        # --- check nodes; v2c recomputed in place ---
        c2v, ss_new = _cn_sumprod(post_edge - c2v, rmask, llr_clip)
        ss = torch.where(conv[None, :], ss, ss_new)
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def _batch_major(res: DecodeResult) -> DecodeResult:
    return DecodeResult(
        res.uu_hat.T, res.cc_hat.T, res.converged, res.iters, res.soft_syndrome.T
    )


def flooding_decode_em(
    t: DecoderTables, chan_llr: torch.Tensor, iter_count: int
) -> DecodeResult:
    """Flooding BP decode of [B, num_col] channel LLRs log(P0/P1).

    Same result semantics as ``kmldpc_tpu.decoder.bp_em.flooding_decode_em``
    (float32 messages, sum-product check rule); batch-major outputs.
    """
    llr_col = chan_llr.to(torch.float32).T.contiguous()
    return _batch_major(_decode_cols_padded(t, llr_col, iter_count))


def flooding_decode_two_phase(
    t: DecoderTables,
    chan_llr: torch.Tensor,
    iter_count: int,
    phase1_iters: int = 3,
    tile: int = 128,
) -> DecodeResult:
    """Exact two-phase flooding decode, bit-identical to
    :func:`flooding_decode_em`.

    Phase 1 runs ``phase1_iters`` on the whole batch.  Phase 2 orders the
    codewords unconverged-first (stable argsort, so tiles are
    deterministic) and re-decodes them from scratch in ``tile``-wide
    sub-batches with the full budget.  BP is deterministic per codeword,
    so outputs equal the single-phase decoder's; only wasted work changes.
    The last tile starts at ``b - tile`` and may re-decode converged
    codewords, which rewrites identical values.
    """
    b = chan_llr.shape[0]
    tile = min(max(8, tile), b)
    if tile >= b or phase1_iters >= iter_count:
        return flooding_decode_em(t, chan_llr, iter_count)
    llr_col = chan_llr.to(torch.float32).T.contiguous()
    p1 = _decode_cols_padded(t, llr_col, phase1_iters)
    # unconverged (0) first; argsort does not take bool on every device
    order = torch.argsort(p1.converged.to(torch.int32), stable=True)
    n_unconv = int((~p1.converged).sum())
    cc_hat, conv, iters, ss = p1.cc_hat, p1.converged, p1.iters, p1.soft_syndrome
    k = 0
    while k * tile < n_unconv:
        start = min(k * tile, b - tile)
        idx = order[start : start + tile]
        sub = _decode_cols_padded(t, llr_col[:, idx], iter_count)
        cc_hat[:, idx] = sub.cc_hat
        conv[idx] = sub.converged
        iters[idx] = sub.iters
        ss[:, idx] = sub.soft_syndrome
        k += 1
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return _batch_major(DecodeResult(uu_hat, cc_hat, conv, iters, ss))
