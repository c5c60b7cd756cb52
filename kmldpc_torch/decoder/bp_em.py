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
(normalised min-sum with factor ``alpha``).

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


def _llr_clip() -> float:
    return float(torch.tensor(constants.LLR_CLIP, dtype=torch.float32))


def _cn_sumprod(v2c: torch.Tensor, llr_clip: float):
    """Gallager-phi check-node update over the leading (slot) axis.

    v2c: [d, n, B] f32.  Returns (c2v_new [d, n, B], soft_syndrome [n, B]).
    """
    sign = torch.where(v2c < 0, -1.0, 1.0)
    ph = phi(torch.clamp(v2c.abs(), min=PHI_ARG_MIN))
    phi_sum = ph.sum(dim=0)  # [n, B]
    sign_prod = sign.prod(dim=0)
    excl_phi = torch.clamp(phi_sum[None] - ph, min=constants.SMALLEST_PROB)
    c2v_new = sign_prod[None] * sign * torch.clamp(phi(excl_phi), max=llr_clip)
    ss_new = 0.5 * (1.0 + sign_prod * torch.exp(-phi_sum))
    return c2v_new, ss_new


def _cn_minsum(v2c: torch.Tensor, alpha: float, llr_clip: float):
    """Normalised min-sum check-node update over the leading (slot) axis.

    Same contract as :func:`_cn_sumprod`.  Each edge gets the smallest
    magnitude of the other edges (min1, or min2 on the edge that holds
    min1; ties go to the first slot, as ``jnp.argmin``), times the sign
    product and ``alpha``; the soft syndrome is ``sigmoid(sign_prod * min1)``.
    """
    d = v2c.shape[0]
    sign = torch.where(v2c < 0, -1.0, 1.0)
    mag = v2c.abs()
    min1 = mag.amin(dim=0)  # [n, B]
    first = torch.argmin(mag, dim=0)  # first minimal slot
    onehot = first[None] == torch.arange(d, device=v2c.device)[:, None, None]
    min2 = torch.where(onehot, 1e30, mag).amin(dim=0)
    excl_min = torch.where(onehot, min2[None], min1[None])
    sign_prod = sign.prod(dim=0)
    c2v_new = alpha * sign_prod[None] * sign * torch.clamp(excl_min, max=llr_clip)
    return c2v_new, torch.sigmoid(sign_prod * min1)


def _cn(v2c: torch.Tensor, cn_rule: str, alpha: float, llr_clip: float):
    if cn_rule == "minsum":
        return _cn_minsum(v2c, alpha, llr_clip)
    return _cn_sumprod(v2c, llr_clip)


def _insert_punct(t: DecoderTables, llr_tx: torch.Tensor) -> torch.Tensor:
    """[tx_len, B] -> [num_col, B]: the punctured leading columns get LLR 0."""
    if t.punct:
        zeros = torch.zeros((t.punct, llr_tx.shape[1]), dtype=torch.float32, device=llr_tx.device)
        return torch.cat([zeros, llr_tx])
    return llr_tx


def _decode_cols(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, exit_check_every: int = 4,
) -> DecodeResult:
    """Column-major core dispatch: regular codes run the slot-major core,
    irregular codes the degree-class core (no pad slots)."""
    if cn_rule not in ("sumprod", "minsum"):
        raise ValueError(f"unknown cn_rule {cn_rule!r}")
    core = _decode_cols_padded if t.is_regular else _decode_cols_classes
    return core(t, llr_col, iter_count, cn_rule, alpha, exit_check_every)


def _decode_cols_padded(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, exit_check_every: int = 4,
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
    c2v = torch.zeros((dr, nr, b), dtype=torch.float32, device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    for i in range(iter_count):
        if i > 0 and i % exit_check_every == 0 and bool(conv.all()):
            break
        # --- variable nodes on the column-gathered view ---
        c2v_col = c2v.reshape(-1, b)[t.perm_sm_c2r].reshape(dc, nc, b)
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
        c2v, ss_new = _cn(post_edge - c2v, cn_rule, alpha, llr_clip)
        ss = torch.where(conv[None, :], ss, ss_new)
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def _decode_cols_classes(
    t: DecoderTables, llr_col: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75, exit_check_every: int = 4,
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
    c2v = torch.zeros((t.num_edges, b), dtype=torch.float32, device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    for i in range(iter_count):
        if i > 0 and i % exit_check_every == 0 and bool(conv.all()):
            break
        # --- variable nodes per column class on the column-flat view ---
        c2v_col = c2v[t.perm_cf_c2r]  # [E, B]
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
            new, ss_blk = _cn(pe - ce.reshape(d, n, b), cn_rule, alpha, llr_clip)
            news.append(new.reshape(d * n, b))
            sss.append(ss_blk)
        c2v = torch.cat(news)
        ss = torch.where(conv[None, :], ss, torch.cat(sss))
    cc_orig = cc_hat[t.col_unsort]  # undo the degree sort
    uu_hat = cc_orig[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_orig, conv, iters, ss[t.row_unsort])


def _batch_major(res: DecodeResult) -> DecodeResult:
    return DecodeResult(
        res.uu_hat.T, res.cc_hat.T, res.converged, res.iters, res.soft_syndrome.T
    )


def flooding_decode_em(
    t: DecoderTables, chan_llr: torch.Tensor, iter_count: int, cn_rule: str = "sumprod",
    alpha: float = 0.75,
) -> DecodeResult:
    """Flooding BP decode of [B, tx_len] channel LLRs log(P0/P1).

    Same result semantics as ``kmldpc_tpu.decoder.bp_em.flooding_decode_em``
    (float32 messages); batch-major outputs over all ``num_col`` columns.
    """
    llr_col = _insert_punct(t, chan_llr.to(torch.float32).T.contiguous())
    return _batch_major(_decode_cols(t, llr_col, iter_count, cn_rule, alpha))


def flooding_decode_two_phase(
    t: DecoderTables,
    chan_llr: torch.Tensor,
    iter_count: int,
    phase1_iters: int = 3,
    tile: int = 128,
    cn_rule: str = "sumprod",
    alpha: float = 0.75,
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
        return flooding_decode_em(t, chan_llr, iter_count, cn_rule, alpha)
    llr_col = _insert_punct(t, chan_llr.to(torch.float32).T.contiguous())
    p1 = _decode_cols(t, llr_col, phase1_iters, cn_rule, alpha)
    # unconverged (0) first; argsort does not take bool on every device
    order = torch.argsort(p1.converged.to(torch.int32), stable=True)
    n_unconv = int((~p1.converged).sum())
    cc_hat, conv, iters, ss = p1.cc_hat, p1.converged, p1.iters, p1.soft_syndrome
    k = 0
    while k * tile < n_unconv:
        start = min(k * tile, b - tile)
        idx = order[start : start + tile]
        sub = _decode_cols(t, llr_col[:, idx], iter_count, cn_rule, alpha)
        cc_hat[:, idx] = sub.cc_hat
        conv[idx] = sub.converged
        iters[idx] = sub.iters
        ss[:, idx] = sub.soft_syndrome
        k += 1
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return _batch_major(DecodeResult(uu_hat, cc_hat, conv, iters, ss))
