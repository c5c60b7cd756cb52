"""Phase-ambiguity resolution over the 4 ĥ candidates (port of
``kmldpc_tpu/detect/metric.py``; reference ``KmCodec::GetMetrics``,
kmcodec.cc:105-163).

For each candidate the block is soft-demapped with uniform priors, then:

* soft metric (``metric_type = true``): ``metric_iter`` flooding iterations,
  metric = Σ_rows log(soft syndrome);
* hard metric, 5G code: ``metric_iter`` flooding iterations, then the
  number of failed parity checks of the decoder's hard codeword;
* hard metric, classic code: no decoding; the demapped P(bit=0) is
  hard-decided with the reference's inverted convention (``P0 > 0.5 -> 1``,
  kmcodec.cc:109-114) and the metric is the number of failed checks.

The smallest |metric| wins, ties to the first minimum (``torch.argmin``
returns the first minimal index).  For QPSK with even-degree rows the ĥ
and -ĥ candidates tie exactly, so the tie rule decides.  The candidates
are folded into the batch (metric decodes are one [4B] decoder call), and
the winner's LLRs are reused for the final decode.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..code.ldpc import LDPCCode
from ..decoder.bp import DecoderTables, count_failed_checks
from ..decoder.bp_em import flooding_decode_em
from ..io.constellation import Constellation
from ..ops.modem import ModemTables, make_soft_demapper


def complement_closed(code: LDPCCode, c: Constellation) -> bool:
    """True iff the ĥ and -ĥ metric candidates tie exactly in float32.

    Negating every point must land on the point with the complemented
    label (so demapping under -ĥ complements every bit decision), every
    check row must have even degree (so the complement of a codeword is a
    codeword), and the table may hold at most 4 points (each demap bit
    class then sums 2 terms, commutative-exact in float32).  Then
    candidates 2 and 3 tie 0 and 1 exactly and the first-minimum rule
    never picks them, which is what makes ``prune_complement`` safe.  The
    shipped 2bits_QPSK table qualifies; 16QAM Gray, 4PSK and the 5G codes
    (odd-degree rows) do not.
    """
    if c.num_points > 4:
        return False
    pts = np.asarray(c.points)
    bits = np.asarray(c.bits)
    for k in range(c.num_points):
        d = np.abs(pts + pts[k])  # nearest point to -pts[k]
        j = int(np.argmin(d))
        if d[j] > 1e-9 or not np.array_equal(bits[j], 1 - bits[k]):
            return False
    row_deg = np.asarray(code.row_mask).sum(axis=1)
    return bool((row_deg % 2 == 0).all())


def make_ambiguity_selector(
    code: LDPCCode,
    tables: ModemTables,
    metric_type: bool,
    metric_iter: int,
    decode: Callable | None = None,
    prune_complement: bool = False,
) -> Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``select(t, yr, yi, h4_r, h4_i, var) -> (hr, hi, metrics, llr_best)``.

    ``t``: the code's DecoderTables; yr/yi [B, Nsym]; h4_* [B, 4].  Outputs:
    the winning candidate per codeword ([B] each), the |metric| table
    [B, 4] float32, and the winner's channel LLRs [B, Nsym*m].

    ``decode(t, chan_llr, metric_iter) -> DecodeResult`` overrides the
    metric decoder (default: single-phase flooding sum-product, as the
    reference decodes its metrics).  ``prune_complement`` skips candidates
    2 and 3, which the caller has shown tie 0 and 1 (:func:`complement_closed`),
    and reports the tied values in their columns.
    """
    demap = make_soft_demapper(tables)
    needs_decode = metric_type or code.is_5g
    if decode is None:
        decode = flooding_decode_em
    nc = 2 if prune_complement else 4

    def select(t: DecoderTables, yr, yi, h4_r, h4_i, var):
        b, nsym = yr.shape
        yrn = yr[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
        yin = yi[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
        h4_r, h4_i = h4_r[:, :nc], h4_i[:, :nc]
        bit_p0, chan_llr = demap(yrn, yin, h4_r.reshape(b * nc), h4_i.reshape(b * nc), var)
        if not needs_decode:
            rr = (bit_p0 > 0.5).to(torch.int8)  # NOTE: P(bit=0) > 0.5 -> 1
            metric = count_failed_checks(t, rr).to(torch.float32)
        else:
            res = decode(t, chan_llr, metric_iter)
            if metric_type:
                metric = torch.log(res.soft_syndrome).sum(dim=-1)  # kmcodec.cc:147-155
            else:
                metric = count_failed_checks(t, res.cc_hat).to(torch.float32)
        metrics = metric.abs().reshape(b, nc)  # abs: kmcodec.cc:140
        best = torch.argmin(metrics, dim=1)  # first minimum
        hr = h4_r.gather(1, best[:, None])[:, 0]
        hi = h4_i.gather(1, best[:, None])[:, 0]
        rows = torch.arange(b, device=yr.device) * nc + best
        if prune_complement:
            metrics = torch.cat([metrics, metrics], dim=1)
        return hr, hi, metrics, chan_llr[rows]

    return select
