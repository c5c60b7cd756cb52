"""Phase-ambiguity resolution over the 4 ĥ candidates, classic hard metric
(port of ``kmldpc_tpu/detect/metric.py``).

For each candidate the block is soft-demapped with uniform priors, the
demapped P(bit=0) is hard-decided with the reference's inverted convention
(``P0 > 0.5 -> 1``, kmcodec.cc:109-114) and the metric is the number of
failed parity checks; no decoding.  The smallest metric wins, ties to the
first minimum (``torch.argmin`` returns the first minimal index).  For QPSK
with even-degree rows the ĥ and -ĥ candidates tie exactly, so the tie rule
decides.  The 4 candidates are folded into the batch, and the winner's
LLRs are reused for the final decode.
"""

from __future__ import annotations

from typing import Callable

import torch

from kmldpc_tpu.code.ldpc import LDPCCode

from ..decoder.bp import DecoderTables, count_failed_checks
from ..ops.modem import ModemTables, make_soft_demapper


def make_ambiguity_selector(
    code: LDPCCode, tables: ModemTables, metric_type: bool, metric_iter: int
) -> Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``select(t, yr, yi, h4_r, h4_i, var) -> (hr, hi, metrics, llr_best)``.

    ``t``: the code's DecoderTables; yr/yi [B, Nsym]; h4_* [B, 4].  Outputs:
    the winning candidate per codeword ([B] each), the |metric| table
    [B, 4] float32, and the winner's channel LLRs [B, Nsym*m].
    """
    if metric_type:
        raise NotImplementedError(
            "metric_type = true (soft metric) is not ported yet "
            "(ROADMAP.md Queue 1, 'soft metric')"
        )
    if code.is_5g:
        raise NotImplementedError(
            "the 5G hard metric (decode, then count) is not ported yet "
            "(ROADMAP.md Queue 1, 'degree-class core and 5G')"
        )
    del metric_iter  # the classic hard metric decodes nothing
    demap = make_soft_demapper(tables)
    nc = 4

    def select(t: DecoderTables, yr, yi, h4_r, h4_i, var):
        b, nsym = yr.shape
        yrn = yr[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
        yin = yi[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
        bit_p0, chan_llr = demap(yrn, yin, h4_r.reshape(b * nc), h4_i.reshape(b * nc), var)
        rr = (bit_p0 > 0.5).to(torch.int8)  # NOTE: P(bit=0) > 0.5 -> 1
        metrics = count_failed_checks(t, rr).to(torch.float32).abs().reshape(b, nc)
        best = torch.argmin(metrics, dim=1)  # first minimum
        hr = h4_r.gather(1, best[:, None])[:, 0]
        hi = h4_i.gather(1, best[:, None])[:, 0]
        rows = torch.arange(b, device=yr.device) * nc + best
        return hr, hi, metrics, chan_llr[rows]

    return select
