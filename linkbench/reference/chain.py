"""Plain reference of the link: the same draws as a launch, then every step
after them written out directly in one floating-point type (float64 for the
reference; a lower type for the control).

    bits -> systematic encode -> puncture -> map -> y = h x + w
         -> [k-means gain estimate -> 4 candidates -> ambiguity metric]
         -> soft demap -> decode with per-codeword early stop -> counters

The decoder, flooding sum-product, runs its rows for the full budget and
freezes each codeword's outputs (hard word, iteration count, soft
syndrome) at the iteration its hard word first satisfies every check,
which is what the program's two-phase schedule computes per codeword.  Rows are independent, so the
reference runs any subset of a launch's rows, in blocks that fit.  Nothing
here imports the program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .code import Code, Constellation
from .draw import draw

SMALLEST_PROB = 1.0e-12
LLR_CLIP = math.log((1.0 - SMALLEST_PROB) / SMALLEST_PROB)
PHI_ARG_MIN = 1e-6
KMEANS_ITERS = 20
BLOCK_ROWS = 1024  # rows a block of the reference runs at once


@dataclasses.dataclass(frozen=True)
class Link:
    """What a launch needs, on one device, in one floating-point type."""

    code: Code
    const: Constellation
    known_h: bool
    fading: bool
    metric_soft: bool  # soft (sum of log soft syndromes) or hard (failed checks)
    metric_iter: int
    max_iter: int
    batch: int
    subs: int  # sub-chunks a launch
    dtype: torch.dtype
    device: torch.device

    @staticmethod
    def from_tables(cfg: dict, code: Code, const: Constellation, dtype: torch.dtype,
                    device: torch.device | str) -> "Link":
        """``cfg``: the port's config tables of the run, traffic merged in."""
        tpu = cfg.get("tpu", {})
        schedule = tpu.get("schedule", "flooding")
        metric_schedule = tpu.get("metric_schedule", "flooding")
        unsupported = {
            "schedule": schedule != "flooding",
            "metric_schedule": metric_schedule not in ("flooding", "match"),
            "dtype": tpu.get("dtype", "float32") != "float32",
            "metric_prune": tpu.get("metric_prune", False),
            "kmeans_impl": tpu.get("kmeans_impl", "auto") not in ("auto", "pallas", "jax"),
            "histogram": cfg.get("histogram", {}).get("enable", False),
            "ldpc.active": not cfg.get("ldpc", {}).get("active", True),
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"the reference does not model {bad}")
        xc = cfg.get("xcodec", {})
        return Link(
            code=code, const=const,
            known_h=cfg.get("decoder", {}).get("true_h_arg", False),
            fading=tpu.get("fading", True),
            metric_soft=xc.get("metric_type", False),
            metric_iter=xc.get("metric_iter", 5),
            max_iter=cfg.get("ldpc", {}).get("max_iter", 50),
            batch=int(tpu["batch"]), subs=int(tpu["chunks_per_launch"]),
            dtype=dtype, device=torch.device(device),
        )


class Rows(NamedTuple):
    """Outputs for some rows of a launch."""

    uu: torch.Tensor  # [N, K] int8 drawn info bits
    uu_hat: torch.Tensor  # [N, K] int8 decoded info bits
    converged: torch.Tensor  # [N] bool
    iters: torch.Tensor  # [N] int64
    metrics: torch.Tensor | None  # [N, 4] |metric| of each candidate (blind), else None
    soft: torch.Tensor  # [N, R] soft syndrome, frozen at convergence


class Graph:
    """The code's tables as tensors on the link's device."""

    def __init__(self, code: Code, device: torch.device):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.row_cols = t(code.row_cols)
        self.mask = t(code.row_mask)
        self.col_slots = t(code.col_slots)
        self.gen = t(code.parity_gen.astype(np.float64))
        self.code = code


def _phi(x: torch.Tensor) -> torch.Tensor:
    """-log tanh(x/2), piecewise so that both branches stay finite."""
    small = -torch.log(torch.tanh(torch.clamp(x, max=5.0) * 0.5))
    e = torch.exp(-torch.clamp(x, min=5.0))
    return torch.where(x < 5.0, small, torch.log1p(e) - torch.log1p(-e))


def failed_checks(g: Graph, bits: torch.Tensor) -> torch.Tensor:
    """Unsatisfied checks of [N, num_col] 0/1 words."""
    zero = torch.zeros((bits.shape[0], 1), dtype=torch.int64, device=bits.device)
    padded = torch.cat([bits.to(torch.int64), zero], 1)
    return (padded[:, g.row_cols].sum(-1) % 2).sum(-1)


def _to_columns(g: Graph, llr: torch.Tensor) -> torch.Tensor:
    """[N, tx_len] -> [N, num_col]: punctured columns get LLR 0."""
    return torch.cat([llr.new_zeros((llr.shape[0], g.code.punct)), llr], 1)


def flooding_sumprod(g: Graph, llr: torch.Tensor, iters: int):
    """Flooding sum-product (Gallager phi) with per-codeword early stop.
    Returns (cc_hat [N, C] int8, converged, iters, soft syndrome [N, R])."""
    n, dt = llr.shape[0], llr.dtype
    llr = _to_columns(g, llr)
    r, dr = g.mask.shape
    c2v = llr.new_zeros((n, r, dr))
    cc_hat = torch.zeros(llr.shape, dtype=torch.int8, device=llr.device)
    conv = torch.zeros(n, dtype=torch.bool, device=llr.device)
    count = torch.zeros(n, dtype=torch.int64, device=llr.device)
    ss = llr.new_ones((n, r))
    mask = g.mask
    for _ in range(iters):
        flat = torch.cat([c2v.reshape(n, -1), c2v.new_zeros((n, 1))], 1)
        post = llr + flat[:, g.col_slots].sum(-1)
        cc_hat = torch.where(conv[:, None], cc_hat, (post <= 0).to(torch.int8))
        pe = torch.cat([post, post.new_zeros((n, 1))], 1)[:, g.row_cols]  # [N, R, dr]
        ok = (((pe <= 0) & mask).sum(-1) % 2 == 0).all(-1)
        count = count + (~conv).to(torch.int64)
        conv = conv | ok
        v2c = pe - c2v
        sign = torch.where((v2c < 0) & mask, -1.0, 1.0).to(dt)
        ph = _phi(torch.clamp(v2c.abs(), min=PHI_ARG_MIN)) * mask
        phi_sum = ph.sum(-1, keepdim=True)
        sign_prod = sign.prod(-1, keepdim=True)
        excl = torch.clamp(phi_sum - ph, min=SMALLEST_PROB)
        c2v = sign_prod * sign * torch.clamp(_phi(excl), max=LLR_CLIP) * mask
        ss_new = 0.5 * (1.0 + sign_prod[..., 0] * torch.exp(-phi_sum[..., 0]))
        ss = torch.where(conv[:, None], ss, ss_new)
    return cc_hat, conv, count, ss


def kmeans(yr: torch.Tensor, yi: torch.Tensor, const: Constellation, iters: int = KMEANS_ITERS):
    """Re-projected k-means gain estimate ("max" anchor) per row of
    yr/yi [N, Nsym].  Returns (h_r, h_i, passes): passes counts the
    assignment passes until one repeats the one before (at most
    ``iters``), the work an early-exit loop needs."""
    dt, dev = yr.dtype, yr.device
    sr = torch.tensor(const.points.real, dtype=dt, device=dev)
    si = torch.tensor(const.points.imag, dtype=dt, device=dev)
    n = yr.shape[0]
    rows = torch.arange(n, device=dev)
    k0 = int(np.argmax(np.abs(const.points) ** 2))
    j = torch.argmax(yr * yr + yi * yi, dim=1)
    norm = sr[k0] ** 2 + si[k0] ** 2
    hr = (yr[rows, j] * sr[k0] + yi[rows, j] * si[k0]) / norm
    hi = (yi[rows, j] * sr[k0] - yr[rows, j] * si[k0]) / norm
    passes = torch.full((n,), iters, dtype=torch.int64, device=dev)
    settled = torch.zeros(n, dtype=torch.bool, device=dev)
    prev = None
    for it in range(iters):
        cr = hr[:, None] * sr - hi[:, None] * si
        ci = hr[:, None] * si + hi[:, None] * sr
        d = (yr[:, :, None] - cr[:, None]) ** 2 + (yi[:, :, None] - ci[:, None]) ** 2
        assign = d.argmin(-1)
        if prev is not None:
            same = (assign == prev).all(-1) & ~settled
            passes = torch.where(same, it + 1, passes)
            settled |= same
        prev = assign
        onehot = (assign[:, :, None] == torch.arange(sr.shape[0], device=dev)).to(dt)
        cnt = onehot.sum(1)
        cen_r = (onehot * yr[:, :, None]).sum(1) / cnt.clamp(min=1)
        cen_i = (onehot * yi[:, :, None]).sum(1) / cnt.clamp(min=1)
        k = torch.where(cnt > 0, cen_r ** 2 + cen_i ** 2, torch.full_like(cnt, -1)).argmax(1)
        a_r, a_i, keep = cen_r[rows, k], cen_i[rows, k], cnt[rows, k] > 0
        nk = sr[k] ** 2 + si[k] ** 2
        hr = torch.where(keep, (a_r * sr[k] + a_i * si[k]) / nk, hr)
        hi = torch.where(keep, (a_i * sr[k] - a_r * si[k]) / nk, hi)
    return hr, hi, passes


def demap(yr, yi, hr, hi, var: float, const: Constellation):
    """Uniform-prior soft demap: symbol likelihoods normalised to their
    largest, clipped into [1e-12, 1 - 1e-12], marginalised per bit.
    Returns (P(bit = 0), LLR clipped to +-LLR_CLIP), each [N, Nsym*m]."""
    dt, dev = yr.dtype, yr.device
    pr = torch.tensor(const.points.real, dtype=dt, device=dev)
    pi = torch.tensor(const.points.imag, dtype=dt, device=dev)
    zero = torch.tensor(const.bits == 0, device=dev)  # [M, m]
    sr = hr[:, None] * pr - hi[:, None] * pi
    si = hr[:, None] * pi + hi[:, None] * pr
    logit = -((yr[:, :, None] - sr[:, None]) ** 2 + (yi[:, :, None] - si[:, None]) ** 2) / var
    p = torch.exp(logit - logit.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).clamp(SMALLEST_PROB, 1.0 - SMALLEST_PROB)
    p0 = (p[..., None] * zero).sum(-2)
    p1 = (p[..., None] * ~zero).sum(-2)
    n = yr.shape[0]
    bit_p0 = (p0 / (p0 + p1)).clamp(SMALLEST_PROB, 1.0 - SMALLEST_PROB).reshape(n, -1)
    llr = (torch.log(p0) - torch.log(p1)).clamp(-LLR_CLIP, LLR_CLIP).reshape(n, -1)
    return bit_p0, llr


def _select(link: Link, g: Graph, yr, yi, hr, hi, var):
    """The candidate ĥ·{1, j, -1, -j} of smallest |metric| (first on
    ties) and its LLRs."""
    n = yr.shape[0]
    h4r = torch.stack([hr, -hi, -hr, hi], 1).reshape(-1)
    h4i = torch.stack([hi, hr, -hi, -hr], 1).reshape(-1)
    rep = lambda y: y.repeat_interleave(4, 0)  # noqa: E731
    bit_p0, llr = demap(rep(yr), rep(yi), h4r, h4i, var, link.const)
    if not link.metric_soft and not link.code.is_5g:
        # classic hard metric: no decode; P(bit = 0) > 0.5 is read as a one
        metric = failed_checks(g, (bit_p0 > 0.5).to(torch.int8)).to(llr.dtype)
    else:
        cc, _, _, ss = flooding_sumprod(g, llr, link.metric_iter)
        if link.metric_soft:
            metric = torch.log(ss).sum(-1)
        else:
            metric = failed_checks(g, cc).to(llr.dtype)
    table = metric.abs().reshape(n, 4)
    choice = table.argmin(1)
    return table, llr.reshape(n, 4, -1)[torch.arange(n, device=yr.device), choice]


def channel(link: Link, g: Graph, seed: int, snr: float, launch: int, sub: int,
            rows: torch.Tensor | None = None):
    """The draws of one sub-chunk and the channel outputs of ``rows`` of it
    (all rows if None): (info bits, yr, yi, hr, hi, var)."""
    code, const, dt, dev = link.code, link.const, link.dtype, link.device
    m = const.bits_per_symbol
    nsym = code.tx_len // m
    d = draw(seed, snr, launch, sub, link.batch, code.info_bits, nsym, link.fading, dev)
    pick = (lambda x: x) if rows is None else (lambda x: x[rows])  # noqa: E731
    uu, noise = pick(d.uu), pick(d.noise)
    n = uu.shape[0]
    var = 10.0 ** (-0.1 * snr)
    parity = torch.remainder(uu.to(torch.float64) @ g.gen.T, 2.0).to(torch.int8)
    cc = torch.cat([uu, parity] if code.is_5g else [parity, uu], 1)[:, code.punct:]
    weights = torch.tensor([1 << (m - 1 - b) for b in range(m)], device=dev)
    idx = (cc.reshape(n, nsym, m).to(torch.int64) * weights).sum(-1)
    xr = torch.tensor(const.points.real, dtype=dt, device=dev)[idx]
    xi = torch.tensor(const.points.imag, dtype=dt, device=dev)[idx]
    if link.fading:
        h = pick(d.h)
        hr, hi = h[:, 0].to(dt) * math.sqrt(0.5), h[:, 1].to(dt) * math.sqrt(0.5)
    else:
        hr, hi = torch.ones_like(xr[:, 0]), torch.zeros_like(xr[:, 0])
    w = noise.to(dt) * (math.sqrt(var) / math.sqrt(2.0))
    yr = hr[:, None] * xr - hi[:, None] * xi + w[..., 0]
    yi = hr[:, None] * xi + hi[:, None] * xr + w[..., 1]
    return uu, yr, yi, hr, hi, var


def _backend(link: Link, g: Graph, uu, yr, yi, hr, hi, var) -> Rows:
    table = None
    if link.known_h:
        _, llr = demap(yr, yi, hr, hi, var, link.const)
    else:
        er, ei, _ = kmeans(yr, yi, link.const)
        table, llr = _select(link, g, yr, yi, er, ei, var)
    cc_hat, conv, count, ss = flooding_sumprod(g, llr, link.max_iter)
    code = link.code
    uu_hat = cc_hat[:, code.info_start : code.info_start + code.info_bits]
    return Rows(uu, uu_hat, conv, count, table, ss)


def _by_sub(link: Link, rows: torch.Tensor):
    """(sub-chunk, its rows) of a launch's row indices."""
    for sub in range(link.subs):
        mine = rows[(rows >= sub * link.batch) & (rows < (sub + 1) * link.batch)]
        if mine.numel():
            yield sub, mine - sub * link.batch


def run_rows(link: Link, g: Graph, seed: int, snr: float, launch: int,
             rows: torch.Tensor) -> Rows:
    """The reference's outputs for ``rows`` (sorted indices into the
    launch's sub-chunks, in order) of one launch, in blocks of
    ``BLOCK_ROWS``."""
    outs = []
    for sub, mine in _by_sub(link, rows.to(link.device)):
        for block in mine.split(BLOCK_ROWS):
            outs.append(_backend(link, g, *channel(link, g, seed, snr, launch, sub, block)))
    return Rows(*(None if f[0] is None else torch.cat(f) for f in zip(*outs)))


def launch_bits(link: Link, seed: int, snr: float, launch: int) -> torch.Tensor:
    """The info bits of every row of one launch, [subs*B, K] int8."""
    code, m = link.code, link.const.bits_per_symbol
    return torch.cat([
        draw(seed, snr, launch, sub, link.batch, code.info_bits, code.tx_len // m,
             link.fading, link.device).uu
        for sub in range(link.subs)])


def kmeans_passes(link: Link, g: Graph, seed: int, snr: float, launch: int) -> torch.Tensor:
    """Assignment passes each row of one launch needs, in row order."""
    outs = []
    rows = torch.arange(link.subs * link.batch, device=link.device)
    for sub, mine in _by_sub(link, rows):
        for block in mine.split(BLOCK_ROWS * 4):
            _, yr, yi, _, _, _ = channel(link, g, seed, snr, launch, sub, block)
            outs.append(kmeans(yr, yi, link.const)[2])
    return torch.cat(outs)
