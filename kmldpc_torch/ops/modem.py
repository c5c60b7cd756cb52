"""Constellation mapping and soft demapping, batched (port of
``kmldpc_tpu/ops/modem.py``).

Complex numbers are carried as separate real and imaginary float32 planes,
the layout of the JAX package's public functions.  The demapper keeps the
reference's two stages (max-normalised symbol likelihoods clipped into
[1e-12, 1-1e-12], then marginalisation to P(bit=0) with uniform priors)
and returns both P(bit=0) and the LLR ``log(p0) - log(p1)``.

The bit marginalisation is a masked sum over the M points in float32
elementwise arithmetic, not a matmul: a TF32 product on the card would
keep only about three digits of p0 and p1.  ``make_soft_demapper``, the
chain's, runs that eager version on the CPU and kernel K4
(``csrc/demap.cu``, wrapper ``ops/demap_cuda.py``) on a card.  The
prior-in demapper (``make_prior_demapper``) and the per-segment one
(``make_partition_demapper``) complete the reference's demapping API; the
simulation chain uses neither, and both stay eager.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import constants
from ..io.constellation import Constellation
from .demap_cuda import K4Table, launch_k4


@dataclasses.dataclass(frozen=True)
class ModemTables:
    """Constellation tables on one device."""

    bits_per_symbol: int
    points_re: torch.Tensor  # [M] f32
    points_im: torch.Tensor  # [M] f32
    bit0_mask: torch.Tensor  # [M, m] f32 — 1 where bit j of symbol k is 0
    pack_weights: torch.Tensor  # [m] f32 — MSB-first powers of two

    @property
    def num_points(self) -> int:
        return int(self.points_re.shape[0])

    @property
    def device(self) -> torch.device:
        return self.points_re.device

    @staticmethod
    def from_constellation(
        c: Constellation, device: torch.device | str = "cpu"
    ) -> "ModemTables":
        m = c.bits_per_symbol
        f32 = dict(dtype=torch.float32, device=device)
        return ModemTables(
            bits_per_symbol=m,
            points_re=torch.tensor(c.points.real.astype(np.float32), **f32),
            points_im=torch.tensor(c.points.imag.astype(np.float32), **f32),
            bit0_mask=torch.tensor(c.bit0_mask().astype(np.float32), **f32),
            pack_weights=torch.tensor(
                (2.0 ** np.arange(m - 1, -1, -1)).astype(np.float32), **f32
            ),
        )


def make_mapper(
    tables: ModemTables,
) -> Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``map_bits(cc_tx) -> (xr, xi)``; cc_tx: [B, n_tx] 0/1 bits."""
    m = tables.bits_per_symbol
    shifts = torch.arange(m - 1, -1, -1, device=tables.device)

    def map_bits(cc_tx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, n = cc_tx.shape
        groups = cc_tx.reshape(b, n // m, m).to(torch.int64)
        idx = (groups << shifts).sum(dim=-1)  # MSB-first symbol index
        return tables.points_re[idx], tables.points_im[idx]

    return map_bits


def _symbol_probs(tables: ModemTables, yr, yi, hr, hi, var) -> torch.Tensor:
    """Max-normalised symbol likelihoods clipped into [1e-12, 1-1e-12]:
    [B, Nsym, M] (modemlinearsystem.cc:51-77)."""
    pr, pi = tables.points_re, tables.points_im
    var = torch.as_tensor(var, dtype=torch.float32, device=yr.device)
    hs_re = hr[:, None] * pr[None, :] - hi[:, None] * pi[None, :]
    hs_im = hr[:, None] * pi[None, :] + hi[:, None] * pr[None, :]
    dre = yr[:, :, None] - hs_re[:, None, :]
    dim = yi[:, :, None] - hs_im[:, None, :]
    logits = -(dre * dre + dim * dim) / var
    logits = logits - logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits)
    p = p / p.sum(dim=-1, keepdim=True)
    return p.clamp(constants.SMALLEST_PROB, 1.0 - constants.SMALLEST_PROB)


def make_plain_soft_demapper(
    tables: ModemTables,
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``demap(yr, yi, hr, hi, var) -> (bit_p0, chan_llr)``, in
    eager PyTorch: the plain version of kernel K4.

    yr/yi: [B, Nsym]; hr/hi: [B] (one gain per codeword) or [B, nc] (nc
    candidates per codeword, demapped as the rows b * nc + c); var: the
    noise variance 10^(-SNR/10) as a float or 0-d tensor.  Outputs are
    [B * nc, Nsym*m]: P(bit=0) clipped to [1e-12, 1-1e-12] and the LLR
    clipped to +-LLR_CLIP.
    """
    m = tables.bits_per_symbol
    clip_lo = constants.SMALLEST_PROB
    clip_hi = 1.0 - constants.SMALLEST_PROB
    mask0 = tables.bit0_mask  # [M, m]
    mask1 = 1.0 - mask0

    def demap(yr, yi, hr, hi, var):
        b, nsym = yr.shape
        if hr.dim() == 2:  # fold the candidates into the batch
            nc = hr.shape[1]
            yr = yr[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
            yi = yi[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym)
            hr, hi, b = hr.reshape(b * nc), hi.reshape(b * nc), b * nc
        # the reference clips symbol probabilities before marginalising
        p = _symbol_probs(tables, yr, yi, hr, hi, var)
        # bit marginalisation as masked sums over the M points: [B, Nsym, m]
        p0 = (p[..., :, None] * mask0).sum(dim=-2)
        p1 = (p[..., :, None] * mask1).sum(dim=-2)
        bit_p0 = (p0 / (p0 + p1)).clamp(clip_lo, clip_hi).reshape(b, nsym * m)
        # log(p0) - log(p1): 1 - 1e-12 is not representable in f32, so
        # log1p(-p0) would give -inf for confident bits
        chan_llr = (torch.log(p0) - torch.log(p1)).reshape(b, nsym * m).clamp(
            -constants.LLR_CLIP, constants.LLR_CLIP
        )
        return bit_p0, chan_llr

    return demap


def k4_engages(*tensors: torch.Tensor) -> bool:
    """Whether the soft demapper launches kernel K4 on these operands: for
    any of them off the CPU.  K4 then runs, or raises on anything but
    float32 tensors on one card."""
    return any(t.device.type != "cpu" for t in tensors)


def make_soft_demapper(tables: ModemTables) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``demap(yr, yi, hr, hi, var) -> (bit_p0, chan_llr)``, the
    signature and outputs of :func:`make_plain_soft_demapper`.

    CPU operands run the plain version; CUDA operands launch kernel K4
    (``ops/demap_cuda.py``) or raise, without a fallback.  The tables are
    read to the host once, here.
    """
    plain = make_plain_soft_demapper(tables)
    k4_table = K4Table.read(tables.points_re, tables.points_im, tables.bit0_mask)

    def demap(yr, yi, hr, hi, var):
        if k4_engages(yr, yi, hr, hi):
            return launch_k4(k4_table, yr, yi, hr, hi, var)
        return plain(yr, yi, hr, hi, var)

    return demap


def make_prior_demapper(tables: ModemTables) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """Prior-in / extrinsic-out soft demapper, the whole ``Modem::DeMapping``
    (modem.cc:23-79), for iterative demodulation.

    Returns ``demap(yr, yi, hr, hi, var, bit_p0_in) -> (bit_p0_out,
    ext_llr)``; ``bit_p0_in`` [B, Nsym*m] is the decoder's extrinsic
    P(bit=0).  The symbol prior is the product of its bits' priors
    (modem.cc:34-45), the posterior prior x likelihood normalised
    (:47-57), and the output the bit posterior with the prior divided back
    out (:59-73), clipped.  With uniform priors this is
    :func:`make_plain_soft_demapper`.  1 - 1e-12 is not a float32, so the prior
    and its complement are clipped separately.  The log-prior and the bit
    marginals are masked sums over the bits and the points, as in the
    soft demapper.
    """
    m = tables.bits_per_symbol
    clip_lo = constants.SMALLEST_PROB
    clip_hi = 1.0 - constants.SMALLEST_PROB
    mask0 = tables.bit0_mask  # [M, m]
    mask1 = 1.0 - mask0

    def demap(yr, yi, hr, hi, var, bit_p0_in):
        b, nsym = yr.shape
        p = _symbol_probs(tables, yr, yi, hr, hi, var)
        pin = bit_p0_in.reshape(b, nsym, m)
        pin0 = pin.clamp(clip_lo, clip_hi)
        pin1 = (1.0 - pin).clamp(clip_lo, clip_hi)
        # symbol log-prior: [B, Nsym, M]
        log_prior = (torch.log(pin0)[..., None, :] * mask0).sum(dim=-1) + (
            torch.log(pin1)[..., None, :] * mask1).sum(dim=-1)
        post = p * torch.exp(log_prior - log_prior.amax(dim=-1, keepdim=True))
        post = post / post.sum(dim=-1, keepdim=True)
        p0 = (post[..., :, None] * mask0).sum(dim=-2)
        p1 = (post[..., :, None] * mask1).sum(dim=-2)
        e0 = p0 / pin0  # extrinsic: divide the prior back out
        e1 = p1 / pin1
        bit_p0_out = (e0 / (e0 + e1)).clamp(clip_lo, clip_hi).reshape(b, nsym * m)
        ext_llr = (torch.log(e0) - torch.log(e1)).reshape(b, nsym * m).clamp(
            -constants.LLR_CLIP, constants.LLR_CLIP
        )
        return bit_p0_out, ext_llr

    return demap


def make_partition_demapper(tables: ModemTables, num_parts: int):
    """Soft demapper for one gain per segment (``thetaList``,
    modemlinearsystem.cc:80-90): symbol j of segment p is demapped against
    h_p.  hr/hi: [B, num_parts].  With ``num_parts == 1`` this is
    :func:`make_plain_soft_demapper`.
    """
    demap = make_plain_soft_demapper(tables)
    m = tables.bits_per_symbol

    def demap_parts(yr, yi, hr, hi, var):
        b, nsym = yr.shape
        if nsym % num_parts != 0:
            raise ValueError(f"{nsym} symbols not divisible into {num_parts} parts")
        seg = nsym // num_parts
        # fold the segments into the batch: [B, P, seg] -> [B*P, seg]
        p0, llr = demap(yr.reshape(b * num_parts, seg), yi.reshape(b * num_parts, seg),
                        hr.reshape(b * num_parts), hi.reshape(b * num_parts), var)
        return p0.reshape(b, nsym * m), llr.reshape(b, nsym * m)

    return demap_parts
