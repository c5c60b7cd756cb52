"""One-tap fading + AWGN channel: y = h·x + (σ/√2)(n_r + j n_i)
(port of ``kmldpc_tpu/ops/channel.py``).

h ~ CN(0,1) constant per codeword (Normal·√0.5 per component), noise std
σ/√2 per component, var = σ² = 10^(-SNR/10) with no rate normalisation.
``fading=False`` pins h = 1 exactly.  ``partitioned_fading_awgn_channel``
draws one h per equal segment of the symbols.
"""

from __future__ import annotations

import math

import torch


def fading_awgn_channel(
    gen: torch.Generator,
    xr: torch.Tensor,
    xi: torch.Tensor,
    sigma,
    fading: bool = True,
):
    """xr/xi: [B, Nsym].  Returns (yr, yi, hr, hi) with hr/hi: [B].

    Draws h first, then the noise, both from ``gen``.
    """
    b, nsym = xr.shape
    dev = xr.device
    if fading:
        h = torch.randn((b, 2), generator=gen, device=dev) * math.sqrt(0.5)
        hr, hi = h[:, 0], h[:, 1]
    else:
        hr = torch.ones((b,), dtype=xr.dtype, device=dev)
        hi = torch.zeros((b,), dtype=xr.dtype, device=dev)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    noise = torch.randn((b, nsym, 2), generator=gen, device=dev) * (sigma / math.sqrt(2.0))
    yr = hr[:, None] * xr - hi[:, None] * xi + noise[..., 0]
    yi = hr[:, None] * xi + hi[:, None] * xr + noise[..., 1]
    return yr, yi, hr, hi


def partitioned_fading_awgn_channel(
    gen: torch.Generator,
    xr: torch.Tensor,
    xi: torch.Tensor,
    sigma,
    num_parts: int,
):
    """Channel with its own h ~ CN(0,1) on each of ``num_parts`` equal,
    contiguous segments of the Nsym symbols: the intended semantics of the
    reference's ``PartitionHAWGNSystem`` (modemlinearsystem.cc:41-46, whose
    loop bound is broken for more than one part).

    xr/xi: [B, Nsym].  Returns (yr, yi, hr, hi) with hr/hi: [B, num_parts].
    Draws h first, then the noise, both from ``gen``.
    """
    b, nsym = xr.shape
    if nsym % num_parts != 0:
        raise ValueError(f"{nsym} symbols not divisible into {num_parts} parts")
    seg = nsym // num_parts
    dev = xr.device
    h = torch.randn((b, num_parts, 2), generator=gen, device=dev) * math.sqrt(0.5)
    hr, hi = h[..., 0], h[..., 1]
    hr_sym = hr.repeat_interleave(seg, dim=1)
    hi_sym = hi.repeat_interleave(seg, dim=1)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    noise = torch.randn((b, nsym, 2), generator=gen, device=dev) * (sigma / math.sqrt(2.0))
    yr = hr_sym * xr - hi_sym * xi + noise[..., 0]
    yi = hr_sym * xi + hi_sym * xr + noise[..., 1]
    return yr, yi, hr, hi
