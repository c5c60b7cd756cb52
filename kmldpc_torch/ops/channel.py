"""One-tap fading + AWGN channel: y = h·x + (σ/√2)(n_r + j n_i)
(port of ``kmldpc_tpu/ops/channel.py``).

h ~ CN(0,1) constant per codeword (Normal·√0.5 per component), noise std
σ/√2 per component, var = σ² = 10^(-SNR/10) with no rate normalisation.
``fading=False`` pins h = 1 exactly.
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
