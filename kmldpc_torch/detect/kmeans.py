"""Blind channel estimation: the re-projected k-means over received symbols
(plain PyTorch port of ``kmldpc_tpu/detect/kmeans.py``).

This is the CPU path and the reference that kernel K1
(``csrc/kmeans.cu``, wrapped by ``kmeans_cuda.py``) is held against.  The
clusters are always the constellation scaled by one complex gain ĥ:

    init:  ĥ = y[argmax |y|] / s_init        (first index on ties)
    iter:  assign each y_j to the nearest s_k·ĥ (first minimum on ties)
           c_k = mean of the symbols assigned to k (count-0 safe)
           ĥ <- c_anchor / s_anchor          (empty anchor keeps ĥ)

``anchor="max"`` anchors on the max-|centroid| nonempty cluster divided by
its own point and starts from the max-modulus point; ``anchor="first"``
is the reference's de-facto cluster 0 / s_0.  The fixed ``iters`` budget
(20) is always run.

Per-cluster sums are accumulated in float64 and rounded to float32: the
sum is then independent of the reduction order up to a vanishing chance,
so this version and the kernel (whose order differs) agree bitwise in
practice, and a Monte-Carlo replay gives the same bits on every device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.modem import ModemTables


def init_index(tables: ModemTables, anchor: str) -> int:
    """Index of the constellation point the init divides by."""
    if anchor not in ("max", "first"):
        raise ValueError(f"anchor must be 'max' or 'first', got {anchor!r}")
    if anchor == "first":
        return 0
    sr = tables.points_re.cpu().numpy()
    si = tables.points_im.cpu().numpy()
    return int(np.argmax(sr * sr + si * si))


def expand_candidates(h_r: torch.Tensor, h_i: torch.Tensor):
    """The 4 phase-ambiguity candidates ĥ·{1, j, -1, -j} as [B, 4] planes."""
    h4_r = torch.stack([h_r, -h_i, -h_r, h_i], dim=1)
    h4_i = torch.stack([h_i, h_r, -h_i, -h_r], dim=1)
    return h4_r, h4_i


def blind_estimate(
    yr: torch.Tensor, yi: torch.Tensor, tables: ModemTables,
    iters: int = 20, anchor: str = "max",
) -> tuple[torch.Tensor, torch.Tensor]:
    """ĥ per row of yr/yi [B, Nsym] f32; returns (h_r, h_i), each [B]."""
    k_init = init_index(tables, anchor)
    sr, si = tables.points_re, tables.points_im
    m = sr.shape[0]
    b = yr.shape[0]
    rows = torch.arange(b, device=yr.device)
    sI_r, sI_i = sr[k_init], si[k_init]
    sI_norm = sI_r * sI_r + sI_i * sI_i
    jstar = torch.argmax(yr * yr + yi * yi, dim=1)  # first index on ties
    ymax_r, ymax_i = yr[rows, jstar], yi[rows, jstar]
    h_r = (ymax_r * sI_r + ymax_i * sI_i) / sI_norm
    h_i = (ymax_i * sI_r - ymax_r * sI_i) / sI_norm
    yr64, yi64 = yr.to(torch.float64)[:, :, None], yi.to(torch.float64)[:, :, None]
    points = torch.arange(m, device=yr.device)
    for _ in range(iters):
        cr = h_r[:, None] * sr[None, :] - h_i[:, None] * si[None, :]  # [B, M]
        ci = h_r[:, None] * si[None, :] + h_i[:, None] * sr[None, :]
        dre = yr[:, :, None] - cr[:, None, :]
        dim = yi[:, :, None] - ci[:, None, :]
        assign = torch.argmin(dre * dre + dim * dim, dim=-1)  # [B, Nsym]
        onehot = assign[:, :, None] == points  # [B, Nsym, M]
        counts = onehot.sum(dim=1).to(torch.float32)
        sum_r = torch.where(onehot, yr64, 0.0).sum(dim=1).to(torch.float32)
        sum_i = torch.where(onehot, yi64, 0.0).sum(dim=1).to(torch.float32)
        safe = torch.clamp(counts, min=1.0)
        cent_r = sum_r / safe
        cent_i = sum_i / safe
        if anchor == "first":
            k = torch.zeros(b, dtype=torch.int64, device=yr.device)
        else:
            cmag = torch.where(counts > 0, cent_r * cent_r + cent_i * cent_i, -1.0)
            k = torch.argmax(cmag, dim=1)  # first index on ties
        sk_r, sk_i = sr[k], si[k]
        a_r, a_i, a_cnt = cent_r[rows, k], cent_i[rows, k], counts[rows, k]
        sk_norm = sk_r * sk_r + sk_i * sk_i
        new_r = (a_r * sk_r + a_i * sk_i) / sk_norm
        new_i = (a_i * sk_r - a_r * sk_i) / sk_norm
        keep = a_cnt > 0
        h_r = torch.where(keep, new_r, h_r)
        h_i = torch.where(keep, new_i, h_i)
    return h_r, h_i


def make_blind_estimator(
    tables: ModemTables, iters: int = 20, anchor: str = "max"
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Returns the plain ``estimate(yr, yi) -> (h4_r, h4_i)``, [B, 4] each."""
    init_index(tables, anchor)  # validates the anchor

    def estimate(yr: torch.Tensor, yi: torch.Tensor):
        return expand_candidates(*blind_estimate(yr, yi, tables, iters, anchor))

    return estimate


def add_diagnostics(estimate: Callable, tables: ModemTables) -> Callable:
    """Wrap a blind estimator with the k-means inspection surface
    (``KMeans::{clusters, idx}`` after ``Run``, dumped by
    ``KMeans::DumpToMat``).

    The clusters are the constellation scaled by the final ĥ (candidate 0),
    and the assignments one first-minimum pass against them, so both follow
    from the estimate; the wrapper works over K1 and the plain version
    alike.  Returns ``estimate_diag(yr, yi) -> (h4_r, h4_i, cl_r, cl_i,
    idx)`` with ``cl_*`` [B, M] and ``idx`` [B, Nsym] int32.
    """
    sr, si = tables.points_re, tables.points_im

    def estimate_diag(yr: torch.Tensor, yi: torch.Tensor):
        h4_r, h4_i = estimate(yr, yi)
        h_r, h_i = h4_r[:, 0], h4_i[:, 0]
        cl_r = h_r[:, None] * sr[None, :] - h_i[:, None] * si[None, :]
        cl_i = h_r[:, None] * si[None, :] + h_i[:, None] * sr[None, :]
        dre = yr[:, :, None] - cl_r[:, None, :]
        dim = yi[:, :, None] - cl_i[:, None, :]
        idx = torch.argmin(dre * dre + dim * dim, dim=-1).to(torch.int32)
        return h4_r, h4_i, cl_r, cl_i, idx

    return estimate_diag
