"""Wrapper of kernel K1 (``csrc/kmeans.cu``), the CUDA port of the Pallas
k-means kernel ``kmldpc_tpu/detect/kmeans_pallas.py::_kmeans_kernel``.

``kmeans_estimate`` takes yr/yi [B, Nsym] float32.  For tensors on the CPU
it runs the plain version (``detect/kmeans.py``).  For CUDA tensors it
launches K1 on the current stream or raises; it never falls back.  Each
launch adds one to ``kmeans_estimate.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from .._build import load_library
from ..ops.modem import ModemTables
from .kmeans import blind_estimate, expand_candidates, init_index

KERNEL_POINTS = (4, 16, 64)  # constellation sizes K1 is instantiated for


def _check_rows(yr: torch.Tensor, yi: torch.Tensor) -> None:
    if yr.device != yi.device:
        raise ValueError(f"yr on {yr.device} but yi on {yi.device}")
    if yr.dtype != torch.float32 or yi.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 rows, got {yr.dtype} / {yi.dtype}")
    if yr.dim() != 2 or yr.shape != yi.shape or yr.shape[0] < 1 or yr.shape[1] < 1:
        raise ValueError(f"K1 takes yr/yi of one shape [B>0, Nsym>0], got "
                         f"{tuple(yr.shape)} / {tuple(yi.shape)}")
    if not (yr.is_contiguous() and yi.is_contiguous()):
        raise ValueError("K1 takes contiguous yr/yi")


def kmeans_estimate(
    yr: torch.Tensor, yi: torch.Tensor, tables: ModemTables,
    iters: int = 20, anchor: str = "max",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4 ĥ candidates per row, (h4_r, h4_i) each [B, 4] float32."""
    _check_rows(yr, yi)
    k_init = init_index(tables, anchor)
    if yr.device.type == "cpu":
        return expand_candidates(*blind_estimate(yr, yi, tables, iters, anchor))
    if yr.device.type != "cuda":
        raise ValueError(f"K1 runs on cuda or cpu tensors, got {yr.device}")
    m = tables.num_points
    if m not in KERNEL_POINTS:
        raise ValueError(f"K1 is built for {KERNEL_POINTS} points, not {m}")
    b, nsym = yr.shape
    sr = np.ascontiguousarray(tables.points_re.cpu().numpy(), dtype=np.float32)
    si = np.ascontiguousarray(tables.points_im.cpu().numpy(), dtype=np.float32)
    lib = load_library()
    with torch.cuda.device(yr.device):
        h4_r = torch.empty((b, 4), dtype=torch.float32, device=yr.device)
        h4_i = torch.empty((b, 4), dtype=torch.float32, device=yr.device)
        err = lib.kmldpc_kmeans(
            yr.data_ptr(), yi.data_ptr(), h4_r.data_ptr(), h4_i.data_ptr(),
            b, nsym,
            sr.ctypes.data_as(ctypes.c_void_p), si.ctypes.data_as(ctypes.c_void_p),
            m, iters, k_init, int(anchor == "first"),
            torch.cuda.current_stream(yr.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 (kmldpc_kmeans) launch failed: cudaError_t {err}")
    kmeans_estimate.launches += 1
    return h4_r, h4_i


kmeans_estimate.launches = 0  # type: ignore[attr-defined]


def make_blind_estimator_cuda(
    tables: ModemTables, iters: int = 20, anchor: str = "max"
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Counterpart of ``make_blind_estimator_pallas``: K1 on CUDA tensors."""
    init_index(tables, anchor)  # validates the anchor

    def estimate(yr: torch.Tensor, yi: torch.Tensor):
        return kmeans_estimate(yr, yi, tables, iters, anchor)

    return estimate
