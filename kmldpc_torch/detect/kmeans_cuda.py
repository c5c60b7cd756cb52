"""Wrapper of kernel K1 (``csrc/kmeans.cu``), the CUDA port of the Pallas
k-means kernel ``kmldpc_tpu/detect/kmeans_pallas.py::_kmeans_kernel``.

``make_blind_estimator_cuda`` reads the constellation to the host once and
returns ``estimate(yr, yi)`` for yr/yi [B, Nsym] float32.  For tensors on
the CPU it runs the plain version (``detect/kmeans.py``).  For CUDA tensors
it launches K1 on the current stream or raises; it never falls back, and a
launch makes no copy from the device and no synchronisation.  Each launch
adds one to ``kmeans_estimate.launches``.
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


def launch_k1(
    yr: torch.Tensor, yi: torch.Tensor, points_re: np.ndarray, points_im: np.ndarray,
    iters: int, k_init: int, anchor_first: bool, early_exit: bool = False,
    rounds: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K1 on checked CUDA rows; host points [M] float32.

    ``rounds`` ([B] int32 on the rows' device), if given, receives the
    assignment passes each row ran.  Returns (h4_r, h4_i), each [B, 4].
    """
    m = points_re.shape[0]
    if m not in KERNEL_POINTS:
        raise ValueError(f"K1 is built for {KERNEL_POINTS} points, not {m}")
    b, nsym = yr.shape
    if rounds is not None and (rounds.shape != (b,) or rounds.dtype != torch.int32
                               or rounds.device != yr.device):
        raise ValueError("rounds must be a [B] int32 tensor on the rows' device")
    lib = load_library()
    with torch.cuda.device(yr.device):
        h4_r = torch.empty((b, 4), dtype=torch.float32, device=yr.device)
        h4_i = torch.empty((b, 4), dtype=torch.float32, device=yr.device)
        err = lib.kmldpc_kmeans(
            yr.data_ptr(), yi.data_ptr(), h4_r.data_ptr(), h4_i.data_ptr(),
            b, nsym,
            points_re.ctypes.data_as(ctypes.c_void_p),
            points_im.ctypes.data_as(ctypes.c_void_p),
            m, iters, k_init, int(anchor_first), int(early_exit),
            None if rounds is None else rounds.data_ptr(),
            torch.cuda.current_stream(yr.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"K1 (kmldpc_kmeans) launch failed: cudaError_t {err} "
            f"(B={b}, Nsym={nsym}, M={m})"
        )
    kmeans_estimate.launches += 1
    return h4_r, h4_i


def make_blind_estimator_cuda(
    tables: ModemTables, iters: int = 20, anchor: str = "max", early_exit: bool = False,
) -> Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Counterpart of ``make_blind_estimator_pallas``: K1 on CUDA tensors.

    ``early_exit`` stops each row once its assignment repeats, bitwise the
    fixed loop (off by default, as in the JAX package).
    """
    k_init = init_index(tables, anchor)  # validates the anchor
    points_re = np.ascontiguousarray(tables.points_re.cpu().numpy(), dtype=np.float32)
    points_im = np.ascontiguousarray(tables.points_im.cpu().numpy(), dtype=np.float32)

    def estimate(yr: torch.Tensor, yi: torch.Tensor):
        _check_rows(yr, yi)
        if yr.device.type == "cpu":
            return expand_candidates(*blind_estimate(yr, yi, tables, iters, anchor))
        if yr.device.type != "cuda":
            raise ValueError(f"K1 runs on cuda or cpu tensors, got {yr.device}")
        return launch_k1(yr, yi, points_re, points_im, iters, k_init, anchor == "first",
                         early_exit)

    return estimate


def kmeans_estimate(
    yr: torch.Tensor, yi: torch.Tensor, tables: ModemTables,
    iters: int = 20, anchor: str = "max", early_exit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The 4 ĥ candidates per row, (h4_r, h4_i) each [B, 4] float32.

    One-off form of ``make_blind_estimator_cuda``: it reads the
    constellation to the host on every call, so a loop builds the
    estimator once instead.
    """
    return make_blind_estimator_cuda(tables, iters, anchor, early_exit)(yr, yi)


kmeans_estimate.launches = 0  # type: ignore[attr-defined]
