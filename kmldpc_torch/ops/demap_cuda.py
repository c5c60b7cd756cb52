"""Wrapper of kernel K4 (``csrc/demap.cu``): the soft demapper with uniform
priors, every received symbol under each of its codeword's gain candidates,
in registers (at 256 points in three passes over the points, each forming
the likelihoods anew).

K4 replaces no Pallas kernel (the JAX package's demapper runs as XLA).  Its
plain version is ``ops/modem.py::make_plain_soft_demapper``, which the CPU
keeps running; ``modem.make_soft_demapper`` launches K4 for tensors off the
CPU.  :func:`launch_k4` takes CUDA tensors only and raises on anything else,
before it loads the library.  A launch makes no copy from the device and no
synchronisation: a 0-d CUDA ``var`` is read on the device (a float is
copied there first).  It runs inside
the span ``k4``: a kernel launched through ``ctypes`` has no PyTorch operator
around it, and the span is what ties it, on a profiler's timeline, to the
chain label the host is in (``metric`` or ``demap``).  Each launch adds one
to ``launch_k4.launches`` and the rows it demaps to the counter
``demap.fused_rows``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants
from .._build import load_library
from ..utils.trace import count, span

KERNEL_POINTS = (4, 16, 64, 256)  # constellation sizes K4 is instantiated for
KERNEL_CANDIDATES = (1, 2, 4)  # gain candidates a codeword K4 takes


@dataclasses.dataclass(frozen=True)
class K4Table:
    """A constellation as K4 takes it: the points on the host, and why K4
    refuses the table, if it does."""

    points_re: np.ndarray  # [M] float32
    points_im: np.ndarray  # [M] float32
    refusal: str | None

    @staticmethod
    def read(points_re: torch.Tensor, points_im: torch.Tensor,
             bit0_mask: torch.Tensor) -> "K4Table":
        """Reads the tables to the host once (a sync if they are on a card)."""
        re = np.ascontiguousarray(points_re.cpu().numpy(), dtype=np.float32)
        im = np.ascontiguousarray(points_im.cpu().numpy(), dtype=np.float32)
        bits = 1 - bit0_mask.cpu().numpy().astype(np.int64)  # [M, m], MSB first
        m_points, m = bits.shape
        labels = bits @ (1 << np.arange(m - 1, -1, -1))
        refusal = None
        if m_points not in KERNEL_POINTS:
            refusal = (f"K4 is built for {', '.join(map(str, KERNEL_POINTS))}-point "
                       f"constellations, not this {m_points}-point table")
        elif m_points != 1 << m or not np.array_equal(labels, np.arange(m_points)):
            refusal = (f"K4 takes tables whose point k carries the {m}-bit label k; "
                       f"this {m_points}-point table's labels are {labels.tolist()}")
        return K4Table(re, im, refusal)


def _check(table: K4Table, yr, yi, hr, hi, var) -> int:
    """Raises on anything K4 does not take; returns the candidates a codeword."""
    if table.refusal is not None:
        raise ValueError(table.refusal)
    devices = {t.device for t in (yr, yi, hr, hi)}
    if isinstance(var, torch.Tensor) and var.device.type != "cpu":
        devices.add(var.device)
    if len(devices) != 1:
        raise ValueError(f"K4 takes tensors on one device, got {sorted(map(str, devices))}")
    if yr.device.type != "cuda":
        raise ValueError(f"K4 runs on cuda tensors, got {yr.device}")
    if any(t.dtype != torch.float32 for t in (yr, yi, hr, hi)):
        raise TypeError(f"K4 takes float32 symbols and gains, got "
                        f"{[str(t.dtype) for t in (yr, yi, hr, hi)]}")
    if yr.dim() != 2 or yr.shape != yi.shape or yr.shape[0] < 1 or yr.shape[1] < 1:
        raise ValueError(f"K4 takes yr/yi of one shape [B>0, Nsym>0], got "
                         f"{tuple(yr.shape)} / {tuple(yi.shape)}")
    b = yr.shape[0]
    if hr.shape != hi.shape or hr.dim() not in (1, 2) or hr.shape[0] != b:
        raise ValueError(f"K4 takes hr/hi of one shape [B] or [B, nc] with B = {b}, got "
                         f"{tuple(hr.shape)} / {tuple(hi.shape)}")
    nc = 1 if hr.dim() == 1 else hr.shape[1]
    if nc not in KERNEL_CANDIDATES:
        raise ValueError(f"K4 takes {KERNEL_CANDIDATES} candidates a codeword, not {nc}")
    if isinstance(var, torch.Tensor) and var.numel() != 1:
        raise ValueError(f"var must hold one value, got shape {tuple(var.shape)}")
    return nc


def _counted(bit_p0: torch.Tensor, chan_llr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    count("demap.fused_rows", bit_p0.shape[0])
    return bit_p0, chan_llr


def launch_k4(table: K4Table, yr: torch.Tensor, yi: torch.Tensor, hr: torch.Tensor,
              hi: torch.Tensor, var) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of K4: yr/yi [B, Nsym] float32 CUDA symbols, hr/hi [B, nc]
    gain candidates (or [B], one a codeword), var the noise variance (a
    float, or a one-element tensor on the CPU or the symbols' card).
    Returns (bit_p0, chan_llr), each [B * nc, Nsym * m]: row b * nc + c is
    codeword b under candidate c."""
    nc = _check(table, yr, yi, hr, hi, var)
    b, nsym = yr.shape
    m = int(table.points_re.shape[0]).bit_length() - 1
    dev = yr.device
    yr, yi = yr.contiguous(), yi.contiguous()
    if hr.dim() == 1:
        hr, hi = hr[:, None], hi[:, None]
    if hr.stride(0) != hi.stride(0) or (nc > 1 and (hr.stride(1) != 1 or hi.stride(1) != 1)):
        hr, hi = hr.contiguous(), hi.contiguous()
    var = torch.as_tensor(var, dtype=torch.float32, device=dev).reshape(())
    lib = load_library()
    with torch.cuda.device(dev):
        bit_p0 = torch.empty((b * nc, nsym * m), dtype=torch.float32, device=dev)
        chan_llr = torch.empty_like(bit_p0)
        with span("k4"):
            err = lib.kmldpc_demap(
                yr.data_ptr(), yi.data_ptr(), hr.data_ptr(), hi.data_ptr(), hr.stride(0), nc,
                var.data_ptr(), table.points_re.ctypes.data, table.points_im.ctypes.data,
                table.points_re.shape[0], bit_p0.data_ptr(), chan_llr.data_ptr(), b, nsym,
                constants.SMALLEST_PROB, 1.0 - constants.SMALLEST_PROB, constants.LLR_CLIP,
                torch.cuda.current_stream(dev).cuda_stream,
            )
    if err != 0:
        raise RuntimeError(f"K4 (kmldpc_demap) launch failed: cudaError_t {err} "
                           f"(B={b}, Nsym={nsym}, nc={nc}, M={table.points_re.shape[0]})")
    launch_k4.launches += 1
    return _counted(bit_p0, chan_llr)


launch_k4.launches = 0  # type: ignore[attr-defined]
