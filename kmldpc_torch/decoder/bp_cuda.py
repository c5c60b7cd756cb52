"""Wrappers of kernels K2 and K3 (``csrc/bp_flood.cu``): the flooding
sum-product decode, one thread block a codeword, each codeword for as many
iterations as it needs; K2 of a regular code, K3 of an irregular one (the
5G base graphs).

Neither replaces a Pallas kernel (the JAX package's decoder runs as XLA).
K2's plain version is the slot-major core
``decoder/bp_em.py::_decode_cols_padded``, K3's the degree-class core
``_decode_cols_classes``, each with ``cn_rule="sumprod"`` and float32
messages, which the CPU keeps running.  ``bp_em.fused_decode_engages``
decides where a kernel runs, and the decoder of ``bp_em.flooding_decoder``
launches the one the code takes there; :func:`launch_k2` and
:func:`launch_k3` take CUDA tensors only and raise on anything else,
before they load the library.  A launch makes no copy from the device and no synchronisation.  It runs
inside the span ``k2`` or ``k3``: a kernel launched through ``ctypes`` has
no PyTorch operator around it, and the span is what ties it, on a
profiler's timeline, to the chain label the host is in.  Each launch adds
one to its function's ``launches`` and the rows it decodes to the counter
``fused_rows``; it counts its host syncs (none) under ``syncs`` so that a
reader of that counter sees zero, not nothing.
"""

from __future__ import annotations

import ctypes

import torch

from .. import constants
from .._build import load_library
from ..utils.trace import count, span
from .bp import PHI_ARG_MIN, DecodeResult, DecoderTables

SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on sm_90 (227 KB)
MAX_ROW_DEGREE = 32  # a row's signs are one 32-bit mask in the kernels
MAX_CLASSES = 16  # degree classes a side of the graph may have in K3
# K3's two sides' class descriptors, in static shared memory beside the working set
CLASS_SMEM_BYTES = 2 * 4 * (MAX_CLASSES + (MAX_CLASSES + 1) + MAX_CLASSES)


def smem_bytes(t: DecoderTables) -> int:
    """The working set K2 or K3 keeps in a block's shared memory, float32:
    c2v [num_edges], the posteriors and the channel LLRs [num_col] each, the
    soft syndrome [num_row]."""
    return 4 * (t.num_edges + 2 * t.num_col + t.num_row)


def fits(t: DecoderTables) -> bool:
    """Whether K2 takes the code: regular, a row degree its sign mask
    holds, and a working set within one block's shared memory."""
    return t.is_regular and t.dr <= MAX_ROW_DEGREE and smem_bytes(t) <= SMEM_PER_BLOCK


def fits_classes(t: DecoderTables) -> bool:
    """Whether K3 takes the code: irregular, a row degree its sign mask
    holds, at most ``MAX_CLASSES`` degree classes a side, and a working set
    within one block's shared memory beside the class descriptors."""
    return (not t.is_regular and max(d for d, _ in t.row_classes) <= MAX_ROW_DEGREE
            and max(len(t.col_classes), len(t.row_classes)) <= MAX_CLASSES
            and smem_bytes(t) + CLASS_SMEM_BYTES <= SMEM_PER_BLOCK)


def _check(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int, kernel: str) -> None:
    if chan_llr.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32 LLRs, got {chan_llr.dtype}")
    tx_len = t.num_col - t.punct
    if chan_llr.dim() != 2 or chan_llr.shape[1] != tx_len:
        raise ValueError(f"{kernel} takes LLRs [B, {tx_len}], got {tuple(chan_llr.shape)}")
    if chan_llr.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda tensors, got {chan_llr.device}")
    if t.perm_sm_c2r32.device != chan_llr.device:
        raise ValueError(f"tables on {t.perm_sm_c2r32.device} but LLRs on {chan_llr.device}")
    if not (fits if kernel == "K2" else fits_classes)(t):
        raise ValueError(f"{kernel} does not take this code (regular {t.is_regular}, classes "
                         f"{t.col_classes} x {t.row_classes}, {smem_bytes(t)} bytes of shared "
                         f"memory a block)")
    if iter_count < 0:
        raise ValueError(f"iter_count must be >= 0, got {iter_count}")


def _outputs(t: DecoderTables, b: int, dev: torch.device) -> tuple:
    """cc_hat [B, num_col] int8, converged [B], iters [B] int32 and the
    soft syndrome [B, num_row] float32, uninitialised: the kernels write
    every element."""
    return (torch.empty((b, t.num_col), dtype=torch.int8, device=dev),
            torch.empty((b,), dtype=torch.bool, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b, t.num_row), dtype=torch.float32, device=dev))


def _result(t: DecoderTables, outs: tuple) -> DecodeResult:
    cc_hat, conv, iters, ss = outs
    count("fused_rows", cc_hat.shape[0])
    count("syncs", 0)
    uu_hat = cc_hat[:, t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


def launch_k2(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
    """One launch of K2 on [B, tx_len] float32 CUDA LLRs log(P0/P1): the
    batch-major DecodeResult of ``bp_em.flooding_decode_em``."""
    _check(t, chan_llr, iter_count, "K2")
    chan_llr = chan_llr.contiguous()
    b, dev = chan_llr.shape[0], chan_llr.device
    lib = load_library()
    with torch.cuda.device(dev):
        outs = _outputs(t, b, dev)
        if b:
            with span("k2"):
                err = lib.kmldpc_bp_flood(
                    chan_llr.data_ptr(), t.perm_sm_c2r32.data_ptr(), t.row_col_sm32.data_ptr(),
                    *(o.data_ptr() for o in outs),
                    b, t.num_col, t.num_row, t.dc, t.dr, t.punct, iter_count,
                    PHI_ARG_MIN, constants.SMALLEST_PROB, constants.LLR_CLIP,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            if err != 0:
                raise RuntimeError(f"K2 (kmldpc_bp_flood) launch failed: cudaError_t {err} "
                                   f"(B={b}, num_col={t.num_col}, dc={t.dc}, dr={t.dr})")
    launch_k2.launches += 1
    return _result(t, outs)


launch_k2.launches = 0  # type: ignore[attr-defined]


def class_args(t: DecoderTables) -> tuple:
    """K3's class arguments, host arrays: the column classes' degrees,
    node counts and number, then the row classes' alike."""
    out = ()
    for classes in (t.col_classes, t.row_classes):
        arr = ctypes.c_int * len(classes)
        out += (arr(*(d for d, _ in classes)), arr(*(n for _, n in classes)), len(classes))
    return out


def launch_k3(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
    """One launch of K3 on [B, tx_len] float32 CUDA LLRs log(P0/P1): the
    batch-major DecodeResult of ``bp_em.flooding_decode_em``."""
    _check(t, chan_llr, iter_count, "K3")
    chan_llr = chan_llr.contiguous()
    b, dev = chan_llr.shape[0], chan_llr.device
    lib = load_library()
    with torch.cuda.device(dev):
        outs = _outputs(t, b, dev)
        if b:
            with span("k3"):
                err = lib.kmldpc_bp_flood_classes(
                    chan_llr.data_ptr(), t.perm_cf_c2r32.data_ptr(), t.row_col_cf32.data_ptr(),
                    t.col_sort32.data_ptr(), t.col_unsort32.data_ptr(),
                    t.row_unsort32.data_ptr(), *(o.data_ptr() for o in outs),
                    b, t.num_col, t.num_row, t.punct, *class_args(t), iter_count,
                    PHI_ARG_MIN, constants.SMALLEST_PROB, constants.LLR_CLIP,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            if err != 0:
                raise RuntimeError(f"K3 (kmldpc_bp_flood_classes) launch failed: cudaError_t "
                                   f"{err} (B={b}, num_col={t.num_col}, classes "
                                   f"{t.col_classes} x {t.row_classes})")
    launch_k3.launches += 1
    return _result(t, outs)


launch_k3.launches = 0  # type: ignore[attr-defined]
