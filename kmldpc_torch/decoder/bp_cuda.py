"""Wrapper of kernel K2 (``csrc/bp_flood.cu``): the flooding sum-product
decode of a regular code, one thread block a codeword, each codeword for as
many iterations as it needs.

K2 replaces no Pallas kernel (the JAX package's decoder runs as XLA); its
plain version is the slot-major core ``decoder/bp_em.py::_decode_cols_padded``
with ``cn_rule="sumprod"`` and float32 messages, which the CPU keeps
running.  ``bp_em.fused_decode_engages`` decides where K2 runs, and
``bp_em.flooding_decode_em`` launches it there; :func:`launch_k2` takes
CUDA tensors only and raises on anything else, before it loads the
library.  A launch makes no copy from the device and no synchronisation.
It runs inside the span ``k2``: a kernel launched through ``ctypes`` has no
PyTorch operator around it, and the span is what ties it, on a profiler's
timeline, to the chain label the host is in.
Each launch adds one to ``launch_k2.launches`` and the rows it decodes to
the counter ``fused_rows``; it counts its host syncs (none) under ``syncs``
so that a reader of that counter sees zero, not nothing.
"""

from __future__ import annotations

import torch

from .. import constants
from .._build import load_library
from ..utils.trace import count, span
from .bp import PHI_ARG_MIN, DecodeResult, DecoderTables

SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may use on sm_90 (227 KB)
MAX_ROW_DEGREE = 32  # a row's signs are one 32-bit mask in the kernel


def smem_bytes(t: DecoderTables) -> int:
    """Shared memory K2 takes a block, float32: c2v [dr * num_row], the
    posteriors and the channel LLRs [num_col] each, the soft syndrome
    [num_row]."""
    return 4 * (t.dr * t.num_row + 2 * t.num_col + t.num_row)


def fits(t: DecoderTables) -> bool:
    """Whether K2 takes the code: regular, a row degree its sign mask
    holds, and a working set within one block's shared memory."""
    return t.is_regular and t.dr <= MAX_ROW_DEGREE and smem_bytes(t) <= SMEM_PER_BLOCK


def _check(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int) -> None:
    if chan_llr.dtype != torch.float32:
        raise TypeError(f"K2 takes float32 LLRs, got {chan_llr.dtype}")
    tx_len = t.num_col - t.punct
    if chan_llr.dim() != 2 or chan_llr.shape[1] != tx_len:
        raise ValueError(f"K2 takes LLRs [B, {tx_len}], got {tuple(chan_llr.shape)}")
    if chan_llr.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda tensors, got {chan_llr.device}")
    if t.perm_sm_c2r32.device != chan_llr.device:
        raise ValueError(f"tables on {t.perm_sm_c2r32.device} but LLRs on {chan_llr.device}")
    if not fits(t):
        raise ValueError(f"K2 does not take this code (regular {t.is_regular}, row degree "
                         f"{t.dr}, {smem_bytes(t)} bytes of shared memory a block)")
    if iter_count < 0:
        raise ValueError(f"iter_count must be >= 0, got {iter_count}")


def launch_k2(t: DecoderTables, chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
    """One launch of K2 on [B, tx_len] float32 CUDA LLRs log(P0/P1): the
    batch-major DecodeResult of ``bp_em.flooding_decode_em``."""
    _check(t, chan_llr, iter_count)
    chan_llr = chan_llr.contiguous()
    b, dev = chan_llr.shape[0], chan_llr.device
    lib = load_library()
    with torch.cuda.device(dev):
        cc_hat = torch.empty((b, t.num_col), dtype=torch.int8, device=dev)
        conv = torch.empty((b,), dtype=torch.bool, device=dev)
        iters = torch.empty((b,), dtype=torch.int32, device=dev)
        ss = torch.empty((b, t.num_row), dtype=torch.float32, device=dev)
        if b:
            with span("k2"):
                err = lib.kmldpc_bp_flood(
                    chan_llr.data_ptr(), t.perm_sm_c2r32.data_ptr(), t.row_col_sm32.data_ptr(),
                    cc_hat.data_ptr(), conv.data_ptr(), iters.data_ptr(), ss.data_ptr(),
                    b, t.num_col, t.num_row, t.dc, t.dr, t.punct, iter_count,
                    PHI_ARG_MIN, constants.SMALLEST_PROB, constants.LLR_CLIP,
                    torch.cuda.current_stream(dev).cuda_stream,
                )
            if err != 0:
                raise RuntimeError(f"K2 (kmldpc_bp_flood) launch failed: cudaError_t {err} "
                                   f"(B={b}, num_col={t.num_col}, dc={t.dc}, dr={t.dr})")
    launch_k2.launches += 1
    count("fused_rows", b)
    count("syncs", 0)
    uu_hat = cc_hat[:, t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat, cc_hat, conv, iters, ss)


launch_k2.launches = 0  # type: ignore[attr-defined]
