"""Kernel K4's share of its roofline, in %: its least time for the traced
launches over the device time of the kernels whose name holds
``demap_kernel``.

The rows K4 demapped (a codeword under one gain each) are the program's
counters ``*demap.fused_rows`` over ``harness.launches``, a launch's rows,
times the traced launches; the counters are host integers read once the
run's sweeps are done, and every launch of a cell has one shape.  The least
time is the larger of two: one exponential a point a row a symbol on the
special-function units, which take 16 results a clock an SM against the
128 float32 lanes of ``ctx["ops_per_s"]``, and the bytes: the traced
codewords' symbols read once (two float32 planes), P(bit = 0) and the LLR
written once a bit a row (float32 each).  A program without the counters
gives no reading.  The count is kept here; ``linkbench/roofline.py`` counts
K1 and the decoders."""

from linkbench.roofline import HBM_BYTES_PER_S

KERNEL = "demap_kernel"
SPECIAL_FUNCTION_SHARE = 16 / 128


def read(trace, ctx):
    try:
        from kmldpc_torch.utils.trace import snapshot
    except ImportError:
        return None
    seconds = trace.kernel_s(KERNEL)
    if not seconds or not trace.blocks or not trace.launches or not ctx["ops_per_s"]:
        return None
    counts = snapshot()
    rows = sum(v for k, v in counts.items() if k.endswith("demap.fused_rows"))
    launches = counts.get("harness.launches")
    if not rows or not launches:
        return None
    rows = rows * len(trace.launches) / launches
    const = ctx["link"].const
    m = const.bits_per_symbol
    nsym = ctx["link"].code.tx_len // m
    exp_s = rows * nsym * const.points.size / (ctx["ops_per_s"] * SPECIAL_FUNCTION_SHARE)
    bytes_s = (trace.blocks * 8 * nsym + rows * nsym * m * 8) / HBM_BYTES_PER_S
    return 100.0 * max(exp_s, bytes_s) / seconds
