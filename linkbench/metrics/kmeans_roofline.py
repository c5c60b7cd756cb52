"""Kernel K1's share of its roofline, in %: its least time for the rows of
the traced launches (``roofline.k1_least_s``, with the assignment passes
each row needs, counted by the reference on the same draws) over the
device time of the kernel named ``kmeans_kernel`` in the traced sweep,
not of the wrapper's span."""

import torch

from linkbench.judge import sweep_seed
from linkbench.reference.chain import kmeans_passes
from linkbench.roofline import k1_least_s
from linkbench.window import TRACED_SWEEP

KERNEL = "kmeans_kernel"


def read(trace, ctx):
    seconds = trace.kernel_s(KERNEL)
    if not seconds or not trace.launches or not ctx["ops_per_s"] or not ctx["cell"].blind:
        return None
    link, g = ctx["link"], ctx["graph"]
    seed = sweep_seed(ctx["seed"], TRACED_SWEEP)
    with torch.no_grad():
        passes = [kmeans_passes(link, g, seed, snr, launch) for snr, launch in trace.launches]
    nsym = link.code.tx_len // link.const.bits_per_symbol
    least = sum(k1_least_s(p.numel(), nsym, link.const.points.size, float(p.sum()),
                           ctx["ops_per_s"]) for p in passes)
    return 100.0 * least / seconds
