"""The share of the final decode's codeword-iterations that its results
needed: the program's counters ``decode.cw_iters_needed`` (the iterations
each consumed codeword needed, summed by the ``Simulator``) over
``decode.cw_iters_run`` (the rows of every decoder loop under the chain's
``decode`` label times the iterations it ran: phase 1, each phase-2 tile at
its full width, a folded dispatch's padding slots).  The counters are host
integers, always on, read once the run's sweeps are done: the warm sweep's
and the window's, all of one cell's traffic.  A program without them gives
no reading."""


def read(trace, ctx):
    try:
        from kmldpc_torch.utils.trace import snapshot
    except ImportError:
        return None
    counts = snapshot()
    run = counts.get("decode.cw_iters_run")
    needed = counts.get("decode.cw_iters_needed")
    if not run or needed is None:
        return None
    return needed / run
