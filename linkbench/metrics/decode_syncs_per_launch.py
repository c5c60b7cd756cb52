"""Host syncs of the final decode a launch: the program's counters
``decode.syncs`` (each decoder loop's early-exit tests and phase 2's
unconverged count, under the chain's ``decode`` label) over
``harness.launches`` (the launches the ``Simulator`` consumed; a folded
dispatch's padding slots are not launches, their syncs count).  Host
integers, always on, read once the run's sweeps are done: the warm sweep's
and the window's.  A program without them gives no reading."""


def read(trace, ctx):
    try:
        from kmldpc_torch.utils.trace import snapshot
    except ImportError:
        return None
    counts = snapshot()
    syncs = counts.get("decode.syncs")
    launches = counts.get("harness.launches")
    if syncs is None or not launches:
        return None
    return syncs / launches
