"""Host milliseconds per 1000 codewords that the window's sweeps spend
outside runner calls: each sweep's ``Simulator`` construction, the
harness's consumes, logging and checkpoints, and the wait for the last
launch.  Read from the benchmark's own host-clock stamps around each sweep
and each runner call (``ctx["window"]``), over the sweeps after the traced
one, which the profiler slows."""

from linkbench.window import TRACED_SWEEP


def read(trace, ctx):
    window = ctx["window"]
    outside = blocks = 0.0
    for i, sweep in enumerate(window.sweeps):
        if i == TRACED_SWEEP:
            continue
        inside = sum(c.t1 - c.t0 for c in window.calls if c.sweep == i)
        outside += sweep.t1 - sweep.t0 - inside
        blocks += sweep.blocks
    return outside * 1e3 / (blocks / 1000) if blocks else None
