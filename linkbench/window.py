"""The measured window: whole sweeps through ``Simulator.simulate()``, back
to back, until the sweep running when the deadline passes has ended.

Each sweep builds its own ``Simulator`` inside the window, as a
researcher's run does, and ends once the device has finished its last
launch.  ``Tap`` wraps ``Simulator.runner``: it times every call on the
host clock under a ``linkbench.call`` span, counts the blocks of the
launches the call issued, and hands the result to the sampler and, in the
traced sweep, to the tracer.

``blocks_per_s`` is every block of every sweep over the time from the
window's start to the end of its last sweep: a window holds whole sweeps
only, each with the same SNR points and blocks a point.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from torch.profiler import record_function

CALL_SPAN = "linkbench.call"
TRACED_SWEEP = 0  # the sweep a traced run profiles


@dataclasses.dataclass
class Call:
    sweep: int
    t0: float
    t1: float
    launches: list  # [(snr, launch)], one per slot (one for the sequential runner)


@dataclasses.dataclass
class Sweep:
    t0: float  # before its Simulator is built
    t1: float  # once the device has finished its last launch
    blocks: int


@dataclasses.dataclass
class Window:
    """What the window saw, on one host clock."""

    deadline_s: float
    clock: Callable[[], float] = time.monotonic
    start: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    sweeps: list = dataclasses.field(default_factory=list)

    def begin(self) -> None:
        self.start = self.clock()

    def past_deadline(self) -> bool:
        return self.clock() - self.start >= self.deadline_s

    @property
    def end(self) -> float:
        return self.sweeps[-1].t1 if self.sweeps else self.start

    def span(self) -> float:
        return self.end - self.start

    def blocks(self) -> int:
        return sum(s.blocks for s in self.sweeps)

    def blocks_per_s(self) -> float:
        return self.blocks() / self.span()

    def launches(self) -> int:
        """Launches issued (a folded dispatch's padding slots left out)."""
        return sum(len(set(c.launches)) for c in self.calls)

    def sweep_seconds(self) -> list[float]:
        return [s.t1 - s.t0 for s in self.sweeps]

    def sweep_spread(self) -> float:
        """Interquartile range of the sweep times over their median."""
        xs = self.sweep_seconds()
        if len(xs) < 2:
            return 0.0
        q1, q2, q3 = statistics.quantiles(xs, n=4)
        return (q3 - q1) / q2


class Tap:
    """``Simulator.runner`` with a clock, a sampler and a tracer around it."""

    def __init__(self, runner, window: Window, sweep: int, keep: Callable, tracer=None):
        self.runner = runner
        self.blocks_per_launch = runner.blocks_per_launch  # Simulator reads it
        self.window = window
        self.sweep = sweep
        self.keep = keep  # keep(sweep, launches, result)
        self.tracer = tracer
        self.blocks = 0

    def __call__(self, *args):
        if isinstance(args[0], list):  # the multi-point runner: (points, vars)
            launches = [tuple(p) for p in args[0]]
        else:  # the sequential runner: (snr, launch, var)
            launches = [(args[0], args[1])]
        t0 = self.window.clock()
        with record_function(CALL_SPAN):
            res = self.runner(*args)
        self.window.calls.append(Call(self.sweep, t0, self.window.clock(), launches))
        # a folded dispatch pads its last slots with copies of a live slot
        self.blocks += len(set(launches)) * self.blocks_per_launch
        self.keep(self.sweep, launches, res)
        if self.tracer is not None:
            self.tracer.after_call(launches, res)
        return res


def run_window(window: Window, new_simulator: Callable, keep: Callable, tracer=None,
               sync: Callable = lambda: None) -> None:
    """Whole sweeps until the deadline: ``new_simulator(sweep)`` builds the
    sweep's ``Simulator``; the tracer, if any, records ``TRACED_SWEEP``."""
    window.begin()
    sweep = 0
    while True:
        traced = tracer is not None and sweep == TRACED_SWEEP
        if traced:
            tracer.start()
        t0 = window.clock()
        sim = new_simulator(sweep)
        tap = Tap(sim.runner, window, sweep, keep, tracer if traced else None)
        sim.runner = tap
        try:
            sim.simulate()
        finally:
            sim.close()
        sync()
        window.sweeps.append(Sweep(t0, window.clock(), tap.blocks))
        if traced:
            tracer.stop()
        sweep += 1
        if window.past_deadline():
            break
