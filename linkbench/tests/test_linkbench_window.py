"""The window's counting on a scripted clock and a scripted Simulator:
whole sweeps only, and ``blocks_per_s`` is every block over all the
window's time."""

import pytest

from linkbench import spec
from linkbench.window import Tap, Window, run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class Result:
    raw = None


class Runner:
    """A launch that holds the host for ``cost`` seconds of the clock."""

    blocks_per_launch = 1024

    def __init__(self, clock, cost):
        self.clock, self.cost = clock, cost

    def __call__(self, *args):
        self.clock.t += self.cost
        return Result()


class FakeSim:
    """The sequential harness's order, ``launches`` launches a point, with
    ``consume`` seconds of host work after each."""

    def __init__(self, clock, points, launches, cost, consume):
        self.clock, self.points, self.launches = clock, points, launches
        self.consume = consume
        self.runner = Runner(clock, cost)

    def simulate(self):
        for snr in self.points:
            for n in range(self.launches):
                self.runner(snr, n, 1.0)
                self.clock.t += self.consume

    def close(self):
        pass


def run(deadline, points=(5.0, 7.5), launches=4, cost=0.25, build=0.5, consume=0.0):
    clock = Clock()
    window = Window(deadline, clock=clock)
    kept = []

    def new_sim(sweep):
        clock.t += build  # the Simulator is built inside the window
        return FakeSim(clock, points, launches, cost, consume)

    run_window(window, new_sim, lambda s, launch, r: kept.append((s, launch)))
    return window, kept


def test_the_sweep_running_at_the_deadline_ends_the_window():
    # a sweep: 0.5 s to build, 8 launches of 0.25 s: 2.5 s.  At 3.6 s the
    # second sweep is running; it runs to its end at 5.0 s.
    window, kept = run(deadline=3.6)
    assert window.sweep_seconds() == pytest.approx([2.5, 2.5])
    assert window.span() == pytest.approx(5.0)
    assert window.launches() == 16 and window.blocks() == 16 * 1024
    assert window.blocks_per_s() == pytest.approx(16 * 1024 / 5.0)
    assert kept[0] == (0, [(5.0, 0)]) and kept[-1] == (1, [(7.5, 3)])


def test_a_deadline_on_a_sweep_end_takes_no_more():
    window, _ = run(deadline=2.5)
    assert len(window.sweeps) == 1 and window.blocks_per_s() == pytest.approx(8 * 1024 / 2.5)


def test_at_least_one_sweep():
    window, _ = run(deadline=0.0)
    assert len(window.sweeps) == 1 and window.span() == pytest.approx(2.5)


def test_the_rate_is_all_blocks_over_all_the_time():
    """Host time outside runner calls counts, as it does for the user: not
    a median of sweeps, not the calls' time alone."""
    window, _ = run(deadline=6.0, consume=0.05)
    sweep = 0.5 + 8 * (0.25 + 0.05)
    assert window.sweep_seconds() == pytest.approx([sweep] * 3)
    assert window.blocks_per_s() == pytest.approx(3 * 8 * 1024 / (3 * sweep))
    # outside runner calls: the build and 8 consumes, per 8 x 1024 blocks,
    # over the sweeps after the traced one
    harness = spec.metric_reader("harness_ms_per_kblk").read(None, {"window": window})
    assert harness == pytest.approx((0.5 + 8 * 0.05) * 1e3 / 8.192)


def test_sweep_spread_is_the_interquartile_range_over_the_median():
    window = Window(1.0)
    window.sweeps = [type("S", (), {"t0": 0.0, "t1": t, "blocks": 1})() for t in (1, 2, 3, 4, 5)]
    assert window.sweep_spread() == pytest.approx((4.5 - 1.5) / 3.0)


def test_folded_calls_count_every_slot_once():
    clock = Clock()
    window = Window(10.0, clock=clock)
    window.begin()
    seen = []
    tap = Tap(Runner(clock, 0.0), window, 3, lambda s, launch, r: seen.append((s, launch)))
    tap([(14.0, 0), (16.5, 0), (14.0, 0)], [0.1, 0.2, 0.1])  # the last slot is padding
    assert seen == [(3, [(14.0, 0), (16.5, 0), (14.0, 0)])]
    assert window.launches() == 2 and tap.blocks == 2 * 1024
