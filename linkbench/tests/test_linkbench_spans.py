"""The program's own spans and counters in a traced run: nested spans inside
the chain's labels, and their device-side copies, leave the trace's
reduction as it was; the readers of the decode's idle time, its useful
share of codeword-iterations and its syncs a launch."""

import sys

import pytest
import torch

from linkbench import spec
from linkbench.trace import SWEEP_SPAN, Summary, reduce
from linkbench.window import CALL_SPAN

MS = 1_000_000  # ns
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Bare:
    """The part of a kineto event that ``trace.reduce`` reads, as torch 2.11
    gives it: no ``activity_type``."""

    def __init__(self, name, start, end, kind, corr=0, linked=0):
        self._name, self._start, self._end, self._kind = name, start, end, kind
        self._corr, self._linked = corr, linked

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return CUDA if self._kind in ("kernel", "gpu_user_annotation") else CPU

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


class Event(Bare):
    """A kineto event of a torch that gives its kind."""

    def activity_type(self):
        return self._kind


def _ms(a, b):
    return int(a * MS), int(b * MS)


def canned(event=Event) -> list:
    """A traced sweep of 10 ms, as ``test_linkbench_metrics.canned``: a
    runner call from 1 to 9 ms holding the chain's labels, host ops, and
    the kernels each launched."""
    spans = [(SWEEP_SPAN, 0, 10), (CALL_SPAN, 1, 9), ("frontend", 1, 2), ("kmeans", 2, 3),
             ("metric", 3, 4), ("decode", 4, 8), ("counters", 8, 9)]
    ops = [(1, 1.5), (2, 2.2), (3, 2.4), (4, 3.5), (5, 4.5), (6, 5.0), (7, 8.5)]
    kernels = [(1.6, 1.8, "randn_kernel", 1), (2.3, 2.5, "void kmeans_kernel<4, false>(...)", 2),
               (2.5, 2.6, "fill_kernel", 3), (3.6, 3.9, "demap_kernel", 4),
               (4.6, 5.6, "elementwise_kernel", 5), (5.6, 7.6, "gather_kernel", 6),
               (8.6, 8.7, "reduce_kernel", 7)]
    events = [event(n, *_ms(a, b), "user_annotation") for n, a, b in spans]
    events += [event("aten::op", *_ms(t, t + 0.01), "cpu_op", corr=c) for c, t in ops]
    events += [event(n, *_ms(a, b), "kernel", linked=c) for a, b, n, c in kernels]
    return events


# the program's spans: phase 1, the sort and two tiles inside decode, an
# exit check inside each tile; the harness's set-up before the runner call,
# a consume holding a checkpoint write after it
PROGRAM = [("decode.phase1", 4.0, 4.55), ("decode.sort", 4.55, 4.6), ("decode.tile", 4.6, 6.0),
           ("exit_check", 5.9, 6.0), ("decode.tile", 6.0, 8.0), ("exit_check", 7.5, 7.9),
           ("harness.build", 0.0, 0.9), ("harness.consume", 9.1, 9.8),
           ("harness.checkpoint", 9.5, 9.7)]


def _nested(shape: str) -> list:
    """The canned sweep with the program's spans: as the port records them,
    with an operator's scope, on a torch whose events carry no kind (the
    card's torch 2.11) or do; or as user annotations with the profiler's
    device-side copies, on a torch whose events carry their kind."""
    event = Bare if shape == "operators-kindless" else Event
    events = canned(event)
    for i, (name, a, b) in enumerate(PROGRAM):
        if shape == "annotations-and-copies":
            events.append(event(name, *_ms(a, b), "user_annotation", corr=100 + i))
            events.append(event(name, *_ms(a + 0.05, b), "gpu_user_annotation", linked=100 + i))
        else:
            events.append(event(name, *_ms(a, b), "cpu_op", corr=100 + i))
    return events


def _fields(s: Summary) -> tuple:
    return s.window_s, s.busy_s, s.by_label, s.by_kernel, s.idle_by_host


@pytest.mark.parametrize("shape", ["operators-kindless", "operators", "annotations-and-copies"])
def test_program_spans_leave_the_reduction_as_it_was(shape):
    """by_label, by_kernel, busy_s, window_s and the idle gaps under each
    chain label, with the program's nested spans as without them."""
    plain = reduce(canned())
    assert plain.by_label["decode"] == pytest.approx(0.003)
    assert _fields(reduce(_nested(shape))) == _fields(plain)
    assert _fields(reduce(canned(Bare))) == _fields(plain)


def read(metric, trace, ctx=None):
    return spec.metric_reader(metric).read(trace, ctx or {})


def test_decode_idle_reads_every_gap_under_decode():
    s = reduce(canned())
    assert read("decode_idle_ms_per_kblk", s) is None  # no blocks traced
    s.blocks = 2000
    assert read("decode_idle_ms_per_kblk", s) == pytest.approx(0.7 / 2)
    s.idle_by_host = {"decode": 0.0002, "decode/exit_check": 0.0004,
                      "decode/decode.tile": 0.0001, "harness/harness.checkpoint": 0.5}
    assert read("decode_idle_ms_per_kblk", s) == pytest.approx(0.7 / 2)
    s.idle_by_host = {"harness": 0.001}
    assert read("decode_idle_ms_per_kblk", s) is None


@pytest.fixture
def counters():
    from kmldpc_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


def test_counter_readers(counters):
    s = Summary(0.0, 0.0, {}, {}, {})
    assert read("decode_useful_share", s) is None
    assert read("decode_syncs_per_launch", s) is None
    counters.count("cw_iters_run", 4000, stage="decode")
    counters.count("cw_iters_run", 900, stage="metric")  # another stage's: not read
    counters.count("syncs", 30, stage="decode")
    counters.count("syncs", 7, stage="metric")
    counters.count("cw_iters_needed", 1000, stage="decode")
    counters.count("launches", 3, stage="harness")
    assert read("decode_useful_share", s) == pytest.approx(0.25)
    assert read("decode_syncs_per_launch", s) == pytest.approx(10.0)


def test_counter_readers_without_the_counters(counters, monkeypatch):
    """A program without ``kmldpc_torch.utils.trace`` gives no reading."""
    counters.count("cw_iters_run", 4000, stage="decode")
    monkeypatch.setitem(sys.modules, "kmldpc_torch.utils.trace", None)
    s = Summary(0.0, 0.0, {}, {}, {})
    assert read("decode_useful_share", s) is None
    assert read("decode_syncs_per_launch", s) is None
