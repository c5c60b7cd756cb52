"""The traced run: ``torch.profiler`` over the window's first sweep, whole,
reduced in memory to a summary that the per-layer readers take.

The profiler records host and device activities from before the sweep's
``Simulator`` is built until the device has finished its last launch; no
trace file is written.  Each device activity is tied to the host op that
launched it (its linked correlation id), and through that op's start to the
host spans around it: the chain's ``record_function`` labels and the
harness's ``linkbench.call`` around each runner call.  Device time under a
label is the time of the kernels launched under it, not the host's time
there.
"""

from __future__ import annotations

import bisect
import dataclasses
import re

import torch
from torch.autograd.profiler import record_function

from .window import CALL_SPAN

CHAIN_LABELS = ("frontend", "kmeans", "metric", "demap", "decode", "counters")
SWEEP_SPAN = "linkbench.sweep"
# device activities that are not work: the device-side copies of host spans
_NOT_WORK = ("gpu_user_annotation",)
# host events whose correlation ids the device activities link to
_HOST_OPS = ("cpu_op", "user_annotation")
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernel, ...


@dataclasses.dataclass
class Summary:
    """What the traced sweep did, on the device's timeline."""

    window_s: float  # the traced sweep's span
    busy_s: float  # union of device activities in it
    by_label: dict  # chain label -> device seconds of the kernels launched under it
    by_kernel: dict  # activity name -> device seconds
    idle_by_host: dict  # what the host was in -> seconds of device idle
    blocks: int = 0  # codewords of the traced launches
    launches: list = dataclasses.field(default_factory=list)  # [(snr, launch)] traced
    iters: float = 0.0  # decode iterations each codeword needed, summed

    def kernel_s(self, fragment: str) -> float:
        return sum(s for name, s in self.by_kernel.items() if fragment in name)

    def ms_per_kblk(self, label: str) -> float | None:
        """A chain label's device milliseconds per 1000 traced codewords."""
        seconds = self.by_label.get(label)
        if not seconds or not self.blocks:
            return None
        return seconds * 1e3 / (self.blocks / 1000)


class _Spans:
    """Non-overlapping host spans of one kind, for lookups by time."""

    def __init__(self, spans: list[tuple[int, int, str]]):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return self.spans[i][2]
        return None


def _span(e) -> tuple[int, int]:
    """(start, end) of a kineto event in ns (older builds give us)."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def _host_op(e, name: str) -> bool:
    """A host op or annotation, whose id device activities link to; CUDA
    runtime and driver calls number their own ids."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in _HOST_OPS
    return not _RUNTIME.match(name)


def reduce(events) -> Summary:
    """Summary of kineto events (``prof.profiler.kineto_results.events()``)."""
    labels, calls, sweep, host_start, device = [], [], None, {}, []
    for e in events:
        name = e.name()
        start, end = _span(e)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if _host_op(e, name):
                host_start[e.correlation_id()] = start
            if name in CHAIN_LABELS:
                labels.append((start, end, name))
            elif name == CALL_SPAN:
                calls.append((start, end, name))
            elif name == SWEEP_SPAN:
                sweep = (start, end)
        elif name not in CHAIN_LABELS and name not in (CALL_SPAN, SWEEP_SPAN):
            kind = getattr(e, "activity_type", None)
            if kind is None or kind() not in _NOT_WORK:
                device.append((start, end, name, e.linked_correlation_id()))
    return summarize(sweep, labels, calls, host_start, device)


def summarize(sweep, labels, calls, host_start, device) -> Summary:
    """The reduction itself, on plain tuples: the sweep's host span (start,
    end), host spans (start, end, name), host op starts by correlation id,
    device activities (start, end, name, linked correlation id); times in
    ns.  A device activity belongs to the sweep where it starts inside it."""
    if sweep is None or not device:
        return Summary(0.0, 0.0, {}, {}, {})
    first, last = sweep
    label_at = _Spans(list(labels))
    call_at = _Spans(list(calls))
    by_label: dict = {}
    by_kernel: dict = {}
    idle: dict = {}
    busy, cursor = 0, first
    for s, e, name, corr in sorted(device):
        if s < first or s > last:
            continue
        dur = (e - s) / 1e9
        by_kernel[name] = by_kernel.get(name, 0.0) + dur
        t = host_start.get(corr)
        label = label_at.at(t) if t is not None else None
        if label is not None:
            by_label[label] = by_label.get(label, 0.0) + dur
        if s > cursor:  # a gap: name it by what the host was in at its middle
            _gap(idle, label_at, call_at, cursor, s)
        busy += max(0, e - max(s, cursor))
        cursor = max(cursor, e)
    end = max(last, cursor)
    if end > cursor:
        _gap(idle, label_at, call_at, cursor, end)
    return Summary((end - first) / 1e9, busy / 1e9, by_label, by_kernel, idle)


def _gap(idle: dict, label_at: _Spans, call_at: _Spans, a: int, b: int) -> None:
    mid = (a + b) // 2
    host = label_at.at(mid) or ("runner call" if call_at.at(mid) else "harness")
    idle[host] = idle.get(host, 0.0) + (b - a) / 1e9


class Tracer:
    """Profiles one sweep: ``start`` before its ``Simulator`` is built,
    ``after_call`` for each runner call, ``stop`` once the device is done."""

    def __init__(self, sync, blocks_per_launch: int):
        self.sync = sync  # waits for the device
        self.blocks_per_launch = blocks_per_launch
        self.prof = None
        self.span = None
        self.launches: list = []
        self.iters: list = []  # device tensors, read after the window

    @staticmethod
    def warm() -> None:
        """Start the profiler once in set-up, so its first start is not in
        the window."""
        with _profile():
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def start(self) -> None:
        self.prof = _profile()
        self.prof.start()
        self.span = record_function(SWEEP_SPAN)
        self.span.__enter__()

    def after_call(self, launches: list, res) -> None:
        """Keep the iterations of each distinct launch (a folded dispatch's
        padding slots repeat a live one)."""
        iters = res.raw.iters
        for j, key in enumerate(launches):
            if key in launches[:j]:
                continue
            self.launches.append(key)
            self.iters.append((iters[j] if iters.dim() > 1 else iters).sum())

    def stop(self) -> None:
        self.sync()
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> Summary:
        s = reduce(self.prof.profiler.kineto_results.events())
        s.launches = list(self.launches)
        s.blocks = len(self.launches) * self.blocks_per_launch
        s.iters = float(sum(int(x) for x in self.iters))
        return s


def _profile():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)
