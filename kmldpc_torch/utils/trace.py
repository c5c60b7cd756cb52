"""Spans and counters of the port's own work.

Spans are ``torch.profiler`` record functions, on the profiler's timeline
beside the kernels they launch, entered only while a profiler records: with
none a span costs one attribute read.  The chain's labels (``frontend``,
``kmeans``, ``metric``, ``demap``, ``decode``, ``counters``; :class:`label`)
are user annotations (``record_function``), as they have always been.  The
spans inside them (:func:`span`) have the scope of an operator: the profiler
copies a user annotation onto the device's timeline (a
``gpu_user_annotation``), and a trace reader that cannot tell a copy from a
kernel (torch 2.11's events carry no ``activity_type``) would count the copy
as device work.  The spans:

* ``decode.phase1``, ``decode.sort``, ``decode.tile``: the two-phase
  schedule's phase 1, its unconverged count, each phase-2 tile
  (``decoder/bp_em.py``);
* ``exit_check``: a decoder loop's early-exit test, a host sync;
* ``k1``, ``k2``, ``k3``, ``k4``: a launch of kernel K1
  (``detect/kmeans_cuda.py``), K2 or K3 (``decoder/bp_cuda.py``) or K4
  (``ops/demap_cuda.py``): launched through ``ctypes``, their kernels have
  no operator of their own to be tied to;
* ``harness.build``, ``harness.consume``, ``harness.checkpoint``: the
  ``Simulator``'s set-up, its reads of a launch's counters, its checkpoint
  writes (``sim/montecarlo.py``).

Counters are host integers, always on; none reads the device.  Each is kept
under the chain label the host is in when it counts (``decode.syncs``,
``metric.cw_iters_run``, ...):

* ``cw_iters_run``: codeword-iterations executed, the rows of a decoder core
  call times the iterations its loop ran (for the rows of kernels K2 and
  K3, counted by the ``Simulator`` at consume: the iterations they needed);
* ``syncs``: host syncs of the decode, its exit checks and phase 2's
  unconverged count (K2 and K3 count their none);
* ``fused_rows``: codewords kernel K2 or K3 decoded;
* ``demap.fused_rows``: rows kernel K4 demapped, a codeword under one gain
  candidate each (``metric.demap.fused_rows``: 4B a blind launch, 2B pruned;
  ``demap.demap.fused_rows``: B with known h);
* ``kmeans.rows``: rows whose gain the blind estimate ran, counted by the
  chain whichever implementation ran them (K1, the plain loop);
* ``kmeans.point_evals``: the estimate's point evaluations, rows x Nsym x
  M x its budget of assignment passes (20; the chain runs no early exit);
* ``demap.point_evals``: points the soft demap evaluated, rows x Nsym x M,
  a row a codeword under one gain, counted by the chain whichever
  implementation ran them (K4, the plain version) under its label
  (``metric.demap.point_evals``: 4B rows blind, 2B pruned;
  ``demap.demap.point_evals``: B with known h);
* ``decode.cw_iters_needed`` and ``harness.launches``: counted by the
  ``Simulator`` as it consumes a launch, the iterations each codeword
  needed, summed (from the mean it reads anyway), and the launches.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
_stage = ""  # the chain label the host is in


def span(name: str):
    """A record function named ``name`` while a profiler records, else a
    null context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NULL


class label:
    """A chain label: a ``record_function`` while a profiler records, and
    the stage the counters inside it count under."""

    __slots__ = ("name", "outer", "inner")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        global _stage
        self.outer, _stage = _stage, self.name
        self.inner = _NULL
        if _profiler._is_profiler_enabled:
            self.inner = _profiler.record_function(self.name)
        self.inner.__enter__()

    def __exit__(self, *exc) -> None:
        global _stage
        _stage = self.outer
        self.inner.__exit__(*exc)


def count(name: str, n: int = 1, stage: str | None = None) -> None:
    """Adds ``n`` to counter ``name`` under ``stage`` (default: the chain
    label the host is in; outside every label, ``name`` alone)."""
    stage = _stage if stage is None else stage
    key = f"{stage}.{name}" if stage else name
    _counts[key] = _counts.get(key, 0) + n


def snapshot() -> dict[str, int]:
    return dict(_counts)


def reset() -> None:
    _counts.clear()


def exit_check(conv: torch.Tensor) -> bool:
    """A decoder loop's early exit: whether every codeword has converged.
    Reads the device (a host sync), counted under ``syncs``."""
    count("syncs")
    with span("exit_check"):
        return bool(conv.all())
