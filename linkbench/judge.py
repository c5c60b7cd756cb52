"""``correct``: the timed path's own outputs on a sample of its launches,
against the plain reference (``reference/``) in float64.

The sample is drawn from ``--seed`` before the window opens: in each of
the first ``SAMPLED_SWEEPS`` sweeps one launch, at an SNR point taken in
a seeded order that visits every point before any repeats, and of that
launch ``SAMPLE_ROWS`` codewords, or the ``rows`` of the traffic file's
``[sample]`` table.  ``keep`` takes the launch's result as
the runner returns it and holds, on the device, its counters, every
decided word and the sampled rows' outputs.  After the window the
reference redraws each sampled launch from its chunk seeds and computes
the sampled rows again.  The numbers, of which a cell compares those its
traffic file gives limits for:

* ``counter_gap``: the launch's error counters (blocks, bits, codewords)
  against those its own decided words give against the drawn bits, over
  every codeword of the launch; exact.
* ``select_gap`` (blind cells): share of codewords whose chosen ĥ
  candidate (first smallest |metric|) differs from the reference's.
* ``decode_gap``: share of codewords where convergence differs, or where
  the reference converged and the decided bits differ.  A codeword
  neither side decodes is judged by its counters only: its bits after
  the last iteration follow the rounding.
* ``iters_gap``: share of codewords both sides decode in a different
  number of iterations: the count that ``decode_roofline`` takes as the
  decode's work.
* ``soft_gap``: 90th percentile over codewords of the largest difference
  of their soft syndromes (frozen at convergence), over the codewords both
  sides decode alike in the same number, two or more, of iterations, and
  1 for each codeword decoded differently (as ``decode_gap`` counts them).
* ``metric_gap`` (blind cells): 90th percentile over codewords of the
  relative difference of the smallest |metric|, the chosen candidate's.
  The others' are not compared: a soft metric sums the logs of soft
  syndromes, and a check that float32 rounds to a syndrome of 0 makes a
  wrong candidate's metric infinite where float64 gives some tens.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import torch

from .reference import chain as ref
from .reference.code import load_code, load_constellation
from .spec import Cell, derived_seed

SAMPLED_SWEEPS = 8
SAMPLE_ROWS = 2048


class Kept(NamedTuple):
    """One sampled launch as the side under judgement produced it."""

    err_bit: torch.Tensor  # 0-d
    err_blk: torch.Tensor  # 0-d
    tot_blk: torch.Tensor  # 0-d
    words: torch.Tensor  # [N, K] every decided word of the launch
    metrics: torch.Tensor | None  # [n, 4] |metric| of each candidate, None if known-h
    uu_hat: torch.Tensor  # [n, K] the sampled rows
    converged: torch.Tensor  # [n]
    iters: torch.Tensor  # [n]
    soft: torch.Tensor  # [n, R] soft syndrome, frozen at convergence


def sweep_seed(seed: int, sweep: int) -> int:
    return derived_seed(seed, "sweep", sweep)


class Sample:
    """Which launch of which sweep, and which of its rows, are judged."""

    def __init__(self, cell: Cell, seed: int, device="cpu", sweeps: int = SAMPLED_SWEEPS):
        rng = random.Random(derived_seed(seed, "sample"))
        order = list(cell.points)
        rng.shuffle(order)
        rows = cell.batch * cell.subs
        n = min(cell.sample_rows or SAMPLE_ROWS, rows)
        self.cell, self.seed = cell, seed
        self.keys = {}  # sweep -> (snr, launch)
        self.rows = {}  # sweep -> sorted row indices
        for s in range(sweeps):
            self.keys[s] = (order[s % len(order)], rng.randrange(cell.launches_per_point))
            self.rows[s] = sorted(rng.sample(range(rows), n))
        # the row indices on the program's device, made before the window
        self.index = {k: torch.tensor(v, device=device) for k, v in self.rows.items()}
        self.kept: dict = {}  # sweep -> Kept

    def keep(self, sweep: int, launches: list, res) -> None:
        """The runner's hook: hold the sampled launch's outputs, if this
        call ran it (a folded dispatch: its first slot that did)."""
        key = self.keys.get(sweep)
        if key is None or sweep in self.kept or key not in launches:
            return
        j = launches.index(key)
        pick = (lambda x: x[j]) if self.cell.folded else (lambda x: x)  # noqa: E731
        raw = res.raw
        take = lambda x: pick(x).index_select(0, self.index[sweep])  # noqa: E731
        self.kept[sweep] = Kept(
            err_bit=pick(res.err_bit), err_blk=pick(res.err_blk),
            tot_blk=pick(torch.as_tensor(res.tot_blk)),
            words=pick(raw.uu_hat).clone(memory_format=torch.contiguous_format),
            metrics=take(res.metrics) if self.cell.blind else None,
            uu_hat=take(raw.uu_hat), converged=take(raw.converged), iters=take(raw.iters),
            soft=take(raw.soft_syndrome),
        )

    def on_host(self) -> dict:
        """The kept outputs on the host, by sweep; the device's copies freed."""
        out = {s: Kept(*(None if f is None else f.cpu() for f in k))
               for s, k in self.kept.items()}
        self.kept.clear()
        return out


def reference_link(cell: Cell, dtype: torch.dtype, device) -> tuple:
    code = load_code(cell.matrix_path())
    const = load_constellation(cell.modem_path())
    link = ref.Link.from_tables(cell.tables, code, const, dtype, device)
    return link, ref.Graph(code, link.device)


def _p90(xs: list[torch.Tensor]) -> float:
    """90th percentile (nearest rank) of the values in ``xs``; 0 where
    there are none."""
    x = torch.cat(xs).double().sort().values if xs else torch.zeros(0)
    if x.numel() == 0:
        return 0.0
    return float(x[max(0, math.ceil(0.9 * x.numel()) - 1)])


def compare(pairs: list[tuple[Kept, torch.Tensor, ref.Rows]], blind: bool) -> tuple[dict, int]:
    """Every number the judge can compare over the sampled launches, and
    the launches whose counters disagree: ``pairs`` holds each launch's
    kept outputs, its drawn bits [N, K] and the reference's sampled rows."""
    counter_gap = select_miss = decode_miss = iters_miss = words = bad = 0
    soft, metric = [], []
    for p, bits, r in pairs:
        errs = (p.words != bits).sum(1)
        gap = (abs(int(p.err_blk) - int((errs > 0).sum()))
               + abs(int(p.err_bit) - int(errs.sum())) + abs(int(p.tot_blk) - bits.shape[0]))
        counter_gap += gap
        bad += gap > 0
        conv_r, iters_r = r.converged.cpu(), r.iters.cpu()
        diff_bits = (p.uu_hat != r.uu_hat.cpu()).any(1)
        diff_iters = p.iters.long() != iters_r
        outcome = (p.converged != conv_r) | (conv_r & diff_bits)
        decode_miss += int(outcome.sum())
        iters_miss += int((p.converged & conv_r & diff_iters).sum())
        # the soft syndromes of codewords both sides decode alike after two
        # iterations or more; a codeword decoded differently counts as 1
        alike = p.converged & conv_r & ~diff_iters & ~diff_bits & (iters_r >= 2)
        gap_w = (p.soft.double() - r.soft.cpu().double()).abs().amax(1)
        soft.append(torch.cat([gap_w[alike], torch.ones(int(outcome.sum()), dtype=gap_w.dtype)]))
        if blind:
            m_r = r.metrics.cpu().double()
            select_miss += int((p.metrics.argmin(1) != m_r.argmin(1)).sum())
            best_p, best_r = p.metrics.double().amin(1), m_r.amin(1)
            metric.append((best_p - best_r).abs() / best_r.clamp(min=1.0))
        words += r.uu.shape[0]
    words = max(words, 1)
    numbers = {"counter_gap": float(counter_gap)}
    if blind:
        numbers["select_gap"] = select_miss / words
        numbers["metric_gap"] = _p90(metric)
    numbers["decode_gap"] = decode_miss / words
    numbers["iters_gap"] = iters_miss / words
    numbers["soft_gap"] = _p90(soft)
    numbers["soft_words"] = float(sum(int(x.numel()) for x in soft))
    numbers["sampled_words"] = float(words)
    return numbers, bad


def reference_pairs(sample: Sample, kept: dict, link, g) -> list:
    """(kept, drawn bits, reference rows) of each sampled launch."""
    pairs = []
    with torch.no_grad():
        for s, k in sorted(kept.items()):
            snr, launch = sample.keys[s]
            seed = sweep_seed(sample.seed, s)
            rows = torch.tensor(sample.rows[s])
            bits = ref.launch_bits(link, seed, snr, launch).cpu()
            pairs.append((k, bits, ref.run_rows(link, g, seed, snr, launch, rows)))
    return pairs


def verdict(cell: Cell, numbers: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}): every number the cell's traffic
    file gives a limit for is at most that limit."""
    checks = {k: {"value": numbers[k], "limit": v} for k, v in cell.limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def judge(sample: Sample, kept: dict, link, g) -> tuple[bool, dict, dict, int]:
    """(correct, {number: {value, limit}} of the numbers the cell compares,
    every number, launches with wrong counters) for the host-side ``kept``
    outputs {sweep: Kept} of ``sample``, against the float64 reference
    ``link``, ``g`` (``reference_link``)."""
    numbers, bad = compare(reference_pairs(sample, kept, link, g), sample.cell.blind)
    correct, checks = verdict(sample.cell, numbers)
    return bool(kept) and correct, checks, numbers, bad
