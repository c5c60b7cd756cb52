"""Benchmark: decoded info bits/s on one card across the ranked chain rows.

The counterpart of the repo's ``bench.py``:

    python -m kmldpc_torch.bench [--device cuda|cpu] [--rows-out FILE]
        [--batch N] [--cpl N] [--passes N]

Prints ONE JSON line on stdout:
    {"metric": ..., "value": N, "unit": "info_bits/s", "vs_baseline": N}

The headline is the blind pipeline (k-means, 4-candidate ambiguity metric,
50-iteration flooding decode) on PEG2304 R=1/2 + QPSK at 15 dB, in steady
state.  ``vs_baseline`` is its ratio to the single-core C++ reference in
``BASELINE_MEASURED.json``, measured on that file's ``machine`` (a CPU
host), not on this card's host; the stderr lines and the rows file name it.

The session calibration (``tools/rows.py``: the PEG2304 known-h chain at its
pinned shape) runs first, then the ranked rows of ``bench_rows()`` in rank
order, each at ``batch = row.batch or KMLDPC_BENCH_BATCH`` (1024) codewords
and ``cpl = row.cpl or KMLDPC_BENCH_CPL`` (16) sub-chunks a launch, in
``KMLDPC_BENCH_DTYPE`` (float32).  Each row goes to stderr as a
``bench-row {json}`` line; the rows, ``_calibration`` and ``_baseline`` are
written to ``--rows-out`` (default ``bench_torch/bench_rows_latest.json``
under the repo root).  A wall-clock budget (``KMLDPC_BENCH_BUDGET_S``, 840 s,
counted from the start of ``main``) lets every row after the first two
yield when under 150 s are left, each with a ``SKIPPED`` line: never
silently.

Differences from ``bench.py``: ``--device`` (default ``cuda``, which raises
without a card; never a switch to the CPU); ``--batch``, ``--cpl`` and
``--passes`` cut every row, the calibration included, for short checks,
and the rows file records them under ``_cut`` (a cut session factor is not
comparable with the anchor); the rows file's own path; and a calibration or
headline that fails ends the process non-zero with no stdout line.  No
profiler session runs in this process: launch-bound work ran slower after
one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable

import torch

from .device import resolve_device
from .tools.microbench import chain_call, fence
from .tools.rows import (
    CAL_NOMINAL_BLK_S,
    ChainRow,
    bench_rows,
    calibrated,
    calibration_row,
    pick_n2,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS_OUT = os.path.join(ROOT, "bench_torch", "bench_rows_latest.json")
BASELINE_FILE = os.path.join(ROOT, "BASELINE_MEASURED.json")
METRIC = ("blind decoded info bits/s/chip (PEG2304 R=1/2 QPSK, 15 dB, "
          "kmeans+metrics+50-iter BP)")
# the file's blind row, used where the file cannot be read (as bench.py does)
BASELINE_BLIND_BITS = 296.5 * 1152


def measure(call: Callable[[int], torch.Tensor], passes: int = 3, n1: int = 4,
            n2: int | None = None) -> tuple[float, float]:
    """Steady-state seconds per call: the median of ``passes`` two-point
    slopes, and their min-max spread over the median in percent.

    ``call(i)`` dispatches call ``i`` (launch ``i`` of a row's runner, so
    every call draws anew) and returns a 0-d tensor.  A run of n calls
    dispatches them back to back, sums their results and is fenced once;
    a pass times runs of ``n1`` and ``n2`` calls and takes
    ``(t2 - t1) / (n2 - n1)``, so a run's fixed cost cancels.  Warm-up
    times probes of 3 calls until two in a row agree within 15% (from the
    third probe on, at most 12); ``n2 = None`` sizes the long run from the
    last probe but one by :func:`pick_n2`.  A slope <= 0 (a stall in the
    short run) is discarded and the pass retried, up to ``2 * passes``
    attempts; with no positive slope the result is the last long run's
    time per call and a spread of 0.
    """
    def run(n: int, base: int) -> float:
        t0 = time.perf_counter()
        acc = call(base)
        for i in range(1, n):
            acc = acc + call(base + i)
        fence(acc)
        return time.perf_counter() - t0

    prev = None
    for i in range(12):
        dt = run(3, 3 * i)
        if prev is not None and i >= 2 and dt < prev * 1.15 and prev < dt * 1.15:
            break
        prev = dt
    if n2 is None:
        n2 = pick_n2(prev / 3 if prev else 0.0, n1)
    secs = []
    fallback = None
    for p in range(2 * passes):
        t1 = run(n1, 1_000 + 100 * p)
        t2 = run(n2, 5_000 + 100 * p)
        fallback = t2 / n2
        slope = (t2 - t1) / (n2 - n1)
        if slope > 0:
            secs.append(slope)
            if len(secs) == passes:
                break
    if not secs:
        return fallback, 0.0
    secs.sort()
    med = secs[len(secs) // 2]
    return med, (secs[-1] - secs[0]) / med * 100.0


def row_plan(batch: int | None = None, cpl: int | None = None) -> list[tuple[ChainRow, int, int]]:
    """``(row, batch, chunks a launch)`` in the order measured: the
    calibration row, then the ranked rows without it.  A row's own batch
    and cpl win over ``KMLDPC_BENCH_BATCH`` / ``KMLDPC_BENCH_CPL``; the
    ``batch`` and ``cpl`` cuts win over both."""
    batch_env = int(os.environ.get("KMLDPC_BENCH_BATCH", "1024"))
    cpl_env = int(os.environ.get("KMLDPC_BENCH_CPL", "16"))
    cal = calibration_row()
    rows = [cal] + [r for r in bench_rows() if r.name != cal.name]
    return [(r, batch or r.batch or batch_env, cpl or r.cpl or cpl_env) for r in rows]


def read_baseline(path: str = BASELINE_FILE) -> dict:
    """The reference's blind info bits/s and the host it was measured on."""
    base = {"file": os.path.basename(path), "machine": "unknown: the file was not read",
            "info_bits_per_s": BASELINE_BLIND_BITS}
    try:
        with open(path) as f:
            data = json.load(f)
        base["info_bits_per_s"] = data["blind"]["info_bits_per_s"]
        base["machine"] = data.get("machine", "not named in the file")
    except (OSError, ValueError, KeyError, TypeError):
        pass
    return base


def main(argv: list[str] | None = None) -> int:
    t_start = time.monotonic()
    budget = float(os.environ.get("KMLDPC_BENCH_BUDGET_S", "840"))

    def left() -> float:
        return budget - (time.monotonic() - t_start)

    ap = argparse.ArgumentParser(prog="kmldpc_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rows-out", default=ROWS_OUT, help="where to write the rows JSON")
    ap.add_argument("--batch", type=int, default=None, help="cut: codewords a sub-chunk, every row")
    ap.add_argument("--cpl", type=int, default=None, help="cut: sub-chunks a launch, every row")
    ap.add_argument("--passes", type=int, default=None, help="cut: slope passes a row (default 3)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = os.environ.get("KMLDPC_BENCH_DTYPE", "float32")
    cut = {k: v for k, v in (("batch", args.batch), ("cpl", args.cpl), ("passes", args.passes))
           if v is not None}
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    batch_env = int(os.environ.get("KMLDPC_BENCH_BATCH", "1024"))
    note = (" cut " + " ".join(f"{k}={v}" for k, v in cut.items())
            + " (every row and the calibration; its factor is not comparable with the anchor)"
            if cut else "")
    print(f"bench: device={name} batch={batch_env} budget={budget:.0f}s{note}", file=sys.stderr)

    rows_out: dict = {"device": name}
    if cut:
        rows_out["_cut"] = cut
    headline_bits = None
    cal_factor = 0.0
    for i, (r, batch, cpl) in enumerate(row_plan(args.batch, args.cpl)):
        # the calibration and the headline are mandatory; later rows yield
        # to the budget, never silently
        if i >= 2 and left() < 150:
            print(f"bench: SKIPPED {r.name} (budget: {left():.0f}s left)", file=sys.stderr)
            continue
        call, code_dim = chain_call(r, batch, cpl, device, seed=i, dtype=dtype)
        sec, spread = measure(call, args.passes or 3)
        sec /= cpl
        blk_s = batch / sec
        bits_s = blk_s * code_dim
        if i == 0:
            cal_factor = blk_s / CAL_NOMINAL_BLK_S
            rows_out["_calibration"] = {
                "row": r.name, "blocks_per_s": round(blk_s, 1),
                "nominal_blocks_per_s": CAL_NOMINAL_BLK_S,
                "factor": round(cal_factor, 4),
            }
            print(f"bench: calibration {blk_s:,.0f} blk/s -> session factor "
                  f"{cal_factor:.3f}", file=sys.stderr)
        row = {
            "blocks_per_s": round(blk_s, 1),
            "info_bits_per_s": round(bits_s, 1),
            "calibrated": round(calibrated(blk_s, "blocks_per_s", cal_factor), 1),
            "spread_pct": round(spread, 1),
            "batch": batch, "chunks_per_launch": cpl, "snr_db": r.snr_db,
            "schedule": r.schedule,
        }
        rows_out[r.name] = row
        print("bench-row " + json.dumps({"row": r.name, **row}), file=sys.stderr)
        if r.bench_rank == 0:
            headline_bits = bits_s

    base = read_baseline()
    rows_out["_baseline"] = base
    print(f"bench: vs_baseline is over {base['file']}'s blind "
          f"{base['info_bits_per_s']:,.1f} info bits/s, the single-core C++ reference "
          f"measured on {base['machine']}, not on this card's host", file=sys.stderr)
    try:
        os.makedirs(os.path.dirname(os.path.abspath(args.rows_out)), exist_ok=True)
        with open(args.rows_out, "w") as f:
            json.dump(rows_out, f, indent=1)
            f.write("\n")
    except OSError as e:
        print(f"bench: could not write {args.rows_out}: {e}", file=sys.stderr)

    print(json.dumps({
        "metric": METRIC,
        "value": round(headline_bits, 1),
        "unit": "info_bits/s",
        "vs_baseline": round(headline_bits / base["info_bits_per_s"], 2),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
