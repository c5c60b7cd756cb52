"""Readings that set a cell's limits, in one process on the card:

    python -m linkbench.control --workload <cell> --control-seeds 1,2,3 \
        [--sweeps N] [--program-seeds 4,5,...] [--faults unchanged,...] \
        [--fault-seeds 6,...] [--seconds S] [--out FILE]

* the control: the plain reference in bfloat16, the precision below the
  float32 the configurations state, put in the program's place on the
  launches and rows that a run with that seed samples in its first
  ``--sweeps`` sweeps (as many as the cell's window holds, at most
  ``judge.SAMPLED_SWEEPS``), judged against the float64 reference and
  the cell's limits exactly as a run's outputs are;
* the program: whole runs of the cell (``run_cell``), each printing every
  number the judge reads;
* faults: whole runs of the cell with a fault of ``faults.py`` planted in
  the decode, at the cell's own size.

Each reading is one JSON line on stdout (and in ``--out``), with the
verdict under ``correct``: the control and every fault must read false.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

CONTROL_DTYPE = torch.bfloat16


def _as_kept(rows):
    """A reference's rows in the program's place: its counters are those of
    its own decided words."""
    from .judge import Kept

    rows = type(rows)(*(None if f is None else f.cpu() for f in rows))
    errs = (rows.uu_hat != rows.uu).sum(1)
    return Kept(errs.sum(), (errs > 0).sum(), torch.tensor(rows.uu.shape[0]), rows.uu_hat,
                rows.metrics, rows.uu_hat, rows.converged, rows.iters, rows.soft)


def control_numbers(name: str, seed: int, device: str = "cuda",
                    overrides: dict | None = None, sweeps: int | None = None) -> dict:
    """The judge's numbers for the reference in ``CONTROL_DTYPE`` in the
    program's place, on the launches and rows that a run with ``seed``
    samples in its first ``sweeps`` sweeps."""
    from . import judge
    from .reference import chain as ref
    from .spec import load_cell

    cell = load_cell(name, overrides=overrides)
    sample = judge.Sample(cell, seed, sweeps=sweeps or judge.SAMPLED_SWEEPS)
    link, g = judge.reference_link(cell, torch.float64, device)
    low, g_low = judge.reference_link(cell, CONTROL_DTYPE, device)
    pairs = []
    with torch.no_grad():
        for s, (snr, launch) in sorted(sample.keys.items()):
            sweep = judge.sweep_seed(seed, s)
            rows = torch.tensor(sample.rows[s])
            out = _as_kept(ref.run_rows(low, g_low, sweep, snr, launch, rows))
            truth = ref.run_rows(link, g, sweep, snr, launch, rows)
            pairs.append((out, truth.uu.cpu(), truth))
    return judge.compare(pairs, cell.blind)[0]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="linkbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--sweeps", type=int, default=0)
    parser.add_argument("--program-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("linkbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    from .judge import SAMPLED_SWEEPS, verdict
    from .run import run_cell
    from .spec import load_cell

    cell = load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        def emit(line: dict) -> None:
            text = json.dumps(line)
            print(text, flush=True)
            if out is not None:
                out.write(text + "\n")
                out.flush()

        def run(kind: str, seed: int) -> None:
            r = run_cell(args.workload, seed, args.seconds, False)
            emit({"workload": args.workload, "kind": kind, "seed": seed,
                  "correct": r["correct"], "checks": r["checks"], "numbers": r["readings"],
                  "metrics": {k: v["value"] for k, v in r["metrics"].items()}})

        for seed in _seeds(args.control_seeds):
            sweeps = args.sweeps or SAMPLED_SWEEPS
            numbers = control_numbers(args.workload, seed, sweeps=sweeps)
            correct, checks = verdict(cell, numbers)
            emit({"workload": args.workload, "kind": "control-bfloat16", "seed": seed,
                  "sweeps": sweeps, "correct": correct, "checks": checks,
                  "numbers": numbers})
        for seed in _seeds(args.program_seeds):
            run("program", seed)
        if args.faults:
            from .faults import planted

            for name in args.faults.split(","):
                for seed in _seeds(args.fault_seeds):
                    with planted(name):
                        run(f"fault-{name}", seed)
    finally:
        if out is not None:
            out.close()
    return 0


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


if __name__ == "__main__":
    sys.exit(main())
