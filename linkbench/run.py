"""``python -m linkbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

One run of one cell of ``BENCHMARK.json`` on the H100:

1. Set-up (``setup_s``, from the start of ``main``): import the port, load
   its kernels and code tables from the fixed cache directories inside the
   checkout (``build/``, ``.cache/``), and run one whole sweep at a seed
   the window never uses, so that every shape the cell's traffic uses,
   phase 2's tiles included, has run once.
2. Window (window.py): whole sweeps through ``Simulator.simulate()``, back
   to back, each at its own ``[tpu] seed`` drawn from ``--seed`` and the
   sweep's index, until the sweep running when ``--seconds`` have passed
   has ended.  Logs and checkpoints go to a directory of the run's own
   under ``TMPDIR``, removed at the end.  ``--trace 1`` profiles the
   window's first sweep (trace.py).
3. ``correct``: the sampled launches' outputs against the plain reference
   (judge.py), after the window, with the program's state freed.
4. Standard error: the card's clocks, power limit and temperature and the
   host's load average before and after the window, the sweep times, every
   number the judge read, then each number compared beside its limit as
   the last lines.  Standard output: one JSON line, the compared numbers
   under ``checks``, its last key.

A run refuses the CPU: it exits with 2 and prints no result when no card,
or too few, is visible.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

# top-level module names the process may not hold once the window has closed:
# JAX, the JAX package, and the JAX package's tools and benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "kmldpc_tpu", "tools", "benchmarks", "bench")
SMI_FIELDS = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def host_line(when: str) -> str:
    """The card's clocks, power and temperature and the host's load average."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi unavailable ({type(e).__name__})"
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return f"host {when}: {SMI_FIELDS} = {smi}; load average {load}; cpus {os.cpu_count()}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, t_start: float | None = None,
             log=lambda line: None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``device="cpu"`` serves the tests only; ``overrides`` are merged into
    the cell's tables (tests, and the batch sweep in PERF.md)."""
    t_start = time.monotonic() if t_start is None else t_start
    import torch

    from kmldpc_torch.config import config_from_dict
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    from . import judge
    from .roofline import fp32_ops_per_s
    from .spec import ASSETS, benchmark, derived_seed, load_cell, metric_reader
    from .trace import Tracer
    from .window import Window, run_window

    bench = benchmark()
    cell = load_cell(name, bench, overrides)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory(prefix="linkbench-") as scratch:
        def new_simulator(sweep_seed: int, tag) -> Simulator:
            cfg = config_from_dict(
                cell.sweep_tables(sweep_seed, os.path.join(scratch, f"checkpoint-{tag}.json")),
                asset_dir=str(ASSETS))
            logger = SimLogger(log_dir=os.path.join(scratch, f"logs-{tag}"), stdout=False)
            return Simulator(cfg, logger, device=dev)

        # -- set-up: one whole sweep at a seed the window never draws ----------
        sim = new_simulator(derived_seed(seed, "warm"), "warm")
        try:
            sim.simulate()
        finally:
            sim.close()
        del sim
        tracer = None
        if trace:
            tracer = Tracer(sync, cell.batch * cell.subs)
            if cuda:
                Tracer.warm()
        sync()
        gc.collect()
        setup_s = time.monotonic() - t_start

        # -- the window ---------------------------------------------------------
        log(host_line("before the window"))
        window = Window(seconds)
        sample = judge.Sample(cell, seed, dev)
        run_window(window, lambda s: new_simulator(judge.sweep_seed(seed, s), s),
                   sample.keep, tracer, sync)
        log(host_line("after the window"))
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary() if tracer is not None else None
    kept = sample.on_host()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sweeps = window.sweep_seconds()
    log(f"sweeps: {len(sweeps)} of {window.sweeps[0].blocks} blocks in {window.span()!r} s; "
        f"seconds {[round(x, 4) for x in sweeps]}; spread {window.sweep_spread()!r} "
        f"(interquartile range over median); set-up {setup_s!r} s")

    # -- correct ------------------------------------------------------------------
    link, g = judge.reference_link(cell, torch.float64, dev)
    correct, checks, readings, bad = judge.judge(sample, kept, link, g)
    log(f"readings: {json.dumps(readings)}")

    # -- metrics ------------------------------------------------------------------
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not trace:
        values = {"blocks_per_s": window.blocks_per_s, "setup_s": lambda: setup_s}
        for metric in cell.end_to_end:
            metrics[metric] = {"value": values[metric](), "unit": units[metric]}
    else:
        # what any per-layer reader may take beside the trace summary
        ctx = {"cell": cell, "seed": seed, "window": window, "link": link, "graph": g,
               "memory_peak": memory_peak, "ops_per_s": fp32_ops_per_s() if cuda else None}
        for metric in cell.per_layer:
            value = metric_reader(metric).read(summary, ctx)
            if value is not None:
                metrics[metric] = {"value": value, "unit": units[metric]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": correct, "attempted": window.launches(), "failed": bad,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": _top10(summary.by_kernel),
                               "idle_gaps": _top10(summary.idle_by_host)}
    result["readings"] = readings
    result["sweep_seconds"] = sweeps
    result["checks"] = checks
    return result


def _top10(seconds: dict) -> list:
    """The ten largest entries, names cut to 160 characters (kernel names
    spell out their template arguments)."""
    return [[k[:160], v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:10]]


def main(argv: list[str] | None = None) -> int:
    t_start = time.monotonic()
    parser = argparse.ArgumentParser(prog="linkbench")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch

    from .spec import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"linkbench: needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    def log(line: str) -> None:
        print(f"linkbench: {line}", file=sys.stderr, flush=True)

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=t_start, log=log)
    found = forbidden_modules()
    if found:
        log(f"the process holds {found} after the window: no result")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
