"""Microbenchmarks on the card: µs a decoder iteration, µs a blind
estimate, blk/s of whole chain pipelines.

The counterpart of the JAX side's ``tools/microbench.py``, with its groups,
keys and fields:

    python -m kmldpc_torch.tools.microbench [group ...] [--json out.json]
        [--diff base.json] [--passes N] [--no-calibration] [--batch B]
        [--cpl N] [--iters N] [--device cuda|cpu]

Groups (default: all three):
    decoder   µs/iteration of each decode schedule per code, at an SNR low
              enough that no codeword converges (so cost = ``iters`` sweeps)
    kmeans    µs per 20-iteration blind estimate, plain PyTorch against K1
              (``cuda``, on a card only)
    chain     blk/s of whole chunk pipelines, one row of ``rows.py``'s
              table each; ``chain:<substr>`` runs the rows whose name holds
              ``<substr>``

Every session first times the calibration program (``rows.py``: the
PEG2304 known-h chain at its pinned shape) and stamps each row's primary
metric divided by the session factor as ``calibrated``; ``--no-calibration``
skips it.  One difference from the JAX tool: a calibration that fails to
build or to run fails the session, where the JAX tool carries on with raw
metrics only.

Inputs are drawn on the device from a generator seeded by the call index,
so every call gets its own.  ``steady`` fences a batch of calls with
``torch.cuda.synchronize`` and times the two-point slope, so the fixed cost
of a batch cancels.  The default device is ``cuda``; without a card that is
an error, never a switch to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable

import torch

from ..config import default_asset_dir
from ..device import resolve_device
from .rows import (
    CAL_NOMINAL_BLK_S,
    CHAIN_ROWS,
    ChainRow,
    calibrated,
    calibration_row,
    make_spec,
    pick_n2,
)

ASSETS = default_asset_dir()
# the JAX tool's order, most important first
CODES = (
    ("PEG8064", "PEG8064regular0.5.txt"),
    ("5G-BG2-K960", "5GLDPCBG2a3_R12_K960.txt"),
    ("PEG2304", "PEG2304regular0.5.txt"),
)
CONSTELLATIONS = (  # (name, table, divisor of nsym)
    ("QPSK", "2bits_QPSK.txt", 1),
    ("16QAM", "4bit_16QAM_Gray.txt", 2),
    ("64QAM", "6bits_64QAM_Gray.txt", 3),
)
_PRIMARY = ("us_per_iter", "us_per_call", "blocks_per_s")


def _save(results: dict, path: str | None) -> None:
    """Write ``results`` to ``path`` (if given) through a temp file, after
    every row, so a run cut short keeps the rows it finished."""
    if path:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)


def fence(acc: torch.Tensor) -> None:
    """Wait for the work ``acc`` depends on: CUDA kernels run behind the
    host, so sync the card; CPU ones ran before the call returned, and
    reading the value is enough."""
    if acc.device.type == "cuda":
        torch.cuda.synchronize(acc.device)
    else:
        acc.item()


def steady(fn: Callable[[int], torch.Tensor], n1: int = 6, n2: int | None = None,
           passes: int = 1) -> tuple[float, float]:
    """Steady-state seconds per call via a two-point slope.

    ``fn(i)`` dispatches the device work of call ``i`` and returns a 0-d
    tensor derived from all of it; inputs must differ from call to call
    (seed them by ``i``).  A run of n calls sums their results and is
    fenced once, so the (n2 - n1)-call slope cancels the fixed cost of a
    run.  An adaptive warm-up runs probes of 3 calls until two in a row
    agree within 15%.  ``n2 = None`` sizes the long run from the warm-up by
    :func:`pick_n2` (at least 18).  ``passes > 1`` repeats the slope that
    many times and quotes the median; a pass whose slope is <= 0 (a stall
    in the short run) is discarded and retried, up to ``2 * passes`` runs.

    Returns ``(sec_per_call_median, spread_pct)``: the spread of the passes
    over the median, 0.0 for one pass; with no positive slope, the long
    run's time per call and 0.0.
    """
    def run(n: int, base: int) -> float:
        t0 = time.perf_counter()
        acc = fn(base)
        for i in range(1, n):
            acc = acc + fn(base + i)
        fence(acc)
        return time.perf_counter() - t0

    prev = None
    for probe in range(10):
        dt = run(3, 1_000 + 3 * probe)
        if prev is not None and probe >= 1 and dt < prev * 1.15 and prev < dt * 1.15:
            break
        prev = dt
    if n2 is None:
        n2 = max(18, pick_n2(prev / 3 if prev else 0.0, n1))
    vals = []
    fallback = None
    for p in range(2 * passes):
        t1 = run(n1, 2_000 + 200 * p)
        t2 = run(n2, 3_000 + 200 * p)
        fallback = t2 / n2
        slope = (t2 - t1) / (n2 - n1)
        if slope > 0:
            vals.append(slope)
            if len(vals) == passes:
                break
    if not vals:
        return fallback, 0.0
    vals.sort()
    med = vals[len(vals) // 2]
    spread = (vals[-1] - vals[0]) / med * 100.0 if len(vals) > 1 else 0.0
    return med, spread


def device_name(device: torch.device) -> str:
    """The torch device, and the card's name on CUDA."""
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def seeded_normal(seed: int, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """N(0,1) float32 draws of ``shape`` on ``device``, from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def decoder_rows(code, device: torch.device) -> list[tuple[str, Callable, object]]:
    """``(label, decode(tables, llr, iters), tables)`` for each schedule the
    JAX tool times on ``code``."""
    from ..decoder import (
        DecoderTables,
        flooding_decode,
        flooding_decode_em,
        layered_minsum_decode,
        minsum_tables,
    )

    dt = DecoderTables.from_code(code, device)
    mt = minsum_tables(code, device=device)
    rows = [
        ("flooding", flooding_decode, dt),
        # the production layout (slot-major / degree-class core used by the
        # chain's two-phase path)
        ("flooding[em]", flooding_decode_em, dt),
        ("flooding-minsum[em]",
         lambda t, llr, it: flooding_decode_em(t, llr, it, cn_rule="minsum"), dt),
        (f"minsum[{'qc' if mt.qc else 'generic'}]",
         lambda t, llr, it: layered_minsum_decode(t, llr, it, 0.75), mt),
    ]
    if mt.qc is not None:
        rows.append(("minsum[generic]", rows[-1][1],
                     minsum_tables(code, use_qc=False, device=device)))
    return rows


def bench_decoders(results: dict, batch: int = 1024, iters: int = 20, passes: int = 1,
                   device: torch.device | str = "cuda", codes=CODES, n1: int = 6,
                   n2: int | None = None, json_path: str | None = None) -> None:
    """``decoder/<code>/<label>`` rows: µs a decoder iteration at ``batch``
    codewords of 0.3·N(0,1) LLRs, too weak to converge."""
    from ..code import load_code

    device = resolve_device(device)
    for name, fname in codes:
        code = load_code(os.path.join(ASSETS, fname))
        tx_len = code.num_col - code.punct

        for label, decode, tabs in decoder_rows(code, device):
            def call(i: int, decode=decode, tabs=tabs) -> torch.Tensor:
                llr = 0.3 * seeded_normal(7 << 32 | i, (batch, tx_len), device)
                return decode(tabs, llr, iters).iters.sum()

            sec, spread = steady(call, n1, n2, passes)
            us_per_iter = sec / iters * 1e6
            key = f"decoder/{name}/{label}"
            results[key] = {"us_per_iter": round(us_per_iter, 1),
                            "spread_pct": round(spread, 1),
                            "batch": batch, "iters": iters}
            _save(results, json_path)
            print(f"{key}: {us_per_iter:.0f} us/iter ±{spread:.1f}% "
                  f"({sec*1e3:.2f} ms / {iters} iters, B={batch})", file=sys.stderr)


def kmeans_impls(tables, device: torch.device, iters: int = 20) -> dict:
    """The blind estimators the ``kmeans`` group times: ``plain`` (the JAX
    tool's ``jax`` row) everywhere, and K1 (``cuda``, its ``pallas`` row)
    on a card, where a K1 that fails to build or launch fails the run."""
    from ..detect import make_blind_estimator, make_blind_estimator_cuda

    impls = {"plain": make_blind_estimator(tables, iters, "max")}
    if device.type == "cuda":
        impls["cuda"] = make_blind_estimator_cuda(tables, iters, "max")
    return impls


def bench_kmeans(results: dict, batch: int = 1024, nsym: int = 1152, passes: int = 1,
                 device: torch.device | str = "cuda", n1: int = 6, n2: int | None = None,
                 json_path: str | None = None) -> None:
    """``kmeans/<const>/<impl>`` rows: µs a 20-iteration blind estimate of
    ``batch`` rows of N(0,1) symbols, ``nsym`` QPSK symbols a row (half for
    16QAM, a third for 64QAM)."""
    from ..io import parse_constellation
    from ..ops import ModemTables

    device = resolve_device(device)
    for cname, fname, div in CONSTELLATIONS:
        n = nsym // div
        tables = ModemTables.from_constellation(
            parse_constellation(os.path.join(ASSETS, fname)), device)
        for impl, est in kmeans_impls(tables, device).items():
            def call(i: int, est=est) -> torch.Tensor:
                y = seeded_normal(3 << 32 | i, (2, batch, n), device)
                hr, hi = est(y[0], y[1])
                return hr.sum() + hi.sum()

            sec, spread = steady(call, n1, n2, passes)
            key = f"kmeans/{cname}/{impl}"
            results[key] = {"us_per_call": round(sec * 1e6, 1),
                            "spread_pct": round(spread, 1),
                            "batch": batch, "nsym": n}
            _save(results, json_path)
            print(f"{key}: {sec*1e6:.0f} us/call ±{spread:.1f}% "
                  f"(B={batch}, {n} sym)", file=sys.stderr)


def chain_call(row: ChainRow, batch: int, cpl: int, device: torch.device,
               seed: int, dtype: str = "float32") -> tuple[Callable[[int], torch.Tensor], int]:
    """``(call, code_dim)`` of one chain row: ``call(i)`` runs launch ``i``
    of ``cpl`` sub-chunks of ``batch`` codewords at the row's SNR and
    returns its block errors, a 0-d tensor.  ``dtype`` is the message
    storage a row without its own takes."""
    import numpy as np

    from ..sim import make_chunk_runner

    spec = make_spec(row, ASSETS, dtype=dtype)
    runner = make_chunk_runner(spec, batch, cpl, device, seed=seed)
    var = float(np.float32(10.0 ** (-0.1 * row.snr_db)))
    return (lambda i: runner(row.snr_db, i, var).err_blk), spec.code.code_dim


def run_calibration(results: dict, passes: int = 3, device: torch.device | str = "cuda",
                    cpl: int | None = None, n1: int = 6, n2: int | None = None,
                    json_path: str | None = None) -> float:
    """Time the calibration program (``rows.calibration_row``: the PEG2304
    known-h chain at its pinned batch and chunks a launch, 15 dB, float32)
    and record the session factor, its blk/s over ``CAL_NOMINAL_BLK_S``,
    under ``_calibration``.  Returns the factor.

    ``cpl`` cuts the chunks a launch of a short check run; the anchor was
    measured at the pinned shape.  Unlike the JAX tool's, a calibration
    that fails raises: a session without one fails.
    """
    r = calibration_row()
    cpl = cpl or r.cpl
    call, _ = chain_call(r, r.batch, cpl, resolve_device(device), seed=42)
    sec, spread = steady(call, n1, n2, passes)
    blk_s = r.batch * cpl / sec
    factor = blk_s / CAL_NOMINAL_BLK_S
    results["_calibration"] = {
        "row": r.name, "blocks_per_s": round(blk_s, 1),
        "nominal_blocks_per_s": CAL_NOMINAL_BLK_S,
        "factor": round(factor, 4), "spread_pct": round(spread, 1),
    }
    _save(results, json_path)
    print(f"calibration: {blk_s:,.0f} blk/s -> session factor {factor:.3f} "
          f"±{spread:.1f}%", file=sys.stderr)
    return factor


def apply_calibration(results: dict) -> None:
    """Stamp each row's ``calibrated`` primary metric from ``_calibration``."""
    factor = results.get("_calibration", {}).get("factor", 0.0)
    if not factor:
        return
    for k, row in results.items():
        if not isinstance(row, dict) or k == "_calibration":
            continue
        for m in _PRIMARY:
            if m in row:
                row["calibrated"] = round(calibrated(row[m], m, factor), 1)
                break


def bench_chain(results: dict, only: str | None = None, passes: int = 3,
                device: torch.device | str = "cuda", batch: int | None = None,
                cpl: int | None = None, rows: list[ChainRow] = CHAIN_ROWS, n1: int = 6,
                n2: int | None = None, json_path: str | None = None) -> None:
    """``chain/<name>`` rows: blk/s of each row of ``rows`` whose name holds
    ``only``, through ``make_chunk_runner`` at ``batch`` codewords and
    ``cpl`` sub-chunks a launch (default: the row's own, else 1024 and
    16), call i being launch i."""
    device = resolve_device(device)
    for r in rows:
        if only and only not in r.name:
            continue
        b = batch or r.batch or 1024
        n = cpl or r.cpl or 16
        call, code_dim = chain_call(r, b, n, device, seed=0)
        sec, spread = steady(call, n1, n2, passes)
        blk_s = b * n / sec
        results[f"chain/{r.name}"] = {
            "blocks_per_s": round(blk_s, 1),
            "info_bits_per_s": round(blk_s * code_dim, 1),
            "spread_pct": round(spread, 1),
            "batch": b, "chunks_per_launch": n, "snr_db": r.snr_db,
        }
        _save(results, json_path)
        print(f"chain/{r.name}: {blk_s:,.0f} blk/s ±{spread:.1f}% "
              f"({sec/n*1e3:.2f} ms/chunk, B={b} cpl={n})", file=sys.stderr)


def diff_against(results: dict, baseline_path: str) -> list[dict]:
    """Print (and return) a per-row regression report against a baseline
    JSON, as the JAX tool's ``diff_against``.

    Rows sharing a key are compared on their primary metric (us_per_iter /
    us_per_call: lower is better; blocks_per_s: higher is better), on the
    ``calibrated`` value where both sides carry one.  Rows present on only
    one side are listed.
    """
    with open(baseline_path) as f:
        base = json.load(f)
    keys = sorted((set(base) | set(results)) - {"device", "_calibration"})
    print(f"--- diff vs {baseline_path} ---", file=sys.stderr)
    report: list[dict] = []
    for k in keys:
        b, r = base.get(k), results.get(k)
        if b is None or r is None:
            note = "NEW" if b is None else "MISSING (was in baseline)"
            print(f"{k}: {note}", file=sys.stderr)
            report.append({"row": k, "note": note})
            continue
        for m in _PRIMARY:
            if m in b and m in r and b[m]:
                better_low = m.startswith("us_")
                use_cal = "calibrated" in b and "calibrated" in r and b["calibrated"]
                bv, rv = (b["calibrated"], r["calibrated"]) if use_cal else (b[m], r[m])
                change = (rv - bv) / bv * 100.0
                word = ("slower" if change > 0 else "faster") if better_low else \
                       ("faster" if change > 0 else "slower")
                label = f"{m}[calibrated]" if use_cal else m
                print(f"{k}: {label} {bv:,} -> {rv:,} ({abs(change):.1f}% {word})",
                      file=sys.stderr)
                report.append({"row": k, "metric": label, "base": bv, "new": rv,
                               "change_pct": change, "worse": (change > 0) == better_low})
                break
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmldpc_torch.tools.microbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("groups", nargs="*", default=[],
                    help="decoder kmeans chain (default all); or chain:<substr>")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--diff", default=None, help="baseline JSON to report per-row changes against")
    ap.add_argument("--passes", type=int, default=None,
                    help="interleaved slope passes per row (median + spread; "
                         "default: 3 for chain and the calibration, 1 for decoder/kmeans)")
    ap.add_argument("--no-calibration", action="store_true",
                    help="skip the session-calibration program (rows then "
                         "carry raw metrics only)")
    ap.add_argument("--batch", type=int, default=None,
                    help="codewords (rows) a call (default: 1024; a chain row's own)")
    ap.add_argument("--cpl", type=int, default=None,
                    help="sub-chunks a chain launch (default: the row's own, else 16)")
    ap.add_argument("--iters", type=int, default=20, help="decoder iterations a call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_intermixed_args(argv)
    groups = args.groups or ["decoder", "kmeans", "chain"]
    for g in groups:
        if g not in ("decoder", "kmeans", "chain") and not g.startswith("chain:"):
            raise SystemExit(f"unknown group {g!r}")
    device = resolve_device(args.device)
    name = device_name(device)
    print(f"microbench: device={name}", file=sys.stderr)
    results: dict = {"device": name}
    if not args.no_calibration:
        run_calibration(results, args.passes or 3, device, json_path=args.json)
    for g in groups:
        if g == "decoder":
            bench_decoders(results, args.batch or 1024, args.iters, args.passes or 1, device,
                           json_path=args.json)
        elif g == "kmeans":
            bench_kmeans(results, args.batch or 1024, passes=args.passes or 1, device=device,
                         json_path=args.json)
        else:
            bench_chain(results, g.partition(":")[2] or None, args.passes or 3, device,
                        args.batch, args.cpl, json_path=args.json)
    apply_calibration(results)
    _save(results, args.json)
    if args.diff:
        diff_against(results, args.diff)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
