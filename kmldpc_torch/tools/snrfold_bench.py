"""Wall-clock A/B of ``[tpu] snr_fold`` on a short many-point sweep.

The counterpart of the JAX side's ``tools/snrfold_bench.py``, with its
config, runs, keys and fields:

    python -m kmldpc_torch.tools.snrfold_bench [--json f] [--blocks N]
        [--batch B] [--device cuda|cpu]

A 7-point known-h PEG2304 QPSK sweep (0-30 dB, ``--blocks`` blocks a
point) runs sequentially and folded 7 points a dispatch.  Each Simulator
runs its sweep once to warm up, then the second sweep is timed (host
clock, ended by a synchronise of the card).  The per-point counters of the
two must be bitwise equal, else the tool raises.  The default device is
``cuda``; without a card that is an error, never a switch to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..config import Config, config_from_dict, default_asset_dir
from ..device import resolve_device
from .microbench import _save, device_name


def build_cfg(snr_fold: int, blocks: int = 4096, batch: int = 1024) -> Config:
    """The JAX tool's sweep at ``snr_fold`` (0: sequential)."""
    return config_from_dict(
        {
            "range": {
                "minimum_snr": 0.0, "maximum_snr": 30.0, "step_snr": 5.0,
                "maximum_error_number": 10**9, "maximum_block_number": blocks,
                "thread_block_number": 1,
            },
            "decoder": {"true_h_arg": True},
            "xcodec": {"5gldpc": False, "metric_type": False, "metric_iter": 5},
            "histogram": {"enable": False},
            "ldpc": {"max_iter": 50, "active": True,
                     "matrix_file": "PEG2304regular0.5.txt"},
            "modem": {"modem_file": "2bits_QPSK.txt"},
            "tpu": {"batch": batch, "chunks_per_launch": 1,
                    "data_parallel": 1, "snr_fold": snr_fold, "seed": 3},
        },
        asset_dir=default_asset_dir(),
    )


def run(blocks: int = 4096, batch: int = 1024, device: torch.device | str = "cuda",
        json_path: str | None = None) -> dict:
    """Both sweeps, warm then timed; returns the results dict."""
    from ..sim import Simulator
    from ..utils import SimLogger

    device = resolve_device(device)
    name = device_name(device)
    print(f"snrfold_bench: device={name}", file=sys.stderr)
    results: dict = {"device": name}
    counters: dict = {}
    for label, fold in (("sequential", 0), ("folded7", 7)):
        sim = Simulator(build_cfg(fold, blocks, batch), SimLogger(log_dir=None, stdout=False),
                        device=device)
        sim.simulate()  # warm-up: a full sweep
        t0 = time.perf_counter()
        rs = sim.simulate()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        sim.close()
        counters[label] = [(r.snr, r.tot_blk, r.err_blk, r.err_bit) for r in rs]
        results[f"snrfold/{label}"] = {
            "wall_s": round(dt, 3),
            "points": len(rs),
            "blocks": sum(r.tot_blk for r in rs),
        }
        print(f"snrfold/{label}: {dt:.3f} s for {len(rs)} points "
              f"({sum(r.tot_blk for r in rs)} blocks)", file=sys.stderr)
        _save(results, json_path)
    if counters["sequential"] != counters["folded7"]:
        raise RuntimeError(f"per-point counters must be bit-identical: {counters}")
    seq = results["snrfold/sequential"]["wall_s"]
    fold = results["snrfold/folded7"]["wall_s"]
    results["snrfold/speedup"] = round(seq / fold, 3)
    print(f"snrfold/speedup: {seq / fold:.3f}x (counters bit-identical)", file=sys.stderr)
    _save(results, json_path)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmldpc_torch.tools.snrfold_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--blocks", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(args.blocks, args.batch, args.device, args.json)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
