"""CLI: ``python -m kmldpc_torch <config.toml> [--device cuda|cpu] [--batch N] [--seed N]``.

Same config schema, log format and final tables as ``python -m kmldpc_tpu``
(reference ``main()``, kmldpc.cpp:10-56).  The default device is ``cuda``;
asking for it without a CUDA device is an error, never a switch to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from .config import load_config
from .sim.montecarlo import Simulator
from .utils.logging import SimLogger


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="kmldpc_torch", description="PyTorch/CUDA kmldpc link-level simulator"
    )
    parser.add_argument("config", nargs="?", default="config.toml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--log-dir", default="logs")
    parser.add_argument("--no-log-file", action="store_true")
    parser.add_argument("--batch", type=int, default=None, help="override [tpu].batch")
    parser.add_argument("--seed", type=int, default=None, help="override [tpu].seed")
    args = parser.parse_args(argv)

    t0 = time.monotonic()
    logger = SimLogger(log_dir=None if args.no_log_file else args.log_dir)
    try:
        logger.info("Start simulation")
        try:
            cfg = load_config(args.config)
        except OSError as e:
            logger.error(f"Encouter error while opening {args.config}: {e}")
            return 1
        tpu = cfg.tpu
        if args.batch is not None:
            tpu = dataclasses.replace(tpu, batch=args.batch)
        if args.seed is not None:
            tpu = dataclasses.replace(tpu, seed=args.seed)
        cfg = dataclasses.replace(cfg, tpu=tpu)
        if not args.no_log_file:
            os.makedirs("records", exist_ok=True)

        Simulator(cfg, logger, device=args.device).simulate()
        logger.info("Simulation done")
        total_ms = int((time.monotonic() - t0) * 1000)
        minutes, rem = divmod(total_ms, 60_000)
        seconds, ms = divmod(rem, 1000)
        logger.info(f"Total time cost: {minutes}min:{seconds}sec:{ms}ms")
        return 0
    finally:
        logger.close()


if __name__ == "__main__":
    sys.exit(main())
