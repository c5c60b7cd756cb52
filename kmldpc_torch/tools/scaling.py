"""Scaling efficiency: samples/s against the number of ranks.

The counterpart of the JAX side's ``tools/scaling.py``, with its lines:

    torchrun --nproc-per-node N -m kmldpc_torch.tools.scaling [per_rank_batch] [--device cuda|cpu]
    torchrun --nproc-per-node N -m kmldpc_torch.tools.scaling edge [batch] [--device cuda|cpu]

Data mode runs the blind PEG2304 QPSK hard-metric chunk (15 dB, 50
iterations) on the first n data ranks, n in 1, 2, 4, ... up to the ranks
started, at the same batch a rank (default 128), the other ranks idle: one
warm launch, then 6 timed ones, each ended by a synchronise of the card
and a barrier on the layout's group.  It prints blocks/s and the
efficiency against linear scaling.  ``edge`` mode scales the other axis:
the row-sharded flooding decoder (``parallel/edge_sharded.py``) on
PEG8064 at a fixed batch (default 256), 20 iterations of LLRs too weak to
converge, over 1, 2, 4, ... row shards, one warm decode and 3 timed.
Rank 0 prints.

Ranks that share one card run over gloo, which stages every collective
through the host: such a run checks the mechanism, not the speed, and the
tool says so.  With a card a rank the backend is NCCL.  The default device
is ``cuda``; without a card that is an error, never a switch to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.distributed import Grid, is_primary, maybe_initialize, rank_device, world_size
from .microbench import ASSETS, device_name

SIZES = (1, 2, 4, 8, 16, 32)


def _say(msg: str) -> None:
    if is_primary():
        print(msg, flush=True)


def _sync(device: torch.device, group) -> None:
    """Wait for this rank's card, then for the layout's other ranks."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if group is not None:
        dist.barrier(group=group)


def header(device: torch.device) -> None:
    """The ranks, their device and backend; a note where ranks share hardware."""
    world = world_size()
    _say(f"devices available: {world} ({device.type})")
    if world == 1:
        _say(f"backend: none (one process on {device_name(device)})")
        return
    backend = dist.get_backend()
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    shared = device.type == "cpu" or cards < world
    where = (f"{world} ranks on {cards} card{'s' if cards != 1 else ''} "
             f"({torch.cuda.get_device_name(device)})" if device.type == "cuda"
             else f"{world} CPU ranks")
    _say(f"backend: {backend}, {where}"
         + ("; ranks share hardware and gloo stages collectives through the host: "
            "this checks the mechanism, not the speed" if shared else ""))


def _sizes() -> list[int]:
    return [n for n in SIZES if n <= world_size()]


def data_mode(per_rank: int, device: torch.device,
              sizes: list[int] | None = None) -> list[tuple[int, float]]:
    """(ranks, blocks/s) for each of ``sizes`` (default: 1, 2, 4, ... up to
    the ranks started)."""
    from ..code import load_code
    from ..io import parse_constellation
    from ..parallel import make_sharded_chunk_runner
    from ..sim import ChainSpec

    code = load_code(os.path.join(ASSETS, "PEG2304regular0.5.txt"))
    const = parse_constellation(os.path.join(ASSETS, "2bits_QPSK.txt"))
    spec = ChainSpec(
        code=code, constellation=const, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50,
        encoder_active=True, histogram=False,
    )
    snr, var = 15.0, 10.0 ** (-1.5)
    base, out = None, []
    for n in sizes or _sizes():
        grid = Grid(n)
        if grid.active:
            runner = make_sharded_chunk_runner(spec, per_rank * n, grid, 1, device)
            runner(snr, 0, var)
            _sync(device, grid.data_group)
            t0 = time.perf_counter()
            for i in range(6):
                runner(snr, 1 + i, var)
            _sync(device, grid.data_group)
            dt = (time.perf_counter() - t0) / 6
            bps = per_rank * n / dt
            base = base or bps
            out.append((n, bps))
            _say(f"mesh={n:3d}  global_batch={per_rank * n:6d}  "
                 f"{bps:10.0f} blk/s  efficiency {bps / (base * n) * 100:6.1f}%")
        if dist.is_initialized():
            dist.barrier()
        grid.close()
    return out


def edge_mode(batch: int, device: torch.device,
              sizes: list[int] | None = None) -> list[tuple[int, float]]:
    """(row shards, seconds a 20-iteration decode) for each of ``sizes``
    (default: 1, 2, 4, ... up to the ranks started)."""
    from ..code import load_code
    from ..parallel import make_edge_sharded_decoder

    code = load_code(os.path.join(ASSETS, "PEG8064regular0.5.txt"))
    rng = np.random.default_rng(0)
    # weak LLRs: nothing converges, cost = the full 20 sweeps
    llr = torch.tensor(0.3 * rng.standard_normal((batch, code.num_col)),
                       dtype=torch.float32, device=device)
    base, out = None, []
    for n in sizes or _sizes():
        grid = Grid(1, n)
        if grid.active:
            dec = make_edge_sharded_decoder(code, grid, device=device)
            dec(llr, 20)
            _sync(device, grid.model_group)
            t0 = time.perf_counter()
            for _ in range(3):
                dec(llr, 20)
            _sync(device, grid.model_group)
            dt = (time.perf_counter() - t0) / 3
            base = base or dt
            out.append((n, dt))
            _say(f"row shards={n:3d}  {dt * 1e3:8.1f} ms / 20-iter decode "
                 f"(B={batch})  speedup {base / dt:5.2f}x")
        if dist.is_initialized():
            dist.barrier()
        grid.close()
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmldpc_torch.tools.scaling",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*", metavar="[edge] N",
                    help="per-rank batch (data mode), or 'edge' and the batch")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_intermixed_args(argv)
    edge = bool(args.args) and args.args[0] == "edge"
    rest = args.args[1:] if edge else args.args
    size = int(rest[0]) if rest else (256 if edge else 128)
    multirank = maybe_initialize(args.device)
    try:
        device = rank_device(args.device)
        header(device)
        if edge:
            edge_mode(size, device)
        else:
            data_mode(size, device)
    finally:
        if multirank:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
