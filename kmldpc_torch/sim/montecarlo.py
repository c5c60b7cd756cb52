"""Monte-Carlo harness: SNR sweep, stopping rules, reference-format lines
(port of the sequential path of ``kmldpc_tpu/sim/montecarlo.py``).

SNR points run one after the other.  Within a point, launches of
``chunks_per_launch x batch`` codewords are issued until
``tot_blk >= maximum_block_number`` or ``err_blk >= maximum_error_number``
(simulator.cc:117).  As in the JAX harness, launch L+1 is issued before
launch L's counters are read, and the check counts that in-flight launch
toward the block cap: a block-capped sweep counts exactly as many blocks
as the JAX package, and the error cap can overrun by one launch.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from kmldpc_tpu.code.ldpc import load_code
from kmldpc_tpu.config import Config
from kmldpc_tpu.io.constellation import parse_constellation
from kmldpc_tpu.utils.logging import SimLogger

from ..device import resolve_device
from .chain import ChainSpec, ChunkResult, make_chunk_runner, unported


@dataclasses.dataclass
class SnrResult:
    snr: float
    ber: float
    fer: float
    tot_blk: int
    err_blk: int
    err_bit: int
    tot_bit: int
    wall_s: float
    blocks_per_s: float
    err_bit_sq: float = 0.0  # second moment of per-block bit errors (parity z-test)


@dataclasses.dataclass
class _Counters:
    tot_blk: int = 0
    err_blk: int = 0
    err_bit: int = 0
    tot_bit: int = 0
    chunks: int = 0
    err_bit_sq: float = 0.0

    @property
    def ber(self) -> float:
        return self.err_bit / self.tot_bit if self.tot_bit else 0.0

    @property
    def fer(self) -> float:
        return self.err_blk / self.tot_blk if self.tot_blk else 0.0


class Simulator:
    """Config-driven sweep runner on one device."""

    def __init__(
        self,
        cfg: Config,
        logger: SimLogger | None = None,
        device: torch.device | str = "cuda",
    ) -> None:
        tpu = cfg.tpu
        extras = "snr_fold, checkpoints, histogram, dumps"
        if tpu.checkpoint_path:
            raise unported("[tpu] checkpoint_path", extras)
        if tpu.profile_dir:
            raise unported("[tpu] profile_dir", extras)
        if tpu.model_parallel > 1:
            raise unported("[tpu] model_parallel", "multi-device")
        if tpu.data_parallel > 1:
            raise unported("[tpu] data_parallel > 1", "multi-device")
        self.cfg = cfg
        self.log = logger or SimLogger(log_dir=None)
        self.device = resolve_device(device)
        self.code = load_code(cfg.matrix_path())
        self.constellation = parse_constellation(cfg.modem_path())
        self.spec = ChainSpec.from_config(cfg, self.code, self.constellation)
        # [tpu].batch = 0 falls back to [range].thread_block_number when set
        # above 1, else 1024; never more than the point needs
        batch = tpu.batch
        if batch <= 0:
            batch = (
                cfg.range.thread_block_number
                if cfg.range.thread_block_number > 1
                else 1024
            )
        self.batch = max(1, min(batch, cfg.range.maximum_block_number))
        cpl = max(1, min(tpu.chunks_per_launch,
                         -(-cfg.range.maximum_block_number // self.batch)))
        self.runner = make_chunk_runner(self.spec, self.batch, cpl, self.device, tpu.seed)
        self.log.info(
            f"[{cfg.range.minimum_snr:.3f},{cfg.range.step_snr:.3f},{cfg.range.maximum_snr:.3f}]"
        )
        self.log.info(
            f"[MAX_ERROR_BLK = {cfg.range.maximum_error_number},"
            f"MAX_BLK = {cfg.range.maximum_block_number}]"
        )
        self.log.info("Using traditional LDPC.")
        name = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        self.log.info(f"Device: {self.device} ({name}), batch {self.batch} x {cpl} per launch")
        if tpu.snr_fold > 1:
            # the per-point counters are identical either way (the JAX
            # package pins its folded path to the sequential one)
            self.log.info(
                f"[tpu] snr_fold = {tpu.snr_fold}: SNR points run sequentially "
                "in kmldpc_torch"
            )

    def run_snr_point(self, snr: float, counters: _Counters | None = None) -> SnrResult:
        cfg = self.cfg
        var = 10.0 ** (-0.1 * snr)  # simulator.cc:74 — no rate normalisation
        c = counters or _Counters()
        t0 = time.monotonic()
        max_blk = cfg.range.maximum_block_number
        max_err = cfg.range.maximum_error_number
        last_print = c.tot_blk
        device_of_counters = None

        def consume(res: ChunkResult) -> None:
            nonlocal last_print, device_of_counters
            device_of_counters = res.err_bit.device
            c.chunks += 1
            c.err_bit += int(res.err_bit)
            c.err_blk += int(res.err_blk)
            c.tot_bit += int(res.tot_bit)
            c.tot_blk += int(res.tot_blk)
            c.err_bit_sq += float(res.err_bit_sq)
            self.log.info(
                f"chunk {c.chunks}: mean BP iters = {float(res.iters):.2f}",
                to_stdout=False,
            )
            if c.tot_blk - last_print >= 100 or c.tot_blk >= max_blk or c.err_blk >= max_err:
                self._print_result(snr, c)
                last_print = c.tot_blk

        per_launch = self.runner.blocks_per_launch
        launched = c.chunks
        pending: ChunkResult | None = None
        while (
            c.tot_blk + (per_launch if pending is not None else 0) < max_blk
            and c.err_blk < max_err
        ):
            res = self.runner(snr, launched, var)
            launched += 1
            if pending is not None:
                consume(pending)
            pending = res
        if pending is not None:
            consume(pending)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.monotonic() - t0
        self._print_result(snr, c)
        bps = c.tot_blk / wall if wall > 0 else 0.0
        self.log.info(
            f"SNR = {snr:.3f} done: {c.tot_blk} blocks in {wall:.6f} s = "
            f"{bps:.1f} blocks/s, counters on {device_of_counters}"
        )
        return SnrResult(
            snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk, err_blk=c.err_blk,
            err_bit=c.err_bit, tot_bit=c.tot_bit, wall_s=wall, blocks_per_s=bps,
            err_bit_sq=c.err_bit_sq,
        )

    def _print_result(self, snr: float, c: _Counters) -> None:
        # sourcesink.cc:49-65 format
        self.log.info(
            f"SNR = {snr:.3f} Total blk = {c.tot_blk:7d} "
            f"Error blk = {c.err_blk:7d} Error bit = {c.err_bit:7d} "
            f"BER = {c.ber:.14f} FER = {c.fer:.14f}"
        )

    def _print_tables(self, results: list[SnrResult]) -> None:
        # final tables (simulator.cc:43-66)
        self.log.info("BER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.ber:.14f}")
        self.log.info("FER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.fer:.14f}")

    def simulate(self) -> list[SnrResult]:
        results = [self.run_snr_point(snr) for snr in self.cfg.snr_points()]
        self._print_tables(results)
        return results
