"""Monte-Carlo harness: SNR sweep, stopping rules, telemetry, checkpointing
(port of ``kmldpc_tpu/sim/montecarlo.py``).

* Within an SNR point, launches of ``chunks_per_launch x batch`` codewords
  are issued until ``tot_blk >= maximum_block_number`` or
  ``err_blk >= maximum_error_number`` (simulator.cc:117).  As in the JAX
  harness, launch L+1 is issued before launch L's counters are read, and
  the check counts that in-flight launch toward the block cap: a
  block-capped sweep counts exactly as many blocks as the JAX package, and
  the error cap can overrun by one launch.
* ``[tpu] snr_fold > 1`` folds whole launches of several live SNR points
  into one dispatch of the multi-point runner (``_simulate_folded``).  Each
  slot is a sequential launch from the same seeds, so a block-capped sweep
  gives bitwise the sequential counters.
* Counters are checkpointed to JSON after every consumed launch.  Every
  sub-chunk draws from ``chunk_seed(seed, snr, launch, sub)``, so a resumed
  sweep re-issues the lost in-flight launch under its own seed and lands on
  bitwise the counters of an uninterrupted one.
* ``[tpu] data_parallel`` and ``model_parallel`` lay the first ranks of a
  multi-rank run (``torchrun``, parallel/distributed.py) out as a (data x
  model) grid, as the JAX harness lays its device mesh over the first
  devices; the ranks beyond it sit idle for the run.  The counters are
  summed over the data ranks, so every active rank takes the same stopping
  decisions; only the primary rank (rank 0, always active) writes files
  (log, checkpoints, histograms, k-means dumps), and every active rank
  reads the checkpoint at start.
* Histogram mode, k-means dumps, per-block debug lines and a
  ``torch.profiler`` trace (``profile_dir``) as in the JAX harness.  One
  guard the JAX harness lacks: histogram mode refuses to resume a point
  that has consumed launches, since reopening ``histogram_<snr>.txt`` would
  lose their rows.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..code.ldpc import load_code
from ..config import Config
from ..device import resolve_device
from ..io.constellation import parse_constellation
from ..parallel.distributed import Grid, data_ranks, is_primary, layout, world_size
from ..utils.logging import SimLogger
from ..utils.trace import count, snapshot, span
from .chain import ChainSpec, ChunkResult, make_chunk_runner, make_multi_point_runner


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

    def __post_init__(self) -> None:
        self.printed = self.tot_blk  # blocks at the last printed result; not checkpointed

    @property
    def ber(self) -> float:
        return self.err_bit / self.tot_bit if self.tot_bit else 0.0

    @property
    def fer(self) -> float:
        return self.err_blk / self.tot_blk if self.tot_blk else 0.0

    @staticmethod
    def from_saved(saved: dict) -> "_Counters":
        """Rebuild from one checkpoint point-state dict."""
        return _Counters(
            **{k: saved[k] for k in
               ("tot_blk", "err_blk", "err_bit", "tot_bit", "chunks")},
            err_bit_sq=saved.get("err_bit_sq", 0.0),
        )

    def state(self, done: bool) -> dict:
        """The checkpoint point-state dict, with the JAX harness's keys."""
        return dict(tot_blk=self.tot_blk, err_blk=self.err_blk, err_bit=self.err_bit,
                    tot_bit=self.tot_bit, chunks=self.chunks, done=done,
                    err_bit_sq=self.err_bit_sq)


def _np(a) -> np.ndarray:
    """A tensor (on any device) or a number as a NumPy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# what Simulator._add_launch reads of a consumed launch's ChunkResult
_LAUNCH_FIELDS = ("err_bit", "err_blk", "tot_bit", "tot_blk", "err_bit_sq", "iters",
                  "per_codeword")


class Simulator:
    """Config-driven sweep runner on one device, or on each rank of a
    multi-rank run."""

    def __init__(
        self,
        cfg: Config,
        logger: SimLogger | None = None,
        device: torch.device | str = "cuda",
        runner_factory=None,
    ) -> None:
        with span("harness.build"):
            self._build(cfg, logger, device, runner_factory)

    def _build(self, cfg: Config, logger, device, runner_factory) -> None:
        tpu = cfg.tpu
        self.cfg = cfg
        self.log = logger or SimLogger(log_dir=None)
        self.device = resolve_device(device)
        self.primary = is_primary()
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
        self.snr_fold = 0
        if tpu.snr_fold > 1 and (self.spec.kmeans_dump or tpu.model_parallel > 1):
            # a first-launch-only .mat export gains nothing from folding;
            # the folded runner has no (slot x data x model) form
            raise ValueError(
                "[tpu].snr_fold is incompatible with kmeans_dump_dir and "
                "model_parallel (use the sequential path for those)"
            )
        # the layout over the first ranks (1 x 1 on one device), as the JAX
        # harness lays its mesh over the first devices.  ndata counts data
        # shards; fewer ranks than shards run several shards each, with the
        # draws of one rank a shard
        world = world_size()
        ndata, nmodel = layout(tpu.data_parallel, tpu.model_parallel, world, self.batch)
        self.ndata, self.nmodel = ndata, nmodel
        self.grid = Grid(data_ranks(ndata, world) if nmodel == 1 else ndata, nmodel)
        self.runner = None
        if not self.grid.active:
            return  # idle: no runner, nothing on the device, simulate() -> []
        if runner_factory is not None:
            self.runner = runner_factory(self.spec, self.batch)
        elif tpu.snr_fold > 1:
            self.snr_fold = max(1, min(tpu.snr_fold, len(cfg.snr_points())))
            if ndata > 1:
                from ..parallel.sharding import make_sharded_multi_point_runner

                self.batch -= self.batch % ndata
                self.runner = make_sharded_multi_point_runner(
                    self.spec, self.batch, self.grid, cpl, self.snr_fold, self.device, tpu.seed,
                    ndata,
                )
                self.log.info(
                    f"Mesh: {self._shards()}, data-parallel batch {self.batch}; "
                    f"SNR-fold {self.snr_fold} launch slots per dispatch"
                )
            else:
                self.runner = make_multi_point_runner(
                    self.spec, self.batch, cpl, self.snr_fold, self.device, tpu.seed
                )
                self.log.info(f"SNR-fold: {self.snr_fold} launch slots per dispatch")
        elif nmodel > 1:
            from ..parallel.edge_sharded import make_model_parallel_chunk_runner

            self.batch = max(ndata, self.batch - self.batch % ndata)
            self.runner = make_model_parallel_chunk_runner(
                self.spec, self.batch, self.grid, cpl, self.device, tpu.seed
            )
            self.log.info(
                f"Mesh: {ndata} data x {nmodel} model ranks, batch {self.batch}, "
                f"decoder row-sharded {nmodel} ways"
            )
        elif ndata > 1:
            from ..parallel.sharding import make_sharded_chunk_runner

            self.batch -= self.batch % ndata
            self.runner = make_sharded_chunk_runner(
                self.spec, self.batch, self.grid, cpl, self.device, tpu.seed, ndata
            )
            self.log.info(f"Mesh: {self._shards()}, data-parallel batch {self.batch}")
        else:
            self.runner = make_chunk_runner(self.spec, self.batch, cpl, self.device, tpu.seed)
        self.log.info(
            f"[{cfg.range.minimum_snr:.3f},{cfg.range.step_snr:.3f},{cfg.range.maximum_snr:.3f}]"
        )
        self.log.info(
            f"[MAX_ERROR_BLK = {cfg.range.maximum_error_number},"
            f"MAX_BLK = {cfg.range.maximum_block_number}]"
        )
        self.log.info(f"Using {'5G' if self.code.is_5g else 'traditional'} LDPC.")
        name = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        self.log.info(f"Device: {self.device} ({name}), batch {self.batch} x {cpl} per launch")

    def _shards(self) -> str:
        """The data layout for the log: shards, and the ranks they run on."""
        ranks = self.grid.ndata
        if ranks == self.ndata:
            return f"{ranks} data ranks"
        return f"{self.ndata} data shards on {ranks} rank{'s' if ranks > 1 else ''}"

    # -- checkpointing ------------------------------------------------------
    def _ckpt_path(self) -> str:
        return self.cfg.tpu.checkpoint_path

    def _save_ckpt(self, state: dict) -> None:
        path = self._ckpt_path()
        if not path or not self.primary:
            return
        with span("harness.checkpoint"):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            os.replace(tmp, path)

    def _load_ckpt(self) -> dict:
        path = self._ckpt_path()
        if path and os.path.exists(path):
            with open(path) as f:
                state = json.load(f)
            if state.get("fingerprint") == self._fingerprint():
                self._refuse_histogram_resume(state)
                return state
            self.log.info("Checkpoint fingerprint mismatch; starting fresh.")
        return {"fingerprint": self._fingerprint(), "snr": {}}

    def _refuse_histogram_resume(self, state: dict) -> None:
        """Histogram files are opened anew on every run, so resuming a point
        that has consumed launches would lose their rows."""
        if not self.cfg.histogram.enable:
            return
        for snr in self.cfg.snr_points():
            saved = state["snr"].get(f"{snr:.3f}")
            if saved and not saved.get("done") and saved["chunks"] > 0:
                raise ValueError(
                    f"[histogram] enable cannot resume SNR {snr:.3f} from "
                    f"[tpu] checkpoint_path {self._ckpt_path()!r}: "
                    f"histogram_{snr:.6f}.txt would lose the rows of its "
                    f"{saved['chunks']} consumed launches; remove the "
                    "checkpoint or turn one of the two knobs off"
                )

    def _fingerprint(self) -> str:
        c = self.cfg
        # The package, the device type, the seed and the runner topology
        # (data shards x model ranks, not the ranks the shards run on,
        # which draw the same) are part of the
        # fingerprint: CPU and CUDA generators draw different streams from
        # one seed, as do the JAX package's keys, so a checkpoint written
        # under another of them must start fresh (with a log line), never
        # mix streams.
        topology = (
            f"kmldpc_torch|{self.device.type}|{c.tpu.seed}|{c.tpu.data_parallel}|"
            f"{c.tpu.snr_fold}|{c.tpu.model_parallel}|{c.tpu.chunks_per_launch}|"
            f"{self.ndata}|{self.nmodel}"
        )
        return (
            f"{c.ldpc.matrix_file}|{c.modem.modem_file}|{c.ldpc.max_iter}|"
            f"{c.decoder.true_h_arg}|{c.xcodec.ldpc_5g}|{c.xcodec.metric_type}|"
            f"{c.xcodec.metric_iter}|{c.range.maximum_block_number}|"
            f"{c.range.maximum_error_number}|{self.batch}|{topology}"
        )

    # -- main loop ----------------------------------------------------------
    def run_snr_point(
        self,
        snr: float,
        counters: _Counters | None = None,
        histogram_file=None,
        save_partial=None,
    ) -> SnrResult:
        cfg = self.cfg
        var = 10.0 ** (-0.1 * snr)  # simulator.cc:74 — no rate normalisation
        c = counters or _Counters()
        t0 = time.monotonic()
        max_blk = cfg.range.maximum_block_number
        max_err = cfg.range.maximum_error_number
        km_dump_pending = bool(cfg.tpu.kmeans_dump_dir) and self.spec.kmeans_dump
        debug_pending = self.spec.debug_blocks > 0
        device_of_counters = None
        before = snapshot()

        def consume(res: ChunkResult) -> None:
            nonlocal km_dump_pending, debug_pending, device_of_counters
            with span("harness.consume"):
                device_of_counters = res.err_bit.device
                if km_dump_pending and res.kmeans_diag:
                    if self.primary:
                        self._dump_kmeans(snr, res)
                    km_dump_pending = False  # first launch of the point only
                if debug_pending and res.debug:
                    self._log_debug_blocks(res, c.tot_blk)
                    debug_pending = False  # first launch of the point only
                self._add_launch(snr, c, [getattr(res, f) for f in _LAUNCH_FIELDS])
                if histogram_file is not None:
                    self._write_histogram(histogram_file, _np(res.metrics))
                if save_partial is not None:
                    save_partial(c)

        # `launched` leads `c.chunks` (consumed) by the in-flight launch; a
        # resume from c.chunks consumed launches re-issues the lost
        # in-flight launch under its own seeds
        per_launch = getattr(self.runner, "blocks_per_launch", self.batch)
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
        self._log_counters(f"SNR = {snr:.3f}", before)
        return SnrResult(
            snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk, err_blk=c.err_blk,
            err_bit=c.err_bit, tot_bit=c.tot_bit, wall_s=wall, blocks_per_s=bps,
            err_bit_sq=c.err_bit_sq,
        )

    def _dump_kmeans(self, snr: float, res: ChunkResult) -> None:
        """Write per-block k-means diagnostics (KMeans::DumpToMat parity,
        kmeans.cc:96-111): received symbols, final clusters, per-symbol
        assignments, constellation, the 4 ĥ candidates and the true h, under
        the reference's variable names (records.dump_kmeans)."""
        from ..utils.records import dump_kmeans

        d = self.cfg.tpu.kmeans_dump_dir
        os.makedirs(d, exist_ok=True)
        yr, yi, cl_r, cl_i, idx, h4_r, h4_i, hr_t, hi_t = (_np(a) for a in res.kmeans_diag)
        const = self.constellation.points
        nb = min(self.cfg.tpu.kmeans_dump_blocks, yr.shape[0])
        for j in range(nb):
            dump_kmeans(
                os.path.join(d, f"kmeans_snr{snr:.3f}_blk{j}"),
                yr[j] + 1j * yi[j],
                cl_r[j] + 1j * cl_i[j],
                idx[j],
                const,
                h4_r[j] + 1j * h4_i[j],
                complex(hr_t[j], hi_t[j]),
            )
        self.log.info(
            f"k-means diagnostics: wrote {nb} blocks to {d}", to_stdout=False
        )

    def _log_debug_blocks(
        self, res: ChunkResult, tot_before: int, slot: int | None = None
    ) -> None:
        """Per-block debug lines, log file only ([tpu].debug_blocks).

        The reference's lines and formats: ``Generated H = (re,im)``
        (simulator.cc:124-126, 6 significant digits), and in blind mode
        ``Current Block Number = NNNNNNN`` (simulator.cc:149-152), one
        ``Hhat = (re,im) Metric = v`` per candidate at precision 14 with the
        metric before its absolute value (kmcodec.cc:132-140: soft metrics
        are log-sums <= 0, so -|metric| there), and ``hatIndex = k``
        (kmcodec.cc:64).

        ``slot`` selects one launch slot of a folded dispatch (the
        ChunkResult fields carry a leading [m] axis there); None for the
        sequential path's result.
        """
        sel = (lambda a: _np(a)[slot]) if slot is not None else _np
        nblk = int(sel(res.tot_blk))
        n = min(self.spec.debug_blocks, nblk)
        hr_t = sel(res.debug[0])
        hi_t = sel(res.debug[1])
        blind = len(res.debug) > 2
        if blind:
            h4_r = sel(res.debug[2])
            h4_i = sel(res.debug[3])
            metrics = sel(res.metrics)
            pre = -metrics if self.spec.metric_type else metrics
        for j in range(min(n, hr_t.shape[0])):
            self.log.info(
                f"Generated H = ({hr_t[j]:g},{hi_t[j]:g})", to_stdout=False
            )
            if not blind:
                continue
            self.log.info(
                f"Current Block Number = {tot_before + j + 1:07d}",
                to_stdout=False,
            )
            for k in range(4):
                self.log.info(
                    f"Hhat = ({h4_r[j, k]:.14f},{h4_i[j, k]:.14f}) "
                    f"Metric = {pre[j, k]:.14f}",
                    to_stdout=False,
                )
            self.log.info(
                f"hatIndex = {int(np.argmin(metrics[j]))}", to_stdout=False
            )

    def _add_launch(self, snr: float, c: _Counters, launch, tag: str = "") -> None:
        """One consumed launch (its ``_LAUNCH_FIELDS``) added to point
        ``snr``'s counters ``c`` and counted, its chunk line logged (``tag``
        after the number), the point printed every 100 blocks and at a cap."""
        err_bit, err_blk, tot_bit, tot_blk, err_bit_sq, iters, per_codeword = launch
        c.chunks += 1  # consumed launches: the checkpoint/resume cursor
        c.err_bit += int(err_bit)
        c.err_blk += int(err_blk)
        c.tot_bit += int(tot_bit)
        c.tot_blk += int(tot_blk)
        c.err_bit_sq += float(err_bit_sq)
        self._count_launch(float(iters), int(tot_blk), bool(per_codeword))
        self.log.info(f"chunk {c.chunks}{tag}: mean BP iters = {float(iters):.2f}",
                      to_stdout=False)
        rng = self.cfg.range
        if (c.tot_blk - c.printed >= 100 or c.tot_blk >= rng.maximum_block_number
                or c.err_blk >= rng.maximum_error_number):
            self._print_result(snr, c)
            c.printed = c.tot_blk

    def _count_launch(self, mean_iters: float, blocks: int, per_codeword: bool) -> None:
        """Counts a consumed launch under ``harness.launches``, and its
        needed codeword-iterations (this rank's share: the mean is over the
        data ranks' blocks) under ``decode.cw_iters_needed``.  Where its
        final decode ran per codeword (kernel K2 or K3), each codeword ran
        exactly the iterations it needs, so the same sum goes under
        ``decode.cw_iters_run``."""
        needed = round(mean_iters * blocks / self.grid.ndata)
        count("launches", stage="harness")
        count("cw_iters_needed", needed, stage="decode")
        if per_codeword:
            count("cw_iters_run", needed, stage="decode")

    def _log_counters(self, what: str, before: dict) -> None:
        """The decode's, the blind estimate's and the metric stage's
        counters since ``before`` (a ``snapshot()``), to the log file only:
        codeword-iterations run and needed, their ratio, host syncs, the
        rows kernel K2 or K3 decoded and the rows whose gain was estimated."""
        now = snapshot()
        d = {k: v - before.get(k, 0) for k, v in now.items()}
        run, needed = d.get("decode.cw_iters_run", 0), d.get("decode.cw_iters_needed", 0)
        self.log.info(
            f"{what} counters: decode cw_iters_run = {run} cw_iters_needed = {needed} "
            f"needed/run = {needed / run if run else 0.0:.4f} syncs = {d.get('decode.syncs', 0)} "
            f"fused_rows = {d.get('decode.fused_rows', 0)}; "
            f"kmeans rows = {d.get('kmeans.rows', 0)}; "
            f"metric cw_iters_run = {d.get('metric.cw_iters_run', 0)} "
            f"syncs = {d.get('metric.syncs', 0)}",
            to_stdout=False,
        )

    def _print_result(self, snr: float, c: _Counters) -> None:
        # sourcesink.cc:49-65 format
        self.log.info(
            f"SNR = {snr:.3f} Total blk = {c.tot_blk:7d} "
            f"Error blk = {c.err_blk:7d} Error bit = {c.err_bit:7d} "
            f"BER = {c.ber:.14f} FER = {c.fer:.14f}"
        )

    @staticmethod
    def _write_histogram(f, metrics: np.ndarray) -> None:
        """Rotated metric rows: minimum first (simulator.cc:154-163).

        NaN columns mark absent candidates (known-h mode has a single
        candidate) and are dropped, like the reference's 1-element rows.
        """
        for row in metrics:
            row = row[np.isfinite(row)]
            k = int(row.argmin()) if row.size else 0
            rolled = np.roll(row, -k)
            f.write(" ".join(f"{v:g}" for v in rolled) + " \n")

    def _print_tables(self, results: list[SnrResult]) -> None:
        # final tables (simulator.cc:43-66)
        self.log.info("BER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.ber:.14f}")
        self.log.info("FER Result")
        for r in results:
            self.log.info(f"{r.snr:.3f} {r.fer:.14f}")

    def close(self) -> None:
        """Release the rank layout's process groups (every rank of the
        launch, after the run)."""
        self.grid.close()

    def simulate(self) -> list[SnrResult]:
        """The sweep's per-point results; ``[]`` on a rank the layout leaves
        idle."""
        if not self.grid.active:
            return []
        body = self._simulate_folded if self.snr_fold else self._simulate
        d = self.cfg.tpu.profile_dir
        if not d:
            return body()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            results = body()
        os.makedirs(d, exist_ok=True)
        stamp = time.strftime("%Y-%m-%d-%H-%M-%S")
        path = os.path.join(d, f"{stamp}-{os.getpid()}-kmldpc_torch.trace.json")
        prof.export_chrome_trace(path)
        self.log.info(f"Profiler trace: {path}", to_stdout=False)
        return results

    def _simulate_folded(self) -> list[SnrResult]:
        """Concurrent SNR points: one dispatch carries ``snr_fold`` whole
        launches round-robined over the LIVE points.

        Each slot is exactly one sequential-path launch (same seeds, same
        chain), so a block-capped sweep gives bitwise the sequential
        per-point counters; the error cap sees counters that lag by the
        in-flight slots.  Dead slots pad the last dispatches to ``snr_fold``
        slots; their results are discarded, so each point's launch sequence
        is the sequential one.
        """
        cfg = self.cfg
        state = self._load_ckpt()
        m = self.snr_fold
        per_launch = self.runner.blocks_per_launch
        max_blk = cfg.range.maximum_block_number
        max_err = cfg.range.maximum_error_number
        t0 = time.monotonic()
        before = snapshot()

        points = cfg.snr_points()
        cs: dict[float, _Counters] = {}
        done: dict[float, bool] = {}
        launched: dict[float, int] = {}
        inflight: dict[float, int] = {}
        blk0: dict[float, int] = {}  # blocks already done before this run
        # per-point wall attribution: each consume's wall delta is split
        # evenly over the dispatch's valid slots, so the per-point wall_s sum
        # to the run's compute span; t_mark advances at every consume
        wall_attr: dict[float, float] = {}
        t_mark = t0
        # per-point histogram files, demuxed from the slot axis, opened on
        # the point's first consumed slot
        hist_files: dict[float, object] = {}
        debug_pending: dict[float, bool] = {}
        for snr in points:
            saved = state["snr"].get(f"{snr:.3f}")
            c = _Counters.from_saved(saved) if saved else _Counters()
            cs[snr] = c
            blk0[snr] = c.tot_blk
            done[snr] = bool(saved and saved.get("done"))
            launched[snr] = c.chunks
            inflight[snr] = 0
            wall_attr[snr] = 0.0
            debug_pending[snr] = self.spec.debug_blocks > 0
            if saved and not done[snr]:
                self.log.info(
                    f"SNR {snr:.3f}: resuming mid-point from checkpoint "
                    f"({c.tot_blk} blocks done)"
                )

        def wants(snr: float) -> bool:
            c = cs[snr]
            return (
                not done[snr]
                and c.tot_blk + per_launch * inflight[snr] < max_blk
                and c.err_blk < max_err
            )

        def save_point(snr: float) -> None:
            state["snr"][f"{snr:.3f}"] = cs[snr].state(done[snr])

        def consume(dispatch) -> None:
            nonlocal t_mark
            with span("harness.consume"):
                slots, res = dispatch
                cols = [_np(getattr(res, f)) for f in _LAUNCH_FIELDS]
                now = time.monotonic()
                n_valid = sum(1 for _, v in slots if v)
                dt_slot = (now - t_mark) / n_valid if n_valid else 0.0
                t_mark = now
                for j, (snr, valid) in enumerate(slots):
                    if not valid:
                        # dead padding slot: discarded; it never incremented
                        # inflight, so it must not decrement it either (that
                        # re-opened capped points through wants() and made the
                        # dispatch loop run away)
                        continue
                    inflight[snr] -= 1
                    wall_attr[snr] += dt_slot
                    c = cs[snr]
                    if debug_pending[snr] and res.debug:
                        # first consumed launch of the point only, like the
                        # sequential path
                        self._log_debug_blocks(res, c.tot_blk, slot=j)
                        debug_pending[snr] = False
                    self._add_launch(snr, c, [col[j] for col in cols], f" [snr {snr:.3f}]")
                    if cfg.histogram.enable and self.primary:
                        f = hist_files.get(snr)
                        if f is None:
                            f = hist_files[snr] = open(f"histogram_{snr:.6f}.txt", "w")
                        self._write_histogram(f, _np(res.metrics[j]))
                    if self._ckpt_path():
                        save_point(snr)
                if self._ckpt_path():
                    self._save_ckpt(state)

        rr = 0  # round-robin cursor over points
        pending: list = []
        try:
            while True:
                # the next dispatch: m slots round-robined over the points
                # that still want a launch (a point may take several slots,
                # consecutive launch indices, when few points remain)
                slots: list[tuple[float, bool]] = []
                launches: list[tuple[float, int]] = []
                vars_: list[float] = []
                while len(slots) < m and any(wants(p) for p in points):
                    snr = points[rr % len(points)]
                    rr += 1
                    if not wants(snr):
                        continue
                    slots.append((snr, True))
                    launches.append((snr, launched[snr]))
                    vars_.append(10.0 ** (-0.1 * snr))
                    launched[snr] += 1
                    inflight[snr] += 1
                if not slots:
                    if pending:
                        consume(pending.pop(0))
                        continue
                    break
                while len(slots) < m:  # dead padding, discarded on consume
                    slots.append((slots[0][0], False))
                    launches.append(launches[0])
                    vars_.append(vars_[0])
                res = self.runner(launches, vars_)
                pending.append((slots, res))
                if len(pending) > 1:  # double-buffered: consume the older one
                    consume(pending.pop(0))
        finally:
            # histogram files keep the consumed launches of an interrupted sweep
            for f in hist_files.values():
                f.close()

        # each consume charged its wall delta to the slots it carried, so the
        # per-point wall_s sum to the run's compute span (t0 to the last
        # consume); points restored whole from the checkpoint report 0/0
        results: list[SnrResult] = []
        for snr in points:
            c = cs[snr]
            restored = done[snr]
            done[snr] = True
            save_point(snr)
            self._print_result(snr, c)
            w = 0.0 if restored else wall_attr[snr]
            bps = 0.0 if w <= 0 else (c.tot_blk - blk0[snr]) / w
            self.log.info(
                f"SNR = {snr:.3f} done: {c.tot_blk - blk0[snr]} blocks in {w:.6f} s of "
                f"attributed wall = {bps:.1f} blocks/s, counters on {self.device.type}"
            )
            results.append(SnrResult(
                snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk,
                err_blk=c.err_blk, err_bit=c.err_bit, tot_bit=c.tot_bit,
                wall_s=w, blocks_per_s=bps, err_bit_sq=c.err_bit_sq,
            ))
        if self._ckpt_path():
            self._save_ckpt(state)
        self._log_counters(f"SNR-fold sweep of {len(points)} points", before)
        self._print_tables(results)
        return results

    def _simulate(self) -> list[SnrResult]:
        cfg = self.cfg
        state = self._load_ckpt()
        results: list[SnrResult] = []
        for snr in cfg.snr_points():
            snr_key = f"{snr:.3f}"
            saved = state["snr"].get(snr_key)
            if saved and saved.get("done"):
                c = _Counters.from_saved(saved)
                self.log.info(f"SNR {snr_key}: restored from checkpoint")
                results.append(SnrResult(
                    snr=snr, ber=c.ber, fer=c.fer, tot_blk=c.tot_blk,
                    err_blk=c.err_blk, err_bit=c.err_bit, tot_bit=c.tot_bit,
                    wall_s=0.0, blocks_per_s=0.0, err_bit_sq=c.err_bit_sq,
                ))
                continue
            c = _Counters.from_saved(saved) if saved else _Counters()
            if saved:
                self.log.info(
                    f"SNR {snr_key}: resuming mid-point from checkpoint "
                    f"({c.tot_blk} blocks done)"
                )

            def save_partial(cc, _snr_key=snr_key):
                # at most the one in-flight launch is lost on interruption
                state["snr"][_snr_key] = cc.state(done=False)
                self._save_ckpt(state)

            hist_f = None
            if cfg.histogram.enable and self.primary:
                hist_f = open(f"histogram_{snr:.6f}.txt", "w")
            try:
                r = self.run_snr_point(
                    snr, c, hist_f,
                    save_partial=save_partial if self._ckpt_path() else None,
                )
            finally:
                if hist_f is not None:
                    hist_f.close()
            results.append(r)
            state["snr"][snr_key] = c.state(done=True)
            self._save_ckpt(state)
        self._print_tables(results)
        return results
