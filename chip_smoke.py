"""Drive the PyTorch port (kmldpc_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile kernel K1 (csrc/kmeans.cu) from the checkout's sources;
3. K1 against its plain PyTorch version on every row shape the later
   phases give it: QPSK / 16QAM Gray / 64QAM Gray at their PEG2304 symbol
   counts (15 dB channel outputs), 64QAM at PEG8064's (sweep 5's front
   end at 17.5 dB) and 16QAM at the 5G BG2 K=960 code's 480 symbols
   (sweep 4's front end at 14 dB), each also on plain normal draws, B in
   {1024, 100, 12, 7}, both anchors (rtol 1e-5, atol 1e-6); two launches
   must agree
   bitwise, and so must the early exit with the fixed loop.  At B = 1024,
   CUDA events time the plain version, the wrapper, and raw launches of
   pre-built arguments (the kernel alone) with the fixed loop and with
   early exit, each beside the bound, with the spread of the passes the
   rows ran; the kernel alone also at B = 132 and 4096 beside the rows an
   SM holds at once;
4. main path: ``kmldpc_torch.__main__.main`` on
   configs/main_path_blind_qpsk.toml restricted to 15 dB, with K1's launch
   count reset just before and read just after, then the same point three
   more times, warm, for its blocks/s;
5. parity: the full 7-point sweep of that config, blind and known-h, then
   sweeps 2 (blind 16QAM), 3 (known-h 5G 16QAM), 4 (blind 5G 16QAM, soft
   metric), 5 (blind PEG8064 64QAM), 8 (sweep 5 with flooding min-sum),
   9 (known-h QPSK, flooding min-sum) and 10 (blind QPSK, flooding
   min-sum, pruned candidates) of benchmarks/parity/configs, each z-tested
   by tools/parity.py against its C++ reference log (|z| < 4), with K1's
   launches counted per sweep: some on every blind sweep, none on a
   known-h one.

The line before the last is one JSON object describing the kernels; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "main_path_blind_qpsk.toml")
PARITY_DIR = os.path.join(HERE, "benchmarks", "parity")
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's kernel tolerance
INFO_BITS = 1152  # PEG2304 R=1/2
K1_CASES = (  # (code, table, symbols a codeword, SNR of the channel rows in dB)
    ("PEG2304regular0.5.txt", "2bits_QPSK.txt", 1152, 15.0),
    ("PEG2304regular0.5.txt", "4bit_16QAM_Gray.txt", 576, 15.0),
    ("PEG2304regular0.5.txt", "6bits_64QAM_Gray.txt", 384, 15.0),
    ("PEG8064regular0.5.txt", "6bits_64QAM_Gray.txt", 1344, 17.5),  # sweep 5's first point
    ("5GLDPCBG2a3_R12_K960.txt", "4bit_16QAM_Gray.txt", 480, 14.0),  # sweep 4's first point
)
# sweeps of benchmarks/parity/configs and the C++ reference log each is held to
SWEEPS = (
    ("sweep2_blind_16qam.toml", "ref_blind_16qam.log"),
    ("sweep3_known_5g16qam.toml", "ref_known_5g16qam.log"),
    ("sweep4_blind_5g_soft.toml", "ref_blind_5g_soft.log"),
    ("sweep5_blind_8064_64qam.toml", "ref_blind_8064_64qam_r5.log"),
    ("sweep8_blind_8064_fminsum.toml", "ref_blind_8064_64qam_r5.log"),
    ("sweep9_known_qpsk_fminsum.toml", "ref_known_qpsk_r5.log"),
    ("sweep10_blind_qpsk_fminsum_prune.toml", "ref_blind_qpsk.log"),
)
K1_BATCHES = (1024, 100, 12, 7)
# the kernel alone at 33 blocks (one warp a scheduler on 33 SMs), at the
# main path's batch, and at four times it: how its time follows the warps
# an SM holds
K1_OCCUPANCY_BATCHES = (132, 1024, 4096)
K1_ITERS = 20
# K1's least time: its distances are 6 unfused float32 operations each (2
# subtractions, 2 products, a sum, a compare), one lane-cycle apiece, so
# the card's float32 rate is SMs x 128 lanes x its top clock (the data
# sheet's 67 TFLOP/s counts a fused multiply-add as two); its bytes are y
# read once and the candidates written once, at 3.35 TB/s
DISTANCE_OPS = 6
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0), smi


def fp32_ops_per_s() -> float:
    """Unfused float32 operations the card issues per second at its top clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * 128 * float(mhz) * 1e6
    log(f"float32 issue rate: {sms} SMs x 128 lanes x {float(mhz):.0f} MHz = {rate:.4g} ops/s")
    return rate


def k1_bound_ms(b: int, nsym: int, m: int, passes: float, ops_rate: float) -> tuple[float, str]:
    """K1's least time for B rows that run ``passes`` assignment passes in all."""
    ops_s = DISTANCE_OPS * passes * nsym * m / ops_rate
    bytes_s = (2 * 4 * b * nsym + 2 * 4 * b * 4) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def phase_build() -> None:
    from kmldpc_torch import _build

    t0 = time.monotonic()
    _build.load_library()
    log(f"build: K1 library {_build.library_path().name} ready in "
        f"{time.monotonic() - t0:.3f} s")


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_k1(dev: torch.device, ops_rate: float) -> dict:
    import ctypes

    import numpy as np

    from kmldpc_torch import _build
    from kmldpc_torch.code import load_code
    from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates, init_index
    from kmldpc_torch.detect.kmeans_cuda import launch_k1, make_blind_estimator_cuda
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops.modem import ModemTables
    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn

    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    codes = {}
    worst = 0.0
    times = {}
    for code_file, fname, nsym, snr in K1_CASES:
        if code_file not in codes:
            code = load_code(os.path.join(HERE, "assets", code_file))
            codes[code_file] = code, make_chain_params(code, dev)
        code, params = codes[code_file]
        label = f"{code_file.split('regular')[0].split('LDPC')[0]} {fname}"
        var = torch.tensor(10.0 ** (-0.1 * snr), dtype=torch.float32, device=dev)
        const = parse_constellation(os.path.join(HERE, "assets", fname))
        tables = ModemTables.from_constellation(const, dev)
        spec = ChainSpec(code=code, constellation=const, known_h=False, fading=True,
                         metric_type=False, metric_iter=5, max_iter=50,
                         encoder_active=True)
        estimators = {(anchor, early): make_blind_estimator_cuda(tables, K1_ITERS, anchor, early)
                      for anchor in ("max", "first") for early in (False, True)}
        for b in K1_BATCHES:
            gen = make_generator(1000 + b, dev)
            _, yr_ch, yi_ch, _, _ = build_frontend_fn(spec, b, dev)(params, gen, var)
            inputs = {
                f"channel{snr:g}dB": (yr_ch.contiguous(), yi_ch.contiguous()),
                "normal": (torch.randn((b, nsym), generator=gen, device=dev),
                           torch.randn((b, nsym), generator=gen, device=dev)),
            }
            if yr_ch.shape != (b, nsym):
                raise AssertionError(f"{label}: rows {tuple(yr_ch.shape)}, expected {(b, nsym)}")
            for kind, (yr, yi) in inputs.items():
                for anchor in ("max", "first"):
                    plain = expand_candidates(*blind_estimate(yr, yi, tables, K1_ITERS, anchor))
                    k1 = estimators[anchor, False](yr, yi)
                    k1b = estimators[anchor, False](yr, yi)
                    early = estimators[anchor, True](yr, yi)
                    torch.cuda.synchronize()
                    for a, p in zip(k1, plain):
                        torch.testing.assert_close(a, p, rtol=RTOL, atol=ATOL)
                        worst = max(worst, float((a - p).abs().max()))
                    case = f"{label} B={b} {kind} {anchor}"
                    for a, a2, e in zip(k1, k1b, early):
                        if not torch.equal(a, a2):
                            raise AssertionError(f"K1 not deterministic: {case}")
                        if not torch.equal(a, e):
                            raise AssertionError(f"K1 early exit differs from the fixed loop: {case}")

        # times at the main path's batch, on its channel outputs, "max" anchor
        b = 1024
        gen = make_generator(7, dev)
        _, yr, yi, _, _ = build_frontend_fn(spec, b, dev)(params, gen, var)
        yr, yi = yr.contiguous(), yi.contiguous()
        pts_r = np.ascontiguousarray(tables.points_re.cpu().numpy(), dtype=np.float32)
        pts_i = np.ascontiguousarray(tables.points_im.cpu().numpy(), dtype=np.float32)
        k_init = init_index(tables, "max")
        rounds = torch.zeros(b, dtype=torch.int32, device=dev)
        launch_k1(yr, yi, pts_r, pts_i, K1_ITERS, k_init, False, True, rounds)
        passes = float(rounds.sum())  # assignment passes of all rows with early exit
        quantiles = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=dev)
        p50, p90, p99 = torch.quantile(rounds.double(), quantiles).tolist()
        max_passes = int(rounds.max())
        alive = []  # what the raw launches read and write, kept until the timings end

        def raw(yr_: torch.Tensor, yi_: torch.Tensor, early_exit: int):
            rows = yr_.shape[0]
            h4 = torch.empty((2, rows, 4), dtype=torch.float32, device=dev)
            alive.append((yr_, yi_, h4))
            args = (yr_.data_ptr(), yi_.data_ptr(), h4[0].data_ptr(), h4[1].data_ptr(), rows,
                    nsym, pts_r.ctypes.data_as(ctypes.c_void_p),
                    pts_i.ctypes.data_as(ctypes.c_void_p), tables.num_points, K1_ITERS,
                    k_init, 0, early_exit, None, stream)

            def run():
                if lib.kmldpc_kmeans(*args) != 0:
                    raise RuntimeError("K1 raw launch failed")
            return run

        wrapper = estimators["max", False]

        def run_wrapper():
            wrapper(yr, yi)

        def run_plain():
            expand_candidates(*blind_estimate(yr, yi, tables, K1_ITERS, "max"))

        reps = 50
        order = (("plain", run_plain, 10), ("kernel", raw(yr, yi, 0), reps),
                 ("wrapper", run_wrapper, reps), ("early", raw(yr, yi, 1), reps))
        runs = {name: [] for name, _, _ in order}
        for name, fn, n in (*order, *reversed(order)):
            runs[name].append(_time_ms(fn, n))
        t = {name: sum(v) / len(v) for name, v in runs.items()}
        # the kernel alone on fewer and more rows of the same draw
        occupancy = {}
        for rows in K1_OCCUPANCY_BATCHES:
            take = (yr[:rows], yi[:rows]) if rows <= b else (yr.repeat(rows // b, 1),
                                                              yi.repeat(rows // b, 1))
            occupancy[rows] = _time_ms(raw(*take, 0), reps)
        per_sm = ctypes.c_int(0)
        if lib.kmldpc_kmeans_rows_per_sm(tables.num_points, 0, nsym, ctypes.byref(per_sm)) != 0:
            raise RuntimeError("K1 occupancy query failed")
        bound, bound_by = k1_bound_ms(b, nsym, tables.num_points, b * K1_ITERS, ops_rate)
        early_bound, _ = k1_bound_ms(b, nsym, tables.num_points, passes, ops_rate)
        times[label] = dict(
            nsym=nsym, points=tables.num_points, ms=t["kernel"], wrapper_ms=t["wrapper"],
            early_exit_ms=t["early"], plain_ms=t["plain"], bound_ms=bound, bound_by=bound_by,
            early_exit_bound_ms=early_bound, mean_passes=passes / b,
            passes_p50_p90_p99_max=[p50, p90, p99, max_passes],
            rows_per_sm=per_sm.value, kernel_ms_by_batch=occupancy,
        )
        log(f"K1 {label} Nsym={nsym} M={tables.num_points} B={b}: kernel alone "
            f"{t['kernel']:.4f} ms (runs {runs['kernel'][0]:.4f}, {runs['kernel'][1]:.4f}), "
            f"bound {bound:.4f} ms by {bound_by}, share {bound / t['kernel']:.3f}; "
            f"wrapper {t['wrapper']:.4f} ms (runs {runs['wrapper'][0]:.4f}, "
            f"{runs['wrapper'][1]:.4f}); early exit {t['early']:.4f} ms (runs "
            f"{runs['early'][0]:.4f}, {runs['early'][1]:.4f}), bound {early_bound:.4f} ms, "
            f"share {early_bound / t['early']:.3f}; plain {t['plain']:.4f} ms (runs "
            f"{runs['plain'][0]:.4f}, {runs['plain'][1]:.4f})")
        log(f"K1 {label} early-exit passes a row: mean {passes / b:.3f}, median {p50:g}, "
            f"p90 {p90:g}, p99 {p99:g}, max {max_passes} (of {K1_ITERS})")
        log(f"K1 {label} kernel alone by batch: " + "; ".join(
            f"B={rows} {ms:.4f} ms = {ms * 1024 / rows:.4f} ms per 1024 rows"
            for rows, ms in occupancy.items())
            + f"; an SM holds {per_sm.value} rows ({per_sm.value / 4:g} warps a scheduler), "
            f"the card {per_sm.value * sms}")
    log(f"K1 vs plain: {len(K1_CASES)} row shapes x B in {K1_BATCHES} x 2 anchors x 2 "
        f"inputs agree (max |err| {worst:.3g}, rtol {RTOL}, atol {ATOL}); "
        f"two launches bitwise equal; early exit bitwise equal to the fixed loop")
    return dict(max_abs_err=worst, times=times)


def phase_main_path(card: str, dev: torch.device) -> int:
    import kmldpc_torch.__main__ as cli
    from kmldpc_torch.config import load_config
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    with open(CONFIG) as f:
        text = f.read()
    text = re.sub(r"minimum_snr = [\d.]+", "minimum_snr = 15.0", text)
    text = re.sub(r"maximum_snr = [\d.]+", "maximum_snr = 15.0", text)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "main_path_15dB.toml")
        with open(cfg_path, "w") as f:
            f.write(text)
        out = io.StringIO()
        kmeans_estimate.launches = 0
        with contextlib.redirect_stdout(out):
            rc = cli.main([cfg_path, "--device", "cuda", "--no-log-file"])
        launches = kmeans_estimate.launches
        # the same point warm: three more passes through the harness
        sim = Simulator(load_config(cfg_path), SimLogger(log_dir=None, stdout=False), device=dev)
        warm = [sim.run_snr_point(15.0).blocks_per_s for _ in range(4)][1:]
    text = out.getvalue()
    sys.stdout.write(text)
    if rc != 0:
        raise AssertionError(f"main path exited {rc}")
    if launches <= 0:
        raise AssertionError("the main path never launched K1")
    done = re.search(
        r"SNR = 15\.000 done: (\d+) blocks in ([\d.]+) s = ([\d.]+) blocks/s, "
        r"counters on (\S+)", text)
    if done is None:
        raise AssertionError("no per-point summary line from the main path")
    blocks, bps, where = int(done.group(1)), float(done.group(3)), done.group(4)
    if not where.startswith("cuda"):
        raise AssertionError(f"chain tensors on {where}, not cuda")
    if blocks != 4096:
        raise AssertionError(f"main path counted {blocks} blocks, expected 4096")
    log(f"main path (15 dB, blind QPSK PEG2304, B=1024): {blocks} blocks, "
        f"{bps:.1f} blocks/s, {bps * INFO_BITS:.0f} info bits/s on {card}; "
        f"K1 launches {launches}; warm repeats "
        + ", ".join(f"{w:.1f}" for w in warm) + " blocks/s")
    return launches


def phase_parity(dev: torch.device) -> dict:
    from kmldpc_torch.config import load_config
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger
    from tools.parity import compare, parse_reference_log

    cfg = load_config(CONFIG)
    runs = [
        ("blind QPSK", cfg, "ref_blind_qpsk.log"),
        ("known-h QPSK", dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, true_h_arg=True)),
         "ref_known_qpsk_r5.log"),
    ] + [(toml.removesuffix(".toml"), load_config(os.path.join(PARITY_DIR, "configs", toml)), ref)
         for toml, ref in SWEEPS]
    launches, failed = {}, []
    for name, c, ref_name in runs:
        quiet = SimLogger(log_dir=None, stdout=False)
        sim = Simulator(c, quiet, device=dev)
        t0 = time.monotonic()
        kmeans_estimate.launches = 0
        results = sim.simulate()
        launches[name] = kmeans_estimate.launches
        wall = time.monotonic() - t0
        ref = parse_reference_log(os.path.join(PARITY_DIR, ref_name))
        rows = compare(ref, [dataclasses.asdict(r) for r in results], sim.code.code_dim)
        if len(rows) != len(results):
            failed.append(f"{name}: {len(rows)} of {len(results)} points compared")
        if c.decoder.true_h_arg == (launches[name] > 0):
            failed.append(f"{name}: K1 launched {launches[name]} times")
        worst = 0.0
        for r, res in zip(rows, results):
            worst = max(worst, abs(r["z_fer"]), abs(r["z_ber"]))
            log(f"parity {name} {r['snr']:6.2f} dB: FER {r['our_fer']:.5f} (ref "
                f"{r['ref_fer']:.5f}, z {r['z_fer']:+.2f}), BER {r['our_ber']:.6f} "
                f"(ref {r['ref_ber']:.6f}, z {r['z_ber']:+.2f}), {res.tot_blk} blocks, "
                f"{res.blocks_per_s:.1f} blocks/s")
        log(f"parity {name} vs {ref_name}: worst |z| = {worst:.3f} over "
            f"{len(rows)} points, sweep {wall:.3f} s, K1 launches {launches[name]}")
        if not worst < 4.0:
            failed.append(f"parity {name}: worst |z| {worst:.3f} >= 4")
    if failed:
        raise AssertionError("; ".join(failed))
    return launches


def main() -> int:
    card, smi = phase_device()
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    k1 = phase_k1(dev, fp32_ops_per_s())
    launches = phase_main_path(card, dev)
    phase_parity(dev)
    qpsk = k1["times"]["PEG2304 2bits_QPSK.txt"]
    kernels = {"kernels": [{
        "name": "K1 blind k-means gain estimate",
        "route": "cuda",
        "source": "kmldpc_torch/csrc/kmeans.cu",
        "replaces": "kmldpc_tpu/detect/kmeans_pallas.py:84",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": qpsk["ms"],
        "plain_ms": qpsk["plain_ms"],
        "bound_ms": qpsk["bound_ms"],
        "bound_by": qpsk["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a k-means estimate
        "wrapper_ms": qpsk["wrapper_ms"],
        "early_exit_ms": qpsk["early_exit_ms"],
        "by_table": k1["times"],
    }]}
    log(f"card: {smi}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
