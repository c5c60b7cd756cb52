"""Drive the PyTorch port (kmldpc_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile kernel K1 (csrc/kmeans.cu) from the checkout's sources;
3. K1 against its plain PyTorch version for QPSK / 16QAM Gray / 64QAM Gray
   at their PEG2304 symbol counts, B in {1024, 100, 12, 7}, both anchors,
   15 dB channel outputs and plain normal draws (rtol 1e-5, atol 1e-6);
   two launches must agree bitwise; times at B = 1024 with CUDA events;
4. main path: ``kmldpc_torch.__main__.main`` on
   configs/main_path_blind_qpsk.toml restricted to 15 dB, with K1's launch
   count reset just before and read just after;
5. parity: the full 7-point sweep of that config, blind and known-h,
   z-tested by tools/parity.py against the C++ reference logs (|z| < 4).

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
CONSTELLATIONS = (  # (table, symbols per PEG2304 codeword)
    ("2bits_QPSK.txt", 1152),
    ("4bit_16QAM_Gray.txt", 576),
    ("6bits_64QAM_Gray.txt", 384),
)


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


def phase_k1(dev: torch.device) -> dict:
    from kmldpc_tpu.code.ldpc import load_code
    from kmldpc_tpu.io.constellation import parse_constellation
    from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.ops.modem import ModemTables
    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn

    code = load_code(os.path.join(HERE, "assets", "PEG2304regular0.5.txt"))
    params = make_chain_params(code, dev)
    var15 = torch.tensor(10.0 ** -1.5, dtype=torch.float32, device=dev)
    worst = 0.0
    times = {}
    for fname, nsym in CONSTELLATIONS:
        const = parse_constellation(os.path.join(HERE, "assets", fname))
        tables = ModemTables.from_constellation(const, dev)
        spec = ChainSpec(code=code, constellation=const, known_h=False, fading=True,
                         metric_type=False, metric_iter=5, max_iter=50,
                         encoder_active=True)
        for b in (1024, 100, 12, 7):
            gen = make_generator(1000 + b, dev)
            _, yr_ch, yi_ch, _, _ = build_frontend_fn(spec, b, dev)(params, gen, var15)
            inputs = {
                "channel15dB": (yr_ch.contiguous(), yi_ch.contiguous()),
                "normal": (torch.randn((b, nsym), generator=gen, device=dev),
                           torch.randn((b, nsym), generator=gen, device=dev)),
            }
            if yr_ch.shape != (b, nsym):
                raise AssertionError(f"{fname}: rows {tuple(yr_ch.shape)}, expected {(b, nsym)}")
            for kind, (yr, yi) in inputs.items():
                for anchor in ("max", "first"):
                    plain = expand_candidates(*blind_estimate(yr, yi, tables, 20, anchor))
                    k1 = kmeans_estimate(yr, yi, tables, 20, anchor)
                    k1b = kmeans_estimate(yr, yi, tables, 20, anchor)
                    torch.cuda.synchronize()
                    for a, p in zip(k1, plain):
                        torch.testing.assert_close(a, p, rtol=RTOL, atol=ATOL)
                        worst = max(worst, float((a - p).abs().max()))
                    for a, a2 in zip(k1, k1b):
                        if not torch.equal(a, a2):
                            raise AssertionError(
                                f"K1 not deterministic: {fname} B={b} {kind} {anchor}")
        # times at the main path's batch, on its channel outputs, "max" anchor
        gen = make_generator(7, dev)
        _, yr, yi, _, _ = build_frontend_fn(spec, 1024, dev)(params, gen, var15)
        yr, yi = yr.contiguous(), yi.contiguous()

        def run_k1():
            kmeans_estimate(yr, yi, tables, 20, "max")

        def run_plain():
            expand_candidates(*blind_estimate(yr, yi, tables, 20, "max"))

        reps = 20
        p1, k1t, k2t, p2 = (_time_ms(run_plain, reps), _time_ms(run_k1, reps),
                            _time_ms(run_k1, reps), _time_ms(run_plain, reps))
        times[fname] = ((k1t + k2t) / 2, (p1 + p2) / 2)
        log(f"K1 {fname} Nsym={nsym} B=1024: kernel {times[fname][0]:.4f} ms "
            f"(runs {k1t:.4f}, {k2t:.4f}), plain {times[fname][1]:.4f} ms "
            f"(runs {p1:.4f}, {p2:.4f})")
    log(f"K1 vs plain: 3 constellations x B in (1024, 100, 12, 7) x 2 anchors x 2 "
        f"inputs agree (max |err| {worst:.3g}, rtol {RTOL}, atol {ATOL}); "
        f"two launches bitwise equal")
    return dict(max_abs_err=worst, times=times)


def phase_main_path(card: str) -> int:
    import kmldpc_torch.__main__ as cli
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate

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
        f"K1 launches {launches}")
    return launches


def phase_parity(dev: torch.device) -> None:
    sys.path.insert(0, HERE)
    from kmldpc_tpu.config import load_config
    from kmldpc_tpu.utils.logging import SimLogger
    from kmldpc_torch.sim import Simulator
    from tools.parity import compare, parse_reference_log

    cfg = load_config(CONFIG)
    runs = (
        ("blind", cfg, "ref_blind_qpsk.log"),
        ("known-h", dataclasses.replace(
            cfg, decoder=dataclasses.replace(cfg.decoder, true_h_arg=True)),
         "ref_known_qpsk_r5.log"),
    )
    for name, c, ref_name in runs:
        quiet = SimLogger(log_dir=None, stdout=False)
        t0 = time.monotonic()
        results = Simulator(c, quiet, device=dev).simulate()
        wall = time.monotonic() - t0
        ref = parse_reference_log(os.path.join(PARITY_DIR, ref_name))
        rows = compare(ref, [dataclasses.asdict(r) for r in results], INFO_BITS)
        if len(rows) != len(results):
            raise AssertionError(f"{name}: {len(rows)} of {len(results)} points compared")
        worst = 0.0
        for r, res in zip(rows, results):
            worst = max(worst, abs(r["z_fer"]), abs(r["z_ber"]))
            log(f"parity {name} {r['snr']:6.2f} dB: FER {r['our_fer']:.5f} (ref "
                f"{r['ref_fer']:.5f}, z {r['z_fer']:+.2f}), BER {r['our_ber']:.6f} "
                f"(ref {r['ref_ber']:.6f}, z {r['z_ber']:+.2f}), {res.tot_blk} blocks, "
                f"{res.blocks_per_s:.1f} blocks/s")
        log(f"parity {name} vs {ref_name}: worst |z| = {worst:.3f} over "
            f"{len(rows)} points, sweep {wall:.3f} s")
        if not worst < 4.0:
            raise AssertionError(f"parity {name}: worst |z| {worst:.3f} >= 4")


def main() -> int:
    card, smi = phase_device()
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    k1 = phase_k1(dev)
    launches = phase_main_path(card)
    phase_parity(dev)
    k1_ms, plain_ms = k1["times"]["2bits_QPSK.txt"]
    kernels = {"kernels": [{
        "name": "K1 blind k-means gain estimate",
        "route": "cuda",
        "source": "kmldpc_torch/csrc/kmeans.cu",
        "replaces": "kmldpc_tpu/detect/kmeans_pallas.py:84",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}
    log(f"card: {smi}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
