"""Drive the PyTorch port (kmldpc_torch) on one CUDA card and check it.

    python3 chip_smoke.py [--counts-dir DIR]

Phases (any failure raises and exits non-zero):

1. device: require CUDA; print the card's name and power limit (nvidia-smi);
2. build: compile kernel K1 (csrc/kmeans.cu) from the checkout's sources;
2b. native: build the port's GF(2) eliminator (native/gf2_eliminate.cc)
   with g++, failing if it does not build (no NumPy fallback here), and on
   the three asset codes (PEG2304, PEG8064 forward, 5G BG2 K=960 reverse)
   hold ``systematize`` bitwise against the NumPy elimination (enc_h,
   perm, rank) and ``compile_code`` through it against the NumPy route
   (every ``LDPCCode`` field); host-clock times of both, beside the card
   and the host CPU.  Host code, not a kernel: it is not in the kernels
   line;
3. K1 against its plain PyTorch version on every row shape the later
   phases give it: QPSK / 16QAM Gray / 64QAM Gray at their PEG2304 symbol
   counts (15 dB channel outputs), 64QAM at PEG8064's (sweep 5's front
   end at 17.5 dB) and 16QAM at the 5G BG2 K=960 code's 480 symbols
   (sweep 4's front end at 14 dB), 256QAM at PEG8064's (the 256QAM cell's
   front end at 22.5 dB), each also on plain normal draws, B in
   {1024, 100, 12, 7} (256QAM also at the cell's 4096), both anchors
   (rtol 1e-5, atol 1e-6); two launches
   must agree
   bitwise, and so must the early exit with the fixed loop.  At B = 1024,
   CUDA events time the plain version, the wrapper, and raw launches of
   pre-built arguments (the kernel alone) with the fixed loop and with
   early exit, each beside the bound, with the spread of the passes the
   rows ran; the kernel alone also at B = 132 and 4096 beside the rows an
   SM holds at once;
3b. K2 against its plain version (the slot-major core) on known-h QPSK
   LLRs: PEG2304 at 12.5 dB, B = 16384 (the main path's cell), PEG8064 at
   17.5 dB, B = 2048, by the cell's [check] limits (rows whose iterations
   differ at most 0.002, whose decisions differ at most 0.005, soft p90 at
   most 0.001), two launches bitwise equal; CUDA events time the kernel
   alone, the wrapper, the plain core single-phase and the eager two-phase
   decode the chain ran before K2, beside the bound and the codewords an
   SM holds;
3c. K3 against its plain version (the degree-class core) on known-h 16QAM
   LLRs of the 5G BG2 K=960 code at 18 dB, B = 16384, by the known 5G
   cell's [check] limits (iterations apart at most 0.002, decisions apart
   at most 1e-4, soft p90 at most 0.001), two launches bitwise equal; CUDA
   events time the kernel alone, the wrapper, the plain core single-phase
   and the eager two-phase decode the chain ran before K3, beside the bound,
   the registers a thread and the codewords an SM; K3's launches are counted
   over phase 5's sweeps;
3d. K4 against the plain soft demapper on each cell's launch: PEG8064
   64QAM at B = 4096, 5G 16QAM at B = 32768 with 4 candidates and with
   one, PEG2304 QPSK at B = 16384, PEG8064 256QAM at B = 4096 with 4
   candidates and with one, its plain version run on slices of 512 and 2048
   codewords (random symbols over Rayleigh gains on the card): bitwise the
   plain version on every slice (K4 sums in the order of PyTorch's
   CUDA reductions), two launches bitwise equal; CUDA events time the
   kernel alone, the wrapper and the plain version, beside the bound (bytes
   at 3.35 TB/s, or one MUFU exponential a point a symbol-candidate); K4's
   launches are counted on the main path (phase 4) and, apart, over phase
   5's sweeps;
4. main path: ``kmldpc_torch.__main__.main`` on
   configs/main_path_blind_qpsk.toml restricted to 15 dB, with K1's, K2's
   and K4's launch counts reset just before and read just after (each must
   be above 0), then the same point three more times, warm, for its
   blocks/s;
5. parity: the full 7-point sweep of that config, blind and known-h
   (sequential), then all eleven sweeps of benchmarks/parity/configs in
   one call of ``kmldpc_torch.campaign.run_campaign``, which writes one
   JSON file a sweep (the z-tests read the counters back from those files,
   and they must equal ``parity_torch/`` file by file, ``blocks_per_s``
   aside), folded as their ``snr_fold = 8`` asks: 1 (known-h QPSK),
   2 (blind 16QAM), 3 (known-h 5G 16QAM), 3b (sweep 3 with layered
   min-sum), 4 (blind 5G 16QAM, soft metric), 5 (blind PEG8064 64QAM),
   6 (sweep 1 with bfloat16 messages), 7 (sweep 4 with layered min-sum for
   the final and the metric decodes), 8 (sweep 5 with flooding min-sum),
   9 (known-h QPSK, flooding min-sum) and 10 (blind QPSK, flooding
   min-sum, pruned candidates), each z-tested by tools/parity.py against
   its C++ reference log (|z| < 4, and the worst |z| the sequential path
   gave, to the digit), the min-sum, bfloat16 and pruned sweeps also
   against the JAX package's committed counts (|z| < 4), with K1's
   launches counted per sweep: some on every blind sweep, none on a
   known-h one; each run's exact counters on a ``parity-counts`` line;
6. harness: (a) configs/fast_stack_qpsk.toml in full, folded and
   sequential, bitwise equal counters, z-tested like the sweeps, K1
   launched; (b) a killed two-point cut of sweep 1 resumed from its
   checkpoint, sequential and folded, bitwise the uninterrupted run;
   (c) histogram files of a three-point cut of sweep 2, folded ==
   sequential byte for byte; (d) the k-means dump of sweep 2 at 18 dB;
   (e) debug lines folded == sequential; (f) the card's demapped 16QAM LLRs
   against a float64 demap beside the CPU's (sweep 3b and 7 shapes);
   (g) the edge-major reference decoder card against CPU, and the
   uniform-prior demap against the soft demap;
7. layered min-sum: sweep 3b's 12 dB LLRs at B = 1024 decoded on the card
   and on the CPU (hard outputs, iterations and convergence bitwise
   equal), the QC path against the generic path on the card (every output
   bitwise equal), and the generic path on PEG2304's whole-matrix layer
   (sweep 1's 5 dB LLRs) twice on the card (bitwise equal: the ordered
   adds are deterministic); CUDA events time the layered decode and the
   degree-class core's flooding min-sum on the same LLRs, single-phase and
   two-phase;
8. bfloat16 messages: sweep 6's back end at its 5 dB point, B = 1024, on
   the card and on the CPU from the same channel outputs: equal block
   errors;
8b. tools: every measurement tool of kmldpc_torch/tools at a cut depth,
   K1's microbench row held against the plain one, ``scaling`` on 2 gloo
   ranks;
8c. chain: microbench's ``chain`` group on all 15 rows of
   kmldpc_torch/tools/rows.py (every code, table, schedule, SNR and extra
   as the row has it, at its own batch; one sub-chunk a launch, fixed runs,
   one pass) and the session calibration at its pinned batch: every row
   present, positive and finite, info bits/s = blocks/s x info bits, a
   positive factor, and K1's launches, counted row by row, above 0 on the
   8 blind rows and 0 on the 7 known-h rows;
8d. bench: ``python -m kmldpc_torch.bench --cpl 1 --passes 1`` in a process
   of its own at a budget of 0 s, so the calibration and the headline are
   measured and the other 6 ranked rows print SKIPPED: the last stdout line
   has bench.py's four keys with a positive, finite value and
   vs_baseline, the headline's info bits/s = blocks/s x 1152, a positive
   session factor, and the rows file written where it was told;
9. profile: ``torch.profiler`` over one B = 1024 chunk of sweep 7 at 14 dB
   (blind 5G 16QAM, layered min-sum final and metric decodes), split by
   the chain's ``record_function`` labels;
10. profile_dir: one point of sweep 1 with ``[tpu] profile_dir``; its trace
    must exist and hold device kernels;
11. multi-rank: worker processes with torchrun's environment (this script
    with ``--rank-task``, and ``python -m kmldpc_torch``), gloo ranks
    sharing cuda:0 while this process's context idles; walls are host
    clock, beside the card's name and power limit, and speak of function
    and memory, not speed.  (a) The main path as 2 data ranks at B = 1024:
    one 15 dB launch bitwise the single-process launch of 512 codewords
    and twice the sub-chunks, the same on both ranks, K1 launched on each;
    then the 7-point blind sweep, z-tested (|z| < 4); (b) sweep 1 folded
    on 2 data ranks, z-tested; (c) both committed model-parallel configs
    as 8 ranks through the CLI: 16 blocks, FER < 1, the counters of the
    config without model_parallel on 2 data ranks; (d) PEG8064 64QAM
    known-h flooding min-sum at 18 dB, B = 1024, two launches as 2 x 4
    ranks and as 2 data ranks: equal counters, the wall of each launch
    and each rank's peak allocation; (e) the edge-sharded decoder alone on
    sweep 5's 17.5 dB LLRs at B = 1024 over 4 model ranks: decisions,
    convergence and iterations bitwise the single-process decoder's, soft
    syndromes within rtol 1e-3 and atol 1e-4, two-phase bitwise
    single-phase, the same on every rank, and the decode's peak allocation
    against the single process's; (f) a campaign (``run_campaign``) on 8
    ranks over configs/ and a copy of the main path's config at
    ``data_parallel = 2`` (ranks 2-7 idle for it): only rank 0 prints and
    writes the JAX tool's files and fields, the copy's counters are bitwise
    (a)'s 2-rank sweep, the model-parallel configs give (c)'s counters, the
    main path and the fast stack on 8 data ranks pass the z-test (|z| < 4),
    and K1 launches on every active rank of every config that runs it (the
    blind model-parallel config asks for the plain estimator,
    ``kmeans_impl = "jax"``, so K1 launches on no rank there); each
    config's host wall.

Phases 7-11 run after the sweeps and the harness: after a profiler session
the process's launch-bound work ran slower on the card, and the CPU decodes
of phases 7 and 8 share the host, so run earlier they would bias the
sweeps' blocks/s.  ``--counts-dir`` also writes each parity run's counters
(and the fast stack's) as one JSON file, in the format of
benchmarks/parity/ours_*.json.

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
    # the first point of linkbench's peg8064-256qam.blind
    ("PEG8064regular0.5.txt", "8bits_256QAM_Gray.txt", 1008, 22.5),
)
# batches K1 is held to the plain loop at beyond K1_BATCHES: the cell's launch
K1_MORE_BATCHES = {"8bits_256QAM_Gray.txt": (4096,)}
# sweeps of benchmarks/parity/configs and the C++ reference log each is held to
SWEEPS = (
    ("sweep1_known_qpsk.toml", "ref_known_qpsk_r5.log"),
    ("sweep2_blind_16qam.toml", "ref_blind_16qam.log"),
    ("sweep3_known_5g16qam.toml", "ref_known_5g16qam.log"),
    ("sweep3b_known_5g16qam_minsum.toml", "ref_known_5g16qam.log"),
    ("sweep4_blind_5g_soft.toml", "ref_blind_5g_soft.log"),
    ("sweep5_blind_8064_64qam.toml", "ref_blind_8064_64qam_r5.log"),
    ("sweep6_known_qpsk_bf16.toml", "ref_known_qpsk_r5.log"),
    ("sweep7_blind_5g_soft_minsum.toml", "ref_blind_5g_soft.log"),
    ("sweep8_blind_8064_fminsum.toml", "ref_blind_8064_64qam_r5.log"),
    ("sweep9_known_qpsk_fminsum.toml", "ref_known_qpsk_r5.log"),
    ("sweep10_blind_qpsk_fminsum_prune.toml", "ref_blind_qpsk.log"),
)
# the worst |z| of each parity run against its reference log, as the
# sequential path gave it (main-path pair, then sweeps 1-10 in SWEEPS'
# order); the folded sweeps must repeat it to the digit
EXPECTED_WORST_Z = dict(zip(
    ["blind QPSK", "known-h QPSK"] + [t.removesuffix(".toml") for t, _ in SWEEPS],
    ["1.453", "2.765", "1.931", "0.851", "1.376", "2.990", "2.408", "2.195", "1.931",
     "2.083", "1.891", "2.081", "2.265"]))
# the JAX package's committed counts for the configurations that differ
# from the C++ reference's algorithm
JAX_RECORDS = {
    "sweep3b_known_5g16qam_minsum": "ours_known_5g16qam_minsum_r5.json",
    "sweep6_known_qpsk_bf16": "ours_known_qpsk_bf16_r5.json",
    "sweep7_blind_5g_soft_minsum": "ours_blind_5g_soft_minsum_r5.json",
    "sweep8_blind_8064_fminsum": "ours_blind_8064_fminsum_r5.json",
    "sweep9_known_qpsk_fminsum": "ours_known_qpsk_fminsum_r5.json",
    "sweep10_blind_qpsk_fminsum_prune": "ours_blind_qpsk_fminsum_prune.json",
    "fast stack": "ours_blind_qpsk_fminsum_prune.json",
}
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
# the card's worst and mean |LLR error| against a float64 demap may exceed
# the CPU's by at most this factor (tests/test_torch_rounding.py's margin)
LLR_MARGIN = 1.10


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


NATIVE_CODES = (  # (code, reverse elimination) as compile_code picks it
    ("PEG2304regular0.5.txt", False),
    ("PEG8064regular0.5.txt", False),
    ("5GLDPCBG2a3_R12_K960.txt", True),
)
NATIVE_REPS = 3


def _host_cpu() -> str:
    """The host's CPU as /proc/cpuinfo gives it (vendor, family and model
    beside the name, which a virtual machine may withhold)."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break  # the first processor's block
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}), "
            f"{os.cpu_count()} CPUs")


def _host_times(fn, reps: int) -> tuple[list[float], object]:
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return times, out


def phase_native(smi: str) -> None:
    """The port's native GF(2) eliminator: built with g++ here, bitwise the
    NumPy elimination and the NumPy route of compile_code on the asset codes."""
    from unittest import mock

    import numpy as np

    from kmldpc_torch.code import compile_code, ldpc
    from kmldpc_torch.io import parse_hmatrix
    from kmldpc_torch.native import gf2_native

    cpu = _host_cpu()
    lib = gf2_native.library_path()
    found = os.path.exists(lib)
    t0 = time.monotonic()
    if not gf2_native.available():
        raise RuntimeError("native GF(2) eliminator did not build or load (warning above); "
                           "this machine has a C++ toolchain, so the NumPy fallback would "
                           "hide the module under test")
    log(f"native GF(2) eliminator: {os.path.basename(lib)} "
        f"{'found' if found else 'built with ' + gf2_native.CXX} in "
        f"{time.monotonic() - t0:.3f} s; host {cpu}")
    for fname, reverse in NATIVE_CODES:
        path = os.path.join(HERE, "assets", fname)
        h = parse_hmatrix(path).to_dense()
        nat_t, nat = _host_times(lambda: gf2_native.systematize(h, reverse), NATIVE_REPS)
        ref_t, ref = _host_times(lambda: ldpc._numpy_systematize(h, reverse), NATIVE_REPS)
        if not (nat[2] == ref[2] and np.array_equal(nat[1], ref[1])
                and np.array_equal(nat[0], ref[0])):
            raise RuntimeError(f"native GF(2) {fname}: native != NumPy elimination")
        name = os.path.splitext(fname)[0]
        code_t, code = _host_times(lambda: compile_code(parse_hmatrix(path), name=name), 1)
        with mock.patch.object(ldpc, "_native_or_numpy_systematize", ldpc._numpy_systematize):
            ref_code_t, ref_code = _host_times(
                lambda: compile_code(parse_hmatrix(path), name=name), 1)
        a, b = dataclasses.asdict(code), dataclasses.asdict(ref_code)
        bad = [k for k in a if not (
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            if isinstance(a[k], np.ndarray) else a[k] == b[k])]
        if bad:
            raise RuntimeError(f"native GF(2) {fname}: compile_code fields differ: {bad}")
        nat_s, ref_s = ("/".join(f"{t:.4f}" for t in ts) for ts in (nat_t, ref_t))
        log(f"native GF(2) {name} ({h.shape[0]}x{h.shape[1]}, "
            f"{'reverse' if reverse else 'forward'}, rank {nat[2]}): eliminator native "
            f"{nat_s} s, NumPy {ref_s} s ({min(ref_t) / min(nat_t):.2f}x, best of "
            f"{NATIVE_REPS}); compile_code native {code_t[0]:.4f} s, NumPy {ref_code_t[0]:.4f} s; "
            f"enc_h, perm, rank and every LDPCCode field bitwise equal; host clock, host {cpu}, "
            f"card {smi}")


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
        for b in (*K1_MORE_BATCHES.get(fname, ()), *K1_BATCHES):
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
    log(f"K1 vs plain: {len(K1_CASES)} row shapes x B in {K1_BATCHES} (and {K1_MORE_BATCHES}) "
        f"x 2 anchors x 2 "
        f"inputs agree (max |err| {worst:.3g}, rtol {RTOL}, atol {ATOL}); "
        f"two launches bitwise equal; early exit bitwise equal to the fixed loop")
    return dict(max_abs_err=worst, times=times)


K2_CASES = (  # (code, SNR of the known-h QPSK link in dB, B): the main path's shape at
    # a mid-grid point of linkbench's cell, and sweep 5's code at its first point
    ("PEG2304regular0.5.txt", 12.5, 16384),
    ("PEG8064regular0.5.txt", 17.5, 2048),
)
# K2's least time: 8 operations an edge an iteration (linkbench/roofline.py's
# count of the sum-product rule) for the iterations each codeword ran; its
# bytes are the LLRs read once and cc_hat, converged, iters and the soft
# syndrome written once
DECODE_OPS_PER_EDGE = 8
K2_LIMITS = dict(iters=0.002, decided=0.005, soft=0.001)  # the cell's [check] limits


def k2_bound_ms(t, b: int, iters: float, ops_rate: float) -> tuple[float, str]:
    """K2's least time for B codewords that ran ``iters`` iterations in all."""
    ops_s = DECODE_OPS_PER_EDGE * t.num_edges * iters / ops_rate
    bytes_s = b * (4 * (t.num_col - t.punct) + t.num_col + 1 + 4 + 4 * t.num_row) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _k2_gaps(k2, plain) -> dict:
    """The share of rows whose iterations or convergence differ, whose
    decisions differ, and the 90th percentile of each row's largest
    soft-syndrome difference (1 where the rows decode apart)."""
    iters_apart = (k2.iters != plain.iters) | (k2.converged != plain.converged)
    decided_apart = (k2.cc_hat != plain.cc_hat).any(dim=1)
    ss_err = (k2.soft_syndrome - plain.soft_syndrome).abs().amax(dim=1)
    ss_err = torch.where(decided_apart | iters_apart, 1.0, ss_err)
    return dict(iters=float(iters_apart.float().mean()),
                decided=float(decided_apart.float().mean()),
                soft=float(torch.quantile(ss_err, 0.9)))


def phase_k2(dev: torch.device, ops_rate: float) -> dict:
    """Kernel K2 against its plain version and the eager two-phase decode
    the chain ran before it, then timed."""
    import ctypes

    from kmldpc_torch import _build, constants
    from kmldpc_torch.code import load_code
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em, two_phase_generic
    from kmldpc_torch.decoder.bp import PHI_ARG_MIN
    from kmldpc_torch.decoder.bp_em import _batch_major, _decode_cols_padded
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops.modem import ModemTables, make_soft_demapper
    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn

    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    const = parse_constellation(os.path.join(HERE, "assets", "2bits_QPSK.txt"))
    result = {}
    for code_file, snr, b in K2_CASES:
        code = load_code(os.path.join(HERE, "assets", code_file))
        label = code_file.split("regular")[0]
        spec = ChainSpec(code=code, constellation=const, known_h=True, fading=True,
                         metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
        var = torch.tensor(10.0 ** (-0.1 * snr), dtype=torch.float32, device=dev)
        params = make_chain_params(code, dev)
        t = params.dec
        _, yr, yi, hr, hi = build_frontend_fn(spec, b, dev)(params, make_generator(11, dev), var)
        _, llr = make_soft_demapper(ModemTables.from_constellation(const, dev))(
            yr, yi, hr, hi, var)
        llr = llr.contiguous()
        k2 = flooding_decode_em(t, llr, spec.max_iter)
        again = flooding_decode_em(t, llr, spec.max_iter)
        plain = _batch_major(_decode_cols_padded(t, llr.T.contiguous(), spec.max_iter))
        tile = max(8, b // 8)

        def eager():
            return two_phase_generic(
                lambda x, n: _batch_major(_decode_cols_padded(t, x.T.contiguous(), n)),
                llr, spec.max_iter, spec.phase1_iters, tile)

        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(k2, again)):
            raise AssertionError(f"K2 {label}: two launches differ")
        gaps = _k2_gaps(k2, plain)
        if any(gaps[k] > lim for k, lim in K2_LIMITS.items()):
            raise AssertionError(f"K2 {label} {snr:g} dB against its plain version: {gaps}, "
                                 f"limits {K2_LIMITS}")
        bitwise = all(torch.equal(a, c) for a, c in zip(k2, plain))
        iters = float(k2.iters.sum())
        outs = (torch.empty((b, t.num_col), dtype=torch.int8, device=dev),
                torch.empty((b,), dtype=torch.bool, device=dev),
                torch.empty((b,), dtype=torch.int32, device=dev),
                torch.empty((b, t.num_row), dtype=torch.float32, device=dev))
        args = (llr.data_ptr(), t.perm_sm_c2r32.data_ptr(), t.row_col_sm32.data_ptr(),
                *(o.data_ptr() for o in outs), b, t.num_col, t.num_row, t.dc, t.dr, t.punct,
                spec.max_iter, PHI_ARG_MIN, constants.SMALLEST_PROB, constants.LLR_CLIP, stream)

        def kernel():
            if lib.kmldpc_bp_flood(*args) != 0:
                raise RuntimeError("K2 raw launch failed")

        def wrapper():
            flooding_decode_em(t, llr, spec.max_iter)

        def run_plain():
            _decode_cols_padded(t, llr.T.contiguous(), spec.max_iter)

        order = (("eager", eager, 2), ("plain", run_plain, 2), ("kernel", kernel, 20),
                 ("wrapper", wrapper, 20))
        runs = {name: [] for name, _, _ in order}
        for name, fn, n in (*order, *reversed(order)):
            runs[name].append(_time_ms(fn, n))
        ms = {name: sum(v) / len(v) for name, v in runs.items()}
        bound, bound_by = k2_bound_ms(t, b, iters, ops_rate)
        words = ctypes.c_int(0)
        if lib.kmldpc_bp_flood_words_per_sm(t.num_col, t.num_row, t.dc, t.dr,
                                           ctypes.byref(words)) != 0:
            raise RuntimeError("K2 occupancy query failed")
        kblk = b / 1000
        result[label] = dict(
            snr_db=snr, batch=b, mean_iters=iters / b, gaps=gaps, bitwise_plain=bitwise,
            ms=ms["kernel"], wrapper_ms=ms["wrapper"], plain_ms=ms["plain"],
            eager_two_phase_ms=ms["eager"], bound_ms=bound, bound_by=bound_by,
            words_per_sm=words.value, smem_bytes=bp_cuda.smem_bytes(t),
        )
        log(f"K2 {label} QPSK {snr:g} dB B={b}: mean iterations {iters / b:.4f}; against the "
            f"plain core: iterations apart {gaps['iters']:.3g}, decisions apart "
            f"{gaps['decided']:.3g}, soft p90 {gaps['soft']:.3g} (limits {K2_LIMITS}), "
            f"bitwise {bitwise}; two launches bitwise equal")
        log(f"K2 {label} B={b}: kernel alone {ms['kernel']:.4f} ms = "
            f"{ms['kernel'] / kblk:.4f} ms/kblk (runs " + ", ".join(
                f"{v:.4f}" for v in runs["kernel"]) + f"), bound {bound:.4f} ms by {bound_by}, "
            f"share {bound / ms['kernel']:.4f}; wrapper {ms['wrapper']:.4f} ms (runs "
            + ", ".join(f"{v:.4f}" for v in runs["wrapper"]) + f"); plain core single-phase "
            f"{ms['plain']:.3f} ms, eager two-phase (tile {tile}) {ms['eager']:.3f} ms = "
            f"{ms['eager'] / kblk:.4f} ms/kblk ({ms['eager'] / ms['kernel']:.1f}x the kernel); "
            f"{words.value} codewords an SM ({bp_cuda.smem_bytes(t)} bytes of shared memory "
            f"each)")
    return result


# K3's case: the known-h 16QAM 5G link of nr-bg2-16qam.known at a mid-grid
# point, at that cell's batch cut to a quarter (the plain core's [E, B]
# arrays and its 50 iterations are timed too)
K3_CASE = ("5GLDPCBG2a3_R12_K960.txt", "4bit_16QAM_Gray.txt", 18.0, 16384)
K3_LIMITS = dict(iters=0.002, decided=1e-4, soft=0.001)  # the known cell's [check] limits


def phase_k3(dev: torch.device, ops_rate: float) -> dict:
    """Kernel K3 against its plain version (the degree-class core) and the
    eager two-phase decode the chain ran before it, then timed."""
    import ctypes

    from kmldpc_torch import _build, constants
    from kmldpc_torch.code import load_code
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em, two_phase_generic
    from kmldpc_torch.decoder.bp import PHI_ARG_MIN
    from kmldpc_torch.decoder.bp_em import _batch_major, _decode_cols_classes, _insert_punct
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops.modem import ModemTables, make_soft_demapper
    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn

    code_file, table, snr, b = K3_CASE
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    const = parse_constellation(os.path.join(HERE, "assets", table))
    code = load_code(os.path.join(HERE, "assets", code_file))
    spec = ChainSpec(code=code, constellation=const, known_h=True, fading=True,
                     metric_type=True, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10.0 ** (-0.1 * snr), dtype=torch.float32, device=dev)
    params = make_chain_params(code, dev)
    t = params.dec
    _, yr, yi, hr, hi = build_frontend_fn(spec, b, dev)(params, make_generator(11, dev), var)
    _, llr = make_soft_demapper(ModemTables.from_constellation(const, dev))(yr, yi, hr, hi, var)
    llr = llr.contiguous()

    def plain_core(x, n):
        return _batch_major(_decode_cols_classes(t, _insert_punct(t, x.T.contiguous()), n))

    k3 = flooding_decode_em(t, llr, spec.max_iter)
    again = flooding_decode_em(t, llr, spec.max_iter)
    plain = plain_core(llr, spec.max_iter)
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(k3, again)):
        raise AssertionError("K3: two launches differ")
    gaps = _k2_gaps(k3, plain)
    if any(gaps[k] > lim for k, lim in K3_LIMITS.items()):
        raise AssertionError(f"K3 {snr:g} dB against its plain version: {gaps}, "
                             f"limits {K3_LIMITS}")
    bitwise = all(torch.equal(a, c) for a, c in zip(k3, plain))
    iters = float(k3.iters.sum())
    tile = max(8, b // 8)
    outs = (torch.empty((b, t.num_col), dtype=torch.int8, device=dev),
            torch.empty((b,), dtype=torch.bool, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev),
            torch.empty((b, t.num_row), dtype=torch.float32, device=dev))
    classes = bp_cuda.class_args(t)
    args = (llr.data_ptr(), t.perm_cf_c2r32.data_ptr(), t.row_col_cf32.data_ptr(),
            t.col_sort32.data_ptr(), t.col_unsort32.data_ptr(), t.row_unsort32.data_ptr(),
            *(o.data_ptr() for o in outs), b, t.num_col, t.num_row, t.punct, *classes,
            spec.max_iter, PHI_ARG_MIN, constants.SMALLEST_PROB, constants.LLR_CLIP, stream)

    def kernel():
        if lib.kmldpc_bp_flood_classes(*args) != 0:
            raise RuntimeError("K3 raw launch failed")

    def wrapper():
        flooding_decode_em(t, llr, spec.max_iter)

    def run_plain():
        plain_core(llr, spec.max_iter)

    def eager():
        return two_phase_generic(plain_core, llr, spec.max_iter, spec.phase1_iters, tile)

    order = (("eager", eager, 1), ("plain", run_plain, 1), ("kernel", kernel, 20),
             ("wrapper", wrapper, 20))
    runs = {name: [] for name, _, _ in order}
    for name, fn, n in (*order, *reversed(order)):
        runs[name].append(_time_ms(fn, n))
    ms = {name: sum(v) / len(v) for name, v in runs.items()}
    bound, bound_by = k2_bound_ms(t, b, iters, ops_rate)
    words, regs = ctypes.c_int(0), ctypes.c_int(0)
    if lib.kmldpc_bp_flood_classes_words_per_sm(t.num_col, t.num_row, *classes,
                                               ctypes.byref(words), ctypes.byref(regs)) != 0:
        raise RuntimeError("K3 occupancy query failed")
    kblk = b / 1000
    log(f"K3 5G BG2 16QAM {snr:g} dB B={b}: mean iterations {iters / b:.4f}; against the "
        f"plain core: iterations apart {gaps['iters']:.3g}, decisions apart "
        f"{gaps['decided']:.3g}, soft p90 {gaps['soft']:.3g} (limits {K3_LIMITS}), "
        f"bitwise {bitwise}; two launches bitwise equal")
    log(f"K3 B={b}: kernel alone {ms['kernel']:.4f} ms = {ms['kernel'] / kblk:.4f} ms/kblk "
        f"(runs " + ", ".join(f"{v:.4f}" for v in runs["kernel"]) + f"), bound {bound:.4f} ms "
        f"by {bound_by}, share {bound / ms['kernel']:.4f}; wrapper {ms['wrapper']:.4f} ms (runs "
        + ", ".join(f"{v:.4f}" for v in runs["wrapper"]) + f"); plain core single-phase "
        f"{ms['plain']:.3f} ms, eager two-phase (tile {tile}) {ms['eager']:.3f} ms = "
        f"{ms['eager'] / kblk:.4f} ms/kblk ({ms['eager'] / ms['kernel']:.1f}x the kernel); "
        f"{regs.value} registers a thread, {words.value} codewords an SM "
        f"({bp_cuda.smem_bytes(t)} bytes of shared memory each, and the class descriptors)")
    return dict(
        snr_db=snr, batch=b, mean_iters=iters / b, gaps=gaps, bitwise_plain=bitwise,
        ms=ms["kernel"], wrapper_ms=ms["wrapper"], plain_ms=ms["plain"],
        eager_two_phase_ms=ms["eager"], bound_ms=bound, bound_by=bound_by,
        words_per_sm=words.value, registers=regs.value, smem_bytes=bp_cuda.smem_bytes(t),
    )


# K4's cases: (name, table, symbols a codeword, candidates a codeword, B,
# codewords a call of the plain version, SNR in dB): each cell's launch, the
# 5G one both blind and with known h; at 256 points the plain version's
# [4B, 1008, 256, 8] products are 135 GB at B = 4096, so it runs on slices
# of the launch's codewords (independent rows), each held to K4's launch
K4_CASES = (
    ("PEG8064 64QAM", "6bits_64QAM_Gray.txt", 1344, 4, 4096, 4096, 20.0),
    ("5G 16QAM", "4bit_16QAM_Gray.txt", 480, 4, 32768, 32768, 19.0),
    ("5G 16QAM known", "4bit_16QAM_Gray.txt", 480, 1, 32768, 32768, 18.0),
    ("PEG2304 QPSK", "2bits_QPSK.txt", 1152, 4, 16384, 16384, 12.5),
    ("PEG8064 256QAM", "8bits_256QAM_Gray.txt", 1008, 4, 4096, 512, 27.5),
    ("PEG8064 256QAM known", "8bits_256QAM_Gray.txt", 1008, 1, 4096, 2048, 27.5),
)
# an SM's special-function units take 16 operations a clock against 128
# float32 lanes: the rate of K4's accurate expf, one MUFU.EX2 each
MUFU_SHARE = 16 / 128


def k4_bound_ms(b: int, nc: int, nsym: int, m_points: int, ops_rate: float) -> tuple[float, str]:
    """K4's least time: y read once, bit_p0 and the LLRs written once
    (float32), and one exponential a point a symbol-candidate."""
    m = m_points.bit_length() - 1
    bytes_s = (2 * 4 * b * nsym + 2 * 4 * b * nc * nsym * m) / HBM_BYTES_PER_S
    exp_s = b * nc * nsym * m_points / (ops_rate * MUFU_SHARE)
    return max(bytes_s, exp_s) * 1e3, "bytes" if bytes_s >= exp_s else "exponentials"


def phase_k4(dev: torch.device, ops_rate: float) -> dict:
    """Kernel K4 against the plain soft demapper on each cell's launch:
    bitwise equal on every slice the plain version runs on (the largest
    |LLR - plain| and the decisions apart are printed), two launches bitwise
    equal; then CUDA events time the kernel alone, the wrapper and the plain
    version on its first slice, beside the bound."""
    from kmldpc_torch import _build, constants
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops import demap_cuda
    from kmldpc_torch.ops.modem import ModemTables, make_plain_soft_demapper, make_soft_demapper

    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name, table, nsym, nc, b, plain_b, snr in K4_CASES:
        const = parse_constellation(os.path.join(HERE, "assets", table))
        tables = ModemTables.from_constellation(const, dev)
        demap, plain = make_soft_demapper(tables), make_plain_soft_demapper(tables)
        gen = torch.Generator(device=dev).manual_seed(23)
        var = torch.tensor(10.0 ** (-0.1 * snr), dtype=torch.float32, device=dev)
        h = torch.randn((b, 2), generator=gen, device=dev) * 0.5 ** 0.5
        idx = torch.randint(0, const.num_points, (b, nsym), generator=gen, device=dev)
        sr, si = tables.points_re[idx], tables.points_im[idx]
        w = torch.randn((b, nsym, 2), generator=gen, device=dev) * torch.sqrt(var / 2)
        yr = (h[:, :1] * sr - h[:, 1:] * si + w[..., 0]).contiguous()
        yi = (h[:, :1] * si + h[:, 1:] * sr + w[..., 1]).contiguous()
        rot = torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], device=dev)[:nc]
        hr = (h[:, :1] * rot[:, 0] - h[:, 1:] * rot[:, 1]).contiguous()
        hi = (h[:, :1] * rot[:, 1] + h[:, 1:] * rot[:, 0]).contiguous()
        if nc == 1:
            hr, hi = hr[:, 0].contiguous(), hi[:, 0].contiguous()
        before = demap_cuda.launch_k4.launches
        p0_k, llr_k = demap(yr, yi, hr, hi, var)
        again = demap(yr, yi, hr, hi, var)
        if demap_cuda.launch_k4.launches != before + 2:
            raise AssertionError(f"K4 {name}: the demapper did not launch K4")
        if not (torch.equal(p0_k, again[0]) and torch.equal(llr_k, again[1])):
            raise AssertionError(f"K4 {name}: two launches differ")
        llr_err, apart, bitwise = 0.0, 0.0, True
        for lo in range(0, b, plain_b):  # codewords lo.., their rows lo * nc..
            hi_ = lo + plain_b
            p0_p, llr_p = plain(yr[lo:hi_], yi[lo:hi_], hr[lo:hi_], hi[lo:hi_], var)
            p0_s, llr_s = p0_k[lo * nc:hi_ * nc], llr_k[lo * nc:hi_ * nc]
            llr_err = max(llr_err, float((llr_s - llr_p).abs().max()))
            apart = max(apart, float(((p0_s > 0.5) != (p0_p > 0.5)).float().mean()))
            bitwise &= bool(torch.equal(llr_s, llr_p) and torch.equal(p0_s, p0_p))
            del p0_p, llr_p
        if not bitwise:
            raise AssertionError(f"K4 {name}: not bitwise the plain version (|LLR - plain| up "
                                 f"to {llr_err:.3g}, decisions apart {apart:.3g})")
        slices = b // plain_b
        k4_table = demap_cuda.K4Table.read(tables.points_re, tables.points_im, tables.bit0_mask)
        outs = torch.empty_like(p0_k), torch.empty_like(llr_k)
        args = (yr.data_ptr(), yi.data_ptr(), hr.data_ptr(), hi.data_ptr(), nc, nc,
                var.data_ptr(), k4_table.points_re.ctypes.data,
                k4_table.points_im.ctypes.data, const.num_points, outs[0].data_ptr(),
                outs[1].data_ptr(), b, nsym, constants.SMALLEST_PROB,
                1.0 - constants.SMALLEST_PROB, constants.LLR_CLIP, stream)

        def kernel():
            if lib.kmldpc_demap(*args) != 0:
                raise RuntimeError("K4 raw launch failed")

        order = (("plain", lambda: plain(yr[:plain_b], yi[:plain_b], hr[:plain_b],
                                         hi[:plain_b], var), 2), ("kernel", kernel, 20),
                 ("wrapper", lambda: demap(yr, yi, hr, hi, var), 20))
        runs = {n: [] for n, _, _ in order}
        for n, fn, reps in (*order, *reversed(order)):
            runs[n].append(_time_ms(fn, reps))
        if not (torch.equal(outs[0], p0_k) and torch.equal(outs[1], llr_k)):
            raise AssertionError(f"K4 {name}: the raw launch differs from the wrapper's")
        ms = {n: sum(v) / len(v) for n, v in runs.items()}
        bound, bound_by = k4_bound_ms(b, nc, nsym, const.num_points, ops_rate)
        kblk = b / 1000
        log(f"K4 {name} B={b} nc={nc} Nsym={nsym} {snr:g} dB: against the plain demapper "
            f"on {slices} slice(s) of {plain_b} codewords, max |LLR - plain| {llr_err:.3g}, "
            f"decisions apart {apart:.3g}, bitwise {bitwise}; two launches bitwise equal")
        log(f"K4 {name} B={b} nc={nc}: kernel alone {ms['kernel']:.4f} ms = "
            f"{ms['kernel'] / kblk:.4f} ms/kblk (runs "
            + ", ".join(f"{v:.4f}" for v in runs["kernel"]) + f"), bound {bound:.4f} ms by "
            f"{bound_by}, share {bound / ms['kernel']:.4f}; wrapper {ms['wrapper']:.4f} ms; "
            f"plain on B={plain_b} {ms['plain']:.3f} ms = "
            f"{ms['plain'] / (plain_b / 1000):.4f} ms/kblk "
            f"({ms['plain'] * b / plain_b / ms['kernel']:.1f}x the kernel)")
        out[name] = dict(batch=b, candidates=nc, symbols=nsym, snr_db=snr, max_llr_err=llr_err,
                         decisions_apart=apart, bitwise_plain=bitwise, plain_slices=slices,
                         ms=ms["kernel"], wrapper_ms=ms["wrapper"], plain_ms=ms["plain"],
                         plain_batch=plain_b, bound_ms=bound, bound_by=bound_by)
        del p0_k, llr_k, again, outs
        torch.cuda.empty_cache()
    return out


def phase_main_path(card: str, dev: torch.device) -> tuple[int, int, int]:
    import kmldpc_torch.__main__ as cli
    from kmldpc_torch.config import load_config
    from kmldpc_torch.decoder.bp_cuda import launch_k2
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.ops.demap_cuda import launch_k4
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
        kmeans_estimate.launches = launch_k2.launches = launch_k4.launches = 0
        with contextlib.redirect_stdout(out):
            rc = cli.main([cfg_path, "--device", "cuda", "--no-log-file"])
        launches, k2_launches = kmeans_estimate.launches, launch_k2.launches
        k4_launches = launch_k4.launches
        # the same point warm: three more passes through the harness
        sim = Simulator(load_config(cfg_path), SimLogger(log_dir=None, stdout=False), device=dev)
        warm = [sim.run_snr_point(15.0).blocks_per_s for _ in range(4)][1:]
    text = out.getvalue()
    sys.stdout.write(text)
    if rc != 0:
        raise AssertionError(f"main path exited {rc}")
    if launches <= 0 or k2_launches <= 0 or k4_launches <= 0:
        raise AssertionError(f"the main path launched K1 {launches}, K2 {k2_launches} and K4 "
                             f"{k4_launches} times")
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
        f"K1 launches {launches}, K2 launches {k2_launches}, K4 launches {k4_launches}; warm "
        "repeats " + ", ".join(f"{w:.1f}" for w in warm) + " blocks/s")
    return launches, k2_launches, k4_launches


def _sweep_point(toml: str, dev: torch.device, snr_db: float, b: int, seed: int):
    """A parity sweep's spec and parameters on ``dev``, its noise variance at
    ``snr_db`` and one front-end draw (uu, yr, yi, hr, hi) of ``b`` blocks."""
    from kmldpc_torch.code import load_code
    from kmldpc_torch.config import load_config
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn

    cfg = load_config(os.path.join(PARITY_DIR, "configs", toml))
    code = load_code(cfg.matrix_path())
    spec = ChainSpec.from_config(cfg, code, parse_constellation(cfg.modem_path()))
    params = make_chain_params(code, dev, spec.schedule)
    var = torch.tensor(10.0 ** (-0.1 * snr_db), dtype=torch.float32, device=dev)
    front = build_frontend_fn(spec, b, dev)(params, make_generator(seed, dev), var)
    return spec, params, var, front


def _known_h_llr(spec, front, var) -> torch.Tensor:
    from kmldpc_torch.ops.modem import ModemTables, make_soft_demapper

    _, yr, yi, hr, hi = front
    tables = ModemTables.from_constellation(spec.constellation, yr.device)
    return make_soft_demapper(tables)(yr, yi, hr, hi, var)[1]


def _same(a, b, fields=("uu_hat", "cc_hat", "converged", "iters", "soft_syndrome")) -> bool:
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()) for f in fields)


def phase_layered(dev: torch.device) -> dict:
    from kmldpc_torch.decoder import (
        flooding_decode_em,
        layered_minsum_decode,
        minsum_tables,
        two_phase_generic,
    )

    b = 1024
    spec, params, var, front = _sweep_point("sweep3b_known_5g16qam_minsum.toml", dev, 12.0, b, 11)
    llr = _known_h_llr(spec, front, var)
    it, alpha, ms = spec.max_iter, spec.minsum_alpha, params.ms
    if ms.qc is None:
        raise AssertionError("the 5G code did not take the QC path")
    card = layered_minsum_decode(ms, llr, it, alpha)
    t0 = time.monotonic()
    cpu = layered_minsum_decode(minsum_tables(spec.code), llr.cpu(), it, alpha)
    cpu_s = time.monotonic() - t0
    if not _same(card, cpu, ("uu_hat", "cc_hat", "converged", "iters")):
        raise AssertionError("layered min-sum (QC path): card and CPU hard outputs differ")
    ss_err = float((card.soft_syndrome.cpu() - cpu.soft_syndrome).abs().max())
    generic = layered_minsum_decode(minsum_tables(spec.code, use_qc=False, device=dev), llr, it,
                                    alpha)
    if not _same(card, generic):
        raise AssertionError("layered min-sum on the card: QC and generic paths differ")
    log(f"layered min-sum, sweep 3b at 12 dB, B={b}: {int(card.converged.sum())} converged, "
        f"mean {float(card.iters.float().mean()):.3f} iterations; card == CPU (hard outputs, "
        f"iterations, convergence; soft syndromes max |diff| {ss_err:.3g}; CPU decode "
        f"{cpu_s:.3f} s); QC == generic on the card, every output")
    spec1, _, var1, front1 = _sweep_point("sweep1_known_qpsk.toml", dev, 5.0, b, 12)
    llr1 = _known_h_llr(spec1, front1, var1)
    mt_peg = minsum_tables(spec1.code, device=dev)
    if mt_peg.qc is not None or mt_peg.add_pos.shape[1] != 3:
        raise AssertionError("PEG2304 did not take the generic whole-matrix layer")
    runs = [layered_minsum_decode(mt_peg, llr1, it, alpha) for _ in range(2)]
    if not _same(*runs):
        raise AssertionError("layered min-sum (generic path): two runs on the card differ")
    log(f"layered min-sum, generic path, PEG2304 sweep 1 at 5 dB, B={b}: "
        f"{int(runs[0].converged.sum())} converged; two runs on the card bitwise equal")
    tile = spec.tile or max(8, b // 8)

    def layered(x, n):
        return layered_minsum_decode(ms, x, n, alpha)

    def flooding(x, n):
        return flooding_decode_em(params.dec, x, n, "minsum", alpha)

    fns = {
        "layered": lambda: layered(llr, it),
        "layered two-phase": lambda: two_phase_generic(layered, llr, it, spec.phase1_iters, tile),
        "flooding min-sum": lambda: flooding(llr, it),
        "flooding min-sum two-phase": lambda: two_phase_generic(
            flooding, llr, it, spec.phase1_iters, tile),
    }
    times = {name: _time_ms(fn, 3) for name, fn in fns.items()}
    log(f"decode times, 5G 16QAM sweep 3b at 12 dB, B={b}, {it} iterations at most "
        f"(CUDA events, mean of 3 after one warm-up): "
        + "; ".join(f"{name} {ms_:.3f} ms" for name, ms_ in times.items()))
    return times


def phase_bf16(dev: torch.device) -> None:
    from kmldpc_torch.params import make_chain_params
    from kmldpc_torch.sim.chain import build_backend_fn

    b = 1024
    spec, params, var, front = _sweep_point("sweep6_known_qpsk_bf16.toml", dev, 5.0, b, 13)
    card = build_backend_fn(spec, b, dev)(params, *front, var)
    cpu = build_backend_fn(spec, b, "cpu")(
        make_chain_params(spec.code, "cpu"), *(t.cpu() for t in front), var.cpu())
    blk = (int(card.err_blk), int(cpu.err_blk))
    log(f"bfloat16 messages, sweep 6 at 5 dB, B={b}: block errors card {blk[0]}, CPU {blk[1]}; "
        f"bit errors card {int(card.err_bit)}, CPU {int(cpu.err_bit)}")
    if blk[0] != blk[1]:
        raise AssertionError("bfloat16 back end: card and CPU block errors differ")


# phase 8b, the measurement tools at a cut depth: the decoder group at 5 of
# its 20 iterations, every row at fixed short and long runs of 2 and 6
# calls, one pass; snrfold_bench at 1024 of its 4096 blocks a point;
# locality at its depth but one pass; scaling at 64 codewords a rank (of
# 128) and a batch of 64 (of 256), on 2 ranks (of 4): data mode on 1 and
# 2 ranks, edge mode on 1 and 2 row shards (most of its time is starting
# the ranks)
TOOLS_ITERS, TOOLS_N1, TOOLS_N2 = 5, 2, 6
TOOLS_SNRFOLD_BLOCKS = 1024
TOOLS_SCALING_BATCH, TOOLS_SCALING_RANKS = 64, 2
TOOLS_DECODER_ROWS = [
    f"decoder/{code}/{label}" for code, labels in (
        ("PEG8064", ("flooding", "flooding[em]", "flooding-minsum[em]", "minsum[generic]")),
        ("5G-BG2-K960", ("flooding", "flooding[em]", "flooding-minsum[em]", "minsum[qc]",
                         "minsum[generic]")),
        ("PEG2304", ("flooding", "flooding[em]", "flooding-minsum[em]", "minsum[generic]")))
    for label in labels]
TOOLS_KMEANS_ROWS = [f"kmeans/{c}/{impl}" for c in ("QPSK", "16QAM", "64QAM")
                     for impl in ("plain", "cuda")]


def _tool(fn, *args, **kw):
    """``fn(*args, **kw)`` of a tool, its stderr lines logged."""
    with contextlib.redirect_stderr(io.StringIO()) as err:
        out = fn(*args, **kw)
    for line in err.getvalue().splitlines():
        log(f"tools {line}")
    return out


def _finite_rows(results: dict, keys: list[str], metric: str, failed: list[str]) -> None:
    for k in keys:
        v = results.get(k, {}).get(metric)
        if not (isinstance(v, (int, float)) and 0 < v < float("inf")):
            failed.append(f"{k}: {metric} {v}")


def _rank_tools(dev: torch.device, out: str) -> dict:
    """Phase 8b's scaling runs on one rank: data mode on 1 and 2 ranks,
    edge mode on 1 and 2 row shards; rank 0's lines."""
    from kmldpc_torch.tools import scaling

    with contextlib.redirect_stdout(io.StringIO()) as text:
        scaling.header(dev)
        data = scaling.data_mode(TOOLS_SCALING_BATCH, dev, [1, 2])
        edge = scaling.edge_mode(TOOLS_SCALING_BATCH, dev, [1, 2])
    return {"lines": text.getvalue().splitlines(), "data": data, "edge": edge}


def phase_tools(dev: torch.device, smi: str) -> None:
    """Phase 8b: every measurement tool of kmldpc_torch/tools at a cut depth
    (TOOLS_*): microbench's decoder group on the three codes at B = 1024 and
    its k-means group, plain and K1 (whose estimate must equal the plain
    one on the same inputs); snrfold_bench with bitwise counters; locality
    with its sanity decode on PEG8064; scaling on 2 gloo ranks.  Every row
    must be present, positive and finite.  Host clock, beside the card."""
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.ops import ModemTables
    from kmldpc_torch.tools import locality, microbench, snrfold_bench

    t_phase = time.monotonic()
    failed: list[str] = []
    rows: dict = {"device": microbench.device_name(dev)}
    t0 = time.monotonic()
    _tool(microbench.bench_decoders, rows, 1024, TOOLS_ITERS, 1, dev, n1=TOOLS_N1, n2=TOOLS_N2)
    _tool(microbench.bench_kmeans, rows, 1024, device=dev, n1=TOOLS_N1, n2=TOOLS_N2)
    mb_s = time.monotonic() - t0
    if sorted(rows) != sorted(["device", *TOOLS_DECODER_ROWS, *TOOLS_KMEANS_ROWS]):
        failed.append(f"microbench rows {sorted(rows)}")
    _finite_rows(rows, TOOLS_DECODER_ROWS, "us_per_iter", failed)
    _finite_rows(rows, TOOLS_KMEANS_ROWS, "us_per_call", failed)
    errs = {}
    for cname, fname, div in microbench.CONSTELLATIONS:
        tables = ModemTables.from_constellation(
            parse_constellation(os.path.join(microbench.ASSETS, fname)), dev)
        impls = microbench.kmeans_impls(tables, dev)
        y = microbench.seeded_normal(3 << 32 | 1, (2, 1024, 1152 // div), dev)
        ref, got = impls["plain"](y[0], y[1]), impls["cuda"](y[0], y[1])
        errs[cname] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if not all(torch.allclose(a, b, rtol=RTOL, atol=ATOL) for a, b in zip(got, ref)):
            failed.append(f"kmeans/{cname}: K1 differs from the plain estimate")
    log(f"tools microbench: {len(rows) - 1} rows in {mb_s:.3f} s; K1 (cuda row) against the "
        f"plain row on one call's inputs, max |err| "
        + ", ".join(f"{c} {e:.3g}" for c, e in errs.items()) + f" (rtol {RTOL}, atol {ATOL})")
    t0 = time.monotonic()
    fold = _tool(snrfold_bench.run, TOOLS_SNRFOLD_BLOCKS, 1024, dev)
    fold_s = time.monotonic() - t0
    for name in ("sequential", "folded7"):
        r = fold.get(f"snrfold/{name}", {})
        if r.get("points") != 7 or r.get("blocks") != 7 * TOOLS_SNRFOLD_BLOCKS:
            failed.append(f"snrfold/{name}: {r}")
        _finite_rows(fold, [f"snrfold/{name}"], "wall_s", failed)
    t0 = time.monotonic()
    loc = _tool(locality.run, "PEG8064regular0.5.txt", 1024, 20, 1, dev, n1=TOOLS_N1,
                n2=TOOLS_N2)
    loc_s = time.monotonic() - t0
    _finite_rows(loc, [f"locality/PEG8064regular0/{rule}/{label}" for rule in
                       ("minsum", "sumprod") for label in ("orig", "rcm")], "us_per_iter", failed)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as out:
        _spawn(TOOLS_SCALING_RANKS, [__file__, "--rank-task", "tools", "--out", out])
        ranks = _read_ranks(out, TOOLS_SCALING_RANKS)
    scale_s = time.monotonic() - t0
    for line in ranks[0]["lines"]:
        log(f"tools scaling: {line}")
    if any(r["lines"] for r in ranks[1:]):
        failed.append("scaling: a rank other than 0 printed")
    for mode, sizes in (("data", [1, 2]), ("edge", [1, 2])):
        got = ranks[0][mode]
        if [n for n, _ in got] != sizes or not all(0 < v < float("inf") for _, v in got):
            failed.append(f"scaling {mode}: {got}")
    log(f"tools phase: {time.monotonic() - t_phase:.3f} s (microbench {mb_s:.3f}, snrfold "
        f"{fold_s:.3f}, locality {loc_s:.3f}, scaling on {TOOLS_SCALING_RANKS} ranks "
        f"{scale_s:.3f}) host clock on {smi}")
    if failed:
        raise AssertionError("tools: " + "; ".join(failed))


# phase 8c, microbench's chain group cut in depth, never in width: every
# row at its own batch, code, table, schedule, SNR and extras, but one
# sub-chunk a launch (of 16 or 4 on the PEG2304 and 5G rows), fixed short
# and long runs of 1 and 2 calls and one pass (of 3); the calibration at
# its pinned batch, one sub-chunk a launch (of 16).  The batch stays: the
# decodes are launch-bound, and on the H100 a call at 512 codewords took
# as long as at 1024 (0.37-0.53 s on the 5G rows)
CHAIN_CPL, CHAIN_N1, CHAIN_N2 = 1, 1, 2


def phase_chain(dev: torch.device, smi: str) -> dict:
    """Phase 8c: microbench's ``chain`` group on every row of the port's
    row table and the session calibration, at a cut depth (CHAIN_*).
    K1's launch count is reset before each row and read after it: some on
    every blind row, none on a known-h row.  Returns the counts, row by
    row.  Host clock, beside the card."""
    from kmldpc_torch.code import load_code
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.tools import microbench
    from kmldpc_torch.tools.rows import CHAIN_ROWS

    t_phase = time.monotonic()
    failed: list[str] = []
    results: dict = {"device": microbench.device_name(dev)}
    launches: dict[str, int] = {}
    for r in CHAIN_ROWS:
        kmeans_estimate.launches = 0
        _tool(microbench.bench_chain, results, passes=1, device=dev, cpl=CHAIN_CPL, rows=[r],
              n1=CHAIN_N1, n2=CHAIN_N2)
        launches[r.name] = kmeans_estimate.launches
        if (launches[r.name] > 0) == r.known_h:
            failed.append(f"chain/{r.name}: {'known-h' if r.known_h else 'blind'} row launched "
                          f"K1 {launches[r.name]} times")
    t_cal = time.monotonic()
    factor = _tool(microbench.run_calibration, results, 1, dev, cpl=CHAIN_CPL, n1=CHAIN_N1,
                   n2=CHAIN_N2)
    cal_s = time.monotonic() - t_cal
    microbench.apply_calibration(results)
    keys = [f"chain/{r.name}" for r in CHAIN_ROWS]
    if list(results) != ["device", *keys, "_calibration"]:
        failed.append(f"chain rows {list(results)}")
    _finite_rows(results, keys, "blocks_per_s", failed)
    for r, k in zip(CHAIN_ROWS, keys):
        row = results.get(k, {})
        info = load_code(os.path.join(microbench.ASSETS, r.code)).code_dim
        bps = row.get("blocks_per_s", 0.0)
        # both rounded to 0.1 from one blk/s
        if abs(row.get("info_bits_per_s", -1.0) - bps * info) > 0.05 * info + 0.05:
            failed.append(f"{k}: info bits/s {row.get('info_bits_per_s')} against "
                          f"{bps} blk/s x {info}")
        if (row.get("batch"), row.get("chunks_per_launch")) != (r.batch or 1024, CHAIN_CPL):
            failed.append(f"{k}: shape {row.get('batch')} x {row.get('chunks_per_launch')}")
    if not (isinstance(factor, float) and 0 < factor < float("inf")):
        failed.append(f"calibration factor {factor}")
    log("chain K1 launches by row: " + ", ".join(f"{k} {n}" for k, n in launches.items()))
    log(f"chain phase: {time.monotonic() - t_phase:.3f} s ({len(keys)} rows, calibration "
        f"{cal_s:.3f}) host clock on {smi}")
    if failed:
        raise AssertionError("chain: " + "; ".join(failed))
    return launches


# phase 8d, the port's bench cut in depth: one sub-chunk a launch (of 16)
# and one pass (of 3); a budget of 0 s leaves the two mandatory rows
BENCH_ARGS = ("--cpl", "1", "--passes", "1")
BENCH_TIMEOUT_S = 300


def phase_bench(smi: str) -> None:
    """Phase 8d: ``python -m kmldpc_torch.bench`` at a cut depth
    (BENCH_ARGS) in a process of its own, as a user runs it, its stderr
    logged.  Host clock, beside the card."""
    t0 = time.monotonic()
    failed: list[str] = []
    with tempfile.TemporaryDirectory() as tmp:
        rows_path = os.path.join(tmp, "bench_rows.json")
        out = subprocess.run(
            [sys.executable, "-m", "kmldpc_torch.bench", *BENCH_ARGS, "--rows-out", rows_path],
            capture_output=True, text=True, cwd=HERE, timeout=BENCH_TIMEOUT_S,
            env=dict(os.environ, KMLDPC_BENCH_BUDGET_S="0"))
        for line in out.stderr.splitlines():
            log(f"bench {line}")
        if out.returncode:
            raise AssertionError(f"bench: exit {out.returncode}")
        written = None
        if os.path.exists(rows_path):
            with open(rows_path) as f:
                written = json.load(f)
        else:
            failed.append(f"no rows file at {rows_path}")
    lines = out.stdout.splitlines()
    log(f"bench stdout: {lines[-1] if lines else ''}")
    line = json.loads(lines[-1]) if lines else {}
    if list(line) != ["metric", "value", "unit", "vs_baseline"]:
        failed.append(f"last stdout line {line}")
    for k in ("value", "vs_baseline"):
        if not (isinstance(line.get(k), (int, float)) and 0 < line[k] < float("inf")):
            failed.append(f"{k} {line.get(k)}")
    err = out.stderr.splitlines()
    rows = {r["row"]: r for r in (json.loads(x.removeprefix("bench-row "))
                                  for x in err if x.startswith("bench-row "))}
    if list(rows) != ["PEG2304+QPSK/known", "PEG2304+QPSK/blind"]:
        failed.append(f"rows {list(rows)}")
    if sum(x.startswith("bench: SKIPPED ") for x in err) != 6:
        failed.append("not 6 SKIPPED rows")
    head = rows.get("PEG2304+QPSK/blind", {})
    bps = head.get("blocks_per_s", 0.0)
    # both rounded to 0.1 from one blk/s
    if abs(head.get("info_bits_per_s", -1.0) - bps * INFO_BITS) > 0.05 * INFO_BITS + 0.05:
        failed.append(f"headline info bits/s {head.get('info_bits_per_s')} against {bps} blk/s")
    if line.get("value") != head.get("info_bits_per_s"):
        failed.append(f"value {line.get('value')} is not the headline's info bits/s")
    factor = (written or {}).get("_calibration", {}).get("factor")
    if not (isinstance(factor, float) and 0 < factor < float("inf")):
        failed.append(f"calibration factor {factor}")
    log(f"bench phase: {time.monotonic() - t0:.3f} s (python -m kmldpc_torch.bench "
        f"{' '.join(BENCH_ARGS)}, budget 0 s) host clock on {smi}")
    if failed:
        raise AssertionError("bench: " + "; ".join(failed))


LABELS = ("frontend", "kmeans", "metric", "demap", "decode", "counters")


def phase_profile(dev: torch.device) -> None:
    """Where a 5G chunk's time goes: torch.profiler over one B = 1024 chunk of
    sweep 7 at 14 dB, by the chain's record_function labels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kmldpc_torch.ops.source import make_generator
    from kmldpc_torch.sim.chain import build_chain_fn

    b = 1024
    spec, params, var, _ = _sweep_point("sweep7_blind_5g_soft_minsum.toml", dev, 14.0, b, 14)
    chain = build_chain_fn(spec, b, dev)
    int(chain(params, make_generator(14, dev), var).err_blk)  # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        res = chain(params, make_generator(15, dev), var)
        int(res.err_blk)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.events()

    def device_ms(evs) -> float:  # device_time_total, cuda_time_total before torch 2.4
        name = "device_time_total" if hasattr(type(events[0]), "device_time_total") else (
            "cuda_time_total")
        return sum(getattr(e, name) for e in evs) / 1e3

    split = {}
    for label in LABELS:  # the host-side spans; their device time is their kernels'
        evs = [e for e in events if e.name == label and e.device_type == DeviceType.CPU]
        if evs:
            split[label] = (sum(e.cpu_time_total for e in evs) / 1e3, device_ms(evs))
    # device activities (kernels, copies), without the labels' own device-side spans
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in LABELS]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:  # union of the intervals
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    log(f"profile, sweep 7 at 14 dB, one chunk of B={b}: wall {wall * 1e3:.3f} ms, "
        f"{int(res.err_blk)} block errors, mean {float(res.iters):.3f} iterations, "
        f"{len(kernels)} device activities summing {device_ms(kernels):.3f} ms, busy "
        f"{busy_us / 1e3:.3f} ms (idle share of the wall {1 - busy_us / (wall * 1e6):.3f})")
    log("profile split (host ms in the span, device ms of its kernels): " + "; ".join(
        f"{label} {h:.3f} / {d:.3f}" for label, (h, d) in split.items()))
    if not kernels or "decode" not in split:
        raise AssertionError("the profiler saw no device kernel or no decode span")


def _worst_z(rows: list[dict]) -> float:
    return max((max(abs(r["z_fer"]), abs(r["z_ber"])) for r in rows), default=0.0)


def _z_against_jax_record(name: str, points: list[dict], info_bits: int, record: str) -> float:
    """Worst |z| of a sweep's counts against the JAX package's committed
    counts for the same configuration (tools/parity.py's compare, the JAX
    list keyed by SNR); logs it."""
    from tools.parity import compare

    with open(os.path.join(PARITY_DIR, record)) as f:
        ref = {o["snr"]: o for o in json.load(f)}
    rows = compare(ref, points, info_bits)
    worst = _worst_z(rows)
    log(f"parity {name} vs JAX record {record}: worst |z| = {worst:.3f} over {len(rows)} points")
    if len(rows) != len(points):
        raise AssertionError(f"{name}: {len(rows)} of {len(points)} points in {record}")
    return worst


COUNT_FIELDS = ("snr", "tot_blk", "err_blk", "err_bit", "tot_bit", "err_bit_sq", "ber", "fer",
                "blocks_per_s")


def _counts_line(name: str, points: list[dict]) -> list[dict]:
    """Print a sweep's exact counters as one ``parity-counts {json}`` line;
    returns the entries (the format of benchmarks/parity/ours_*.json)."""
    points = [{k: p[k] for k in COUNT_FIELDS} for p in points]
    print("parity-counts " + json.dumps({"sweep": name, "points": points}), flush=True)
    return points


def _counts_file(name: str) -> str:
    """The file of a parity run's counters (``--counts-dir``, ``parity_torch/``)."""
    return name.replace(" ", "_").replace("-", "_") + ".json"


def _judge_parity(name: str, ref_name: str, points: list[dict], info_bits: int, launches: int,
                  known_h: bool, wall: float, mode: str, failed: list[str]) -> None:
    """z-test one parity run against its C++ reference log (|z| < 4 and the
    sequential path's worst |z| to the digit) and, where the JAX package
    holds counts for its configuration, against those; K1 launched on a
    blind run and never on a known-h one."""
    from tools.parity import compare, parse_reference_log

    ref = parse_reference_log(os.path.join(PARITY_DIR, ref_name))
    rows = compare(ref, points, info_bits)
    if len(rows) != len(points):
        failed.append(f"{name}: {len(rows)} of {len(points)} points compared")
    if known_h == (launches > 0):
        failed.append(f"{name}: K1 launched {launches} times")
    rate = "blocks/s of attributed wall" if mode.startswith("folded") else "blocks/s"
    for r, p in zip(rows, points):
        log(f"parity {name} {r['snr']:6.2f} dB: FER {r['our_fer']:.5f} (ref "
            f"{r['ref_fer']:.5f}, z {r['z_fer']:+.2f}), BER {r['our_ber']:.6f} "
            f"(ref {r['ref_ber']:.6f}, z {r['z_ber']:+.2f}), {p['tot_blk']} blocks, "
            f"{p['blocks_per_s']:.1f} {rate}")
    worst = _worst_z(rows)
    log(f"parity {name} vs {ref_name}: worst |z| = {worst:.3f} over "
        f"{len(rows)} points, sweep {wall:.3f} s ({mode}), K1 launches {launches}")
    if not worst < 4.0:
        failed.append(f"parity {name}: worst |z| {worst:.3f} >= 4")
    if f"{worst:.3f}" != EXPECTED_WORST_Z[name]:
        failed.append(f"parity {name}: worst |z| {worst:.3f}, expected "
                      f"{EXPECTED_WORST_Z[name]} (the sequential path's)")
    if name in JAX_RECORDS and not _z_against_jax_record(
            name, points, info_bits, JAX_RECORDS[name]) < 4.0:
        failed.append(f"parity {name}: |z| >= 4 against {JAX_RECORDS[name]}")


def phase_parity(dev: torch.device, smi: str) -> dict:
    """The thirteen parity runs: the main path's blind and known-h pair
    through the Simulator, then the eleven sweeps through
    ``kmldpc_torch.campaign`` in one call, whose files the z-tests read;
    each sweep's counters must equal ``parity_torch/``'s, ``blocks_per_s``
    aside.  Returns each run's per-point counters."""
    from kmldpc_torch.campaign import run_campaign
    from kmldpc_torch.config import load_config
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    cfg = load_config(CONFIG)
    counts, failed = {}, []
    for name, c, ref_name in (
        ("blind QPSK", cfg, "ref_blind_qpsk.log"),
        ("known-h QPSK", _replace(cfg, decoder=dict(true_h_arg=True)), "ref_known_qpsk_r5.log"),
    ):
        sim = Simulator(c, SimLogger(log_dir=None, stdout=False), device=dev)
        t0 = time.monotonic()
        kmeans_estimate.launches = 0
        points = _sweep_results(sim.simulate())
        launches = kmeans_estimate.launches
        _judge_parity(name, ref_name, points, sim.code.code_dim, launches,
                      c.decoder.true_h_arg, time.monotonic() - t0, "sequential", failed)
        counts[name] = _counts_line(name, points)

    seen = {}

    @contextlib.contextmanager
    def watch(name, sim):  # K1's launches and the wall of each sweep alone
        kmeans_estimate.launches = 0
        t0 = time.monotonic()
        yield
        seen[name] = dict(launches=kmeans_estimate.launches, wall=time.monotonic() - t0,
                          slots=sim.snr_fold, asked=sim.cfg.tpu.snr_fold,
                          known_h=sim.cfg.decoder.true_h_arg, info_bits=sim.code.code_dim)

    paths = [os.path.join(PARITY_DIR, "configs", toml) for toml, _ in SWEEPS]
    names = [toml.removesuffix(".toml") for toml, _ in SWEEPS]
    with tempfile.TemporaryDirectory() as out:
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            summary = run_campaign(out, paths, dev, watch)
        campaign_s = time.monotonic() - t0
        files = {}
        for name in names + ["campaign"]:
            with open(os.path.join(out, f"{name}.json")) as f:
                files[name] = json.load(f)
    heads = [line for line in text.getvalue().splitlines() if line.startswith("=== ")]
    if heads != [f"=== {n} ===" for n in names] or files["campaign"] != summary:
        failed.append(f"campaign: headings {heads}, campaign.json {files['campaign']}")
    log(f"parity campaign: {len(names)} sweeps through kmldpc_torch.campaign in "
        f"{campaign_s:.3f} s host clock on {smi}; per config wall_s " + ", ".join(
            f"{s['config']} {s['wall_s']}" for s in summary))
    for (toml, ref_name), name in zip(SWEEPS, names):
        s, points = seen[name], files[name]
        if bool(s["slots"]) != (s["asked"] > 1):
            failed.append(f"{name}: snr_fold {s['asked']} ran with {s['slots']} slots")
        mode = f"folded, {s['slots']} slots" if s["slots"] else "sequential"
        _judge_parity(name, ref_name, points, s["info_bits"], s["launches"], s["known_h"],
                      s["wall"], mode, failed)
        counts[name] = _counts_line(name, points)
        with open(os.path.join(HERE, "parity_torch", _counts_file(name))) as f:
            committed = json.load(f)
        if ([{k: p[k] for k in COUNT_FIELDS[:-1]} for p in counts[name]]
                != [{k: p[k] for k in COUNT_FIELDS[:-1]} for p in committed]):
            failed.append(f"{name}: counts differ from parity_torch/{_counts_file(name)}")
    log(f"parity campaign: counts equal to parity_torch/ file by file: "
        f"{not any('parity_torch' in f for f in failed)}")
    if failed:
        raise AssertionError("; ".join(failed))
    return counts


def _replace(cfg, **over):
    """``cfg`` with some fields of its sections replaced."""
    for section, kv in over.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kv)})
    return cfg


def _sweep_cfg(toml: str, **over):
    from kmldpc_torch.config import load_config

    return _replace(load_config(os.path.join(PARITY_DIR, "configs", toml)), **over)


def _sweep_results(results) -> list[dict]:
    return [dataclasses.asdict(r) for r in results]


def _counters(results) -> list[tuple]:
    return [(r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit, r.err_bit_sq) for r in results]


def harness_fast_stack(dev: torch.device) -> tuple[int, list[dict]]:
    """(a) configs/fast_stack_qpsk.toml in full, folded (its snr_fold = 8,
    7 slots) and sequential: bitwise equal per-point counters, both z-tested
    against the C++ log and the JAX record, both launching K1."""
    from kmldpc_torch.config import load_config
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger
    from tools.parity import compare, parse_reference_log

    cfg = load_config(os.path.join(HERE, "configs", "fast_stack_qpsk.toml"))
    ref = parse_reference_log(os.path.join(PARITY_DIR, "ref_blind_qpsk.log"))
    out, launches = {}, {}
    for mode, fold in (("folded", cfg.tpu.snr_fold), ("sequential", 0)):
        sim = Simulator(_replace(cfg, tpu=dict(snr_fold=fold)),
                        SimLogger(log_dir=None, stdout=False), device=dev)
        kmeans_estimate.launches = 0
        t0 = time.monotonic()
        results = sim.simulate()
        wall = time.monotonic() - t0
        launches[mode] = kmeans_estimate.launches
        rows = compare(ref, [dataclasses.asdict(r) for r in results], sim.code.code_dim)
        worst = _worst_z(rows)
        log(f"harness fast stack {mode} ({sim.snr_fold} slots, {sim.runner.blocks_per_launch} "
            f"blocks a launch): {len(results)} points x {results[0].tot_blk} blocks, wall "
            f"{wall:.3f} s, K1 launches {launches[mode]}, worst |z| {worst:.3f} vs "
            f"ref_blind_qpsk.log; blocks/s " + ", ".join(f"{r.blocks_per_s:.1f}" for r in results))
        jax_z = _z_against_jax_record(f"fast stack {mode}", _sweep_results(results),
                                      sim.code.code_dim, JAX_RECORDS["fast stack"])
        if len(rows) != 7 or not worst < 4.0 or not jax_z < 4.0 or launches[mode] <= 0:
            raise AssertionError(f"fast stack {mode}: {len(rows)} points, |z| {worst:.3f} / "
                                 f"{jax_z:.3f}, K1 launches {launches[mode]}")
        out[mode] = results
    if _counters(out["folded"]) != _counters(out["sequential"]):
        raise AssertionError("fast stack: folded and sequential counters differ")
    log(f"harness fast stack: folded == sequential bitwise at all 7 points; K1 launches "
        f"folded {launches['folded']}, sequential {launches['sequential']}")
    return launches["folded"], _counts_line("fast stack", _sweep_results(out["folded"]))


class _Killed(RuntimeError):
    pass


def harness_resume(dev: torch.device) -> None:
    """(b) Checkpoint kill and resume on the card: a two-point cut of sweep 1
    (one sub-chunk a launch, 6 launches a point) killed at its fourth
    runner call, then resumed, sequential and folded; each resume gives
    bitwise the counters of an uninterrupted run, and the folded run the
    sequential one's."""
    from kmldpc_torch.sim import Simulator, make_chunk_runner
    from kmldpc_torch.utils import SimLogger

    with tempfile.TemporaryDirectory() as tmp:
        def cfg(name, fold):
            return _sweep_cfg("sweep1_known_qpsk.toml",
                              range=dict(minimum_snr=5.0, maximum_snr=7.5),
                              tpu=dict(chunks_per_launch=1, snr_fold=fold,
                                       checkpoint_path=os.path.join(tmp, name)))

        def killing(real):
            calls = {"n": 0}

            def run(*args):
                if calls["n"] == 3:
                    raise _Killed()
                calls["n"] += 1
                return real(*args)

            run.blocks_per_launch = real.blocks_per_launch
            return run

        results = {}
        for mode, fold in (("sequential", 0), ("folded", 2)):
            quiet = SimLogger(log_dir=None, stdout=False)
            if fold:
                sim = Simulator(cfg(mode, fold), quiet, device=dev)
                sim.runner = killing(sim.runner)
            else:
                seed = cfg(mode, fold).tpu.seed
                sim = Simulator(cfg(mode, fold), quiet, device=dev, runner_factory=(
                    lambda spec, batch: killing(make_chunk_runner(spec, batch, 1, dev, seed))))
            try:
                sim.simulate()
                raise AssertionError(f"{mode}: the killing runner never raised")
            except _Killed:
                pass
            with open(os.path.join(tmp, mode)) as f:
                state = json.load(f)["snr"]
            consumed = {k: v["chunks"] for k, v in state.items()}
            resumed = Simulator(cfg(mode, fold), SimLogger(log_dir=None, stdout=False),
                                device=dev).simulate()
            control = Simulator(cfg(mode + "-control", fold),
                                SimLogger(log_dir=None, stdout=False), device=dev).simulate()
            if _counters(resumed) != _counters(control):
                raise AssertionError(f"{mode} resume differs from an uninterrupted run")
            results[mode] = control
            log(f"harness resume {mode}: killed at runner call 4 with launches consumed "
                f"{consumed}; resumed == uninterrupted bitwise "
                f"({[(r.snr, r.tot_blk, r.err_blk, r.err_bit) for r in resumed]})")
    if _counters(results["sequential"]) != _counters(results["folded"]):
        raise AssertionError("resume cut: folded and sequential counters differ")


def harness_histogram(dev: torch.device) -> None:
    """(c) Histogram mode on sweep 2 (blind 16QAM) cut to three points of
    2048 blocks: folded and sequential files byte-identical, one row a
    block, minimum first."""
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    here = os.getcwd()
    texts = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for mode, fold in (("sequential", 0), ("folded", 8)):
                os.makedirs(os.path.join(tmp, mode))
                os.chdir(os.path.join(tmp, mode))
                c = _sweep_cfg("sweep2_blind_16qam.toml", histogram=dict(enable=True),
                               range=dict(maximum_snr=15.0, maximum_block_number=2048),
                               tpu=dict(snr_fold=fold))
                Simulator(c, SimLogger(log_dir=None, stdout=False), device=dev).simulate()
                texts[mode] = {f: open(f, "rb").read() for f in sorted(os.listdir("."))}
        finally:
            os.chdir(here)
    if list(texts["sequential"]) != [f"histogram_{snr:.6f}.txt" for snr in (10.0, 12.5, 15.0)]:
        raise AssertionError(f"histogram files: {list(texts['sequential'])}")
    if texts["sequential"] != texts["folded"]:
        raise AssertionError("histogram: folded and sequential files differ")
    blocks = c.range.maximum_block_number
    for name, text in texts["folded"].items():
        rows = [[float(v) for v in line.split()] for line in text.decode().splitlines()]
        if len(rows) != blocks or any(len(r) != 4 or r[0] != min(r) for r in rows):
            raise AssertionError(f"{name}: {len(rows)} rows, not {blocks} rotated 4-metric rows")
    log("harness histogram: sweep 2 at 10, 12.5, 15 dB, 2048 blocks each: folded files "
        "byte-identical to the sequential ones, 2048 rows each, minimum first")


def harness_kmeans_dump(dev: torch.device) -> None:
    """(d) The k-means dump on sweep 2 at 18 dB, 4 blocks: four files, the
    clusters the constellation times hHats[0] (rtol 1e-5), idx the
    nearest-cluster assignment."""
    import numpy as np
    from scipy.io import loadmat

    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "km")
        c = _sweep_cfg("sweep2_blind_16qam.toml", range=dict(maximum_block_number=1024),
                       tpu=dict(snr_fold=0, kmeans_dump_dir=d, kmeans_dump_blocks=4))
        sim = Simulator(c, SimLogger(log_dir=None, stdout=False), device=dev)
        kmeans_estimate.launches = 0
        sim.run_snr_point(18.0)
        files = sorted(os.listdir(d))
        if files != [f"kmeans_snr18.000_blk{j}.mat" for j in range(4)]:
            raise AssertionError(f"k-means dump files: {files}")
        worst = 0.0
        for name in files:
            m = loadmat(os.path.join(d, name))
            y, cl, const, h_hats = (np.asarray(m[k]).ravel()
                                    for k in ("data", "cluster", "constellations", "hHats"))
            np.testing.assert_allclose(cl, const * h_hats[0], rtol=1e-5, atol=1e-6)
            idx = np.asarray(m["idx"]).ravel()
            np.testing.assert_array_equal(idx, (np.abs(y[:, None] - cl[None, :]) ** 2).argmin(1))
            worst = max(worst, float(np.abs(cl - const * h_hats[0]).max()))
    if kmeans_estimate.launches <= 0:
        raise AssertionError("the k-means dump did not run K1")
    log(f"harness k-means dump: 4 files at 18 dB, clusters = constellation x hHats[0] "
        f"(max |diff| {worst:.3g}), idx the nearest clusters; K1 launches "
        f"{kmeans_estimate.launches}")


def harness_debug_blocks(dev: torch.device) -> None:
    """(e) debug_blocks on sweep 2 cut to two points of 1024 blocks: the
    folded per-block lines equal the sequential ones."""
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    pat = re.compile(r"(Generated H = .*|Current Block Number = .*|Hhat = .*|hatIndex = .*)$")
    lines = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, fold in (("sequential", 0), ("folded", 8)):
            c = _sweep_cfg("sweep2_blind_16qam.toml",
                           range=dict(maximum_snr=12.5, maximum_block_number=1024),
                           tpu=dict(snr_fold=fold, debug_blocks=3))
            logger = SimLogger(log_dir=os.path.join(tmp, mode), stdout=False)
            Simulator(c, logger, device=dev).simulate()
            logger.close()
            with open(logger._path) as f:
                lines[mode] = [m.group(1) for m in map(pat.search, f.read().splitlines()) if m]
    if len(lines["sequential"]) != 2 * 3 * 7 or lines["sequential"] != lines["folded"]:
        raise AssertionError(f"debug lines: {len(lines['sequential'])} sequential, "
                             f"{len(lines['folded'])} folded, equal "
                             f"{lines['sequential'] == lines['folded']}")
    log(f"harness debug_blocks: {len(lines['folded'])} folded lines == sequential; first "
        f"{lines['folded'][0]!r}")


def harness_llr(dev: torch.device) -> None:
    """(f) The card's demapped LLRs against a float64 Bayes demap, beside
    the CPU's, on the sweep 3b (known h, 12 dB) and sweep 7 (blind, the
    selection's winner, 14 dB) shapes at B = 1024 from the port's front
    end."""
    import numpy as np

    from kmldpc_torch import constants
    from kmldpc_torch.ops.modem import ModemTables, make_soft_demapper

    for toml, snr, seed in (("sweep3b_known_5g16qam_minsum.toml", 12.0, 21),
                            ("sweep7_blind_5g_soft_minsum.toml", 14.0, 22)):
        spec, params, var, front = _sweep_point(toml, dev, snr, 1024, seed)
        _, yr, yi, hr, hi = front
        if not spec.known_h:
            from kmldpc_torch.sim.chain import build_backend_fn

            # histogram mode: the selection's metrics and candidates, no decode
            dbg = build_backend_fn(dataclasses.replace(spec, debug_blocks=1, histogram=True),
                                   1024, dev)(params, *front, var)
            win = dbg.metrics.argmin(dim=1)
            rows = torch.arange(1024, device=dev)
            hr, hi = dbg.debug[2][rows, win], dbg.debug[3][rows, win]
        tables = ModemTables.from_constellation(spec.constellation, dev)
        card = make_soft_demapper(tables)(yr, yi, hr, hi, var)[1].cpu().numpy()
        cpu = make_soft_demapper(ModemTables.from_constellation(spec.constellation))(
            *(t.cpu() for t in (yr, yi, hr, hi)), var.cpu())[1].numpy()
        y = yr.double().cpu().numpy() + 1j * yi.double().cpu().numpy()
        h = hr.double().cpu().numpy() + 1j * hi.double().cpu().numpy()
        d2 = np.abs(y[:, :, None] - h[:, None, None] * spec.constellation.points) ** 2
        logits = -d2 / float(var)
        p = np.exp(logits - logits.max(axis=-1, keepdims=True))
        p = np.clip(p / p.sum(axis=-1, keepdims=True), constants.SMALLEST_PROB,
                    1 - constants.SMALLEST_PROB)
        mask0 = spec.constellation.bit0_mask().astype(np.float64)
        ref = np.clip((np.log(p @ mask0) - np.log(p @ (1 - mask0))).reshape(1024, -1),
                      -constants.LLR_CLIP, constants.LLR_CLIP)
        e_card, e_cpu = np.abs(card - ref), np.abs(cpu - ref)
        log(f"harness LLR vs float64, {toml.split('_')[0]} at {snr:g} dB, B=1024: card max "
            f"{e_card.max():.4g} mean {e_card.mean():.4g}; CPU max {e_cpu.max():.4g} mean "
            f"{e_cpu.mean():.4g}; card == CPU on {np.mean(card == cpu):.4f} of the LLRs")
        if not (e_card.max() <= LLR_MARGIN * e_cpu.max() and
                e_card.mean() <= LLR_MARGIN * e_cpu.mean()):
            raise AssertionError(f"{toml}: the card's LLRs are further from float64 than "
                                 f"{LLR_MARGIN} x the CPU's")


def harness_library_ops(dev: torch.device) -> None:
    """(g) The edge-major reference decoder on sweep 1's 5 dB LLRs at
    B = 1024, card against CPU (block errors, convergence and the converged
    codewords' bits equal, as the slot-major core's card tests ask) and
    against the slot-major core on the card; the uniform-prior demap
    against the soft demap on the card."""
    from kmldpc_torch.decoder import DecoderTables, flooding_decode, flooding_decode_em
    from kmldpc_torch.ops.modem import ModemTables, make_prior_demapper, make_soft_demapper

    spec, params, var, front = _sweep_point("sweep1_known_qpsk.toml", dev, 5.0, 1024, 23)
    llr = _known_h_llr(spec, front, var)
    card = flooding_decode(params.dec, llr, spec.max_iter)
    t0 = time.monotonic()
    cpu = flooding_decode(DecoderTables.from_code(spec.code), llr.cpu(), spec.max_iter)
    cpu_s = time.monotonic() - t0
    core = flooding_decode_em(params.dec, llr, spec.max_iter)
    conv = cpu.converged
    same_conv = torch.equal(card.converged.cpu(), conv) and torch.equal(core.converged, card.converged)
    same_bits = torch.equal(card.uu_hat.cpu()[conv], cpu.uu_hat[conv])
    differ = int((card.uu_hat.cpu() != cpu.uu_hat).sum())
    ms = _time_ms(lambda: flooding_decode(params.dec, llr, spec.max_iter), 3)
    log(f"harness edge-major decoder, sweep 1 at 5 dB, B=1024: {int(conv.sum())} converged on "
        f"card and CPU (same: {same_conv}), converged bits equal: {same_bits}, differing bits "
        f"on unconverged codewords {differ}; card {ms:.3f} ms (CUDA events, mean of 3), CPU "
        f"{cpu_s:.3f} s")
    if not (same_conv and same_bits):
        raise AssertionError("edge-major decoder: card and CPU disagree on converged codewords")
    _, yr, yi, hr, hi = front
    tables = ModemTables.from_constellation(spec.constellation, dev)
    p0_u, llr_u = make_soft_demapper(tables)(yr, yi, hr, hi, var)
    prior = torch.full_like(p0_u, 0.5)
    p0_p, llr_p = make_prior_demapper(tables)(yr, yi, hr, hi, var, prior)
    torch.testing.assert_close(p0_p, p0_u, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(llr_p, llr_u, rtol=1e-4, atol=1e-4)
    log(f"harness prior demap, uniform priors, on the card: equal to the soft demap "
        f"(max |LLR diff| {float((llr_p - llr_u).abs().max()):.3g})")


def phase_harness(dev: torch.device) -> tuple[int, list[dict]]:
    """The harness knobs on the card, (a) to (g); returns the fast stack's
    folded K1 launches and counters."""
    t0 = time.monotonic()
    fast = harness_fast_stack(dev)
    harness_resume(dev)
    harness_histogram(dev)
    harness_kmeans_dump(dev)
    harness_debug_blocks(dev)
    harness_llr(dev)
    harness_library_ops(dev)
    log(f"harness phase: {time.monotonic() - t0:.3f} s")
    return fast


def phase_profile_dir(dev: torch.device) -> None:
    """(h) [tpu] profile_dir: one point of sweep 1 under torch.profiler; a
    trace file with device events must exist."""
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "prof")
        c = _sweep_cfg("sweep1_known_qpsk.toml", range=dict(maximum_snr=5.0,
                                                             maximum_block_number=1024),
                       tpu=dict(snr_fold=0, profile_dir=d))
        Simulator(c, SimLogger(log_dir=None, stdout=False), device=dev).simulate()
        traces = os.listdir(d)
        with open(os.path.join(d, traces[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    log(f"profile_dir: {traces[0]}, {len(events)} events, {len(kernels)} device kernels")
    if len(traces) != 1 or not kernels:
        raise AssertionError(f"profile_dir: traces {traces}, {len(kernels)} kernels")


# --- phase 11: multi-rank runs, gloo ranks sharing cuda:0 ---------------------

RANK_TIMEOUT_S = 400  # each launch of ranks; every rank is killed when it runs out
MP_CONFIGS = ("peg8064_model_parallel.toml", "peg8064_blind_model_parallel.toml")
MP_BATCH, MP_SNR = 1024, 18.0  # (d): PEG8064 64QAM known-h flooding min-sum
F_DP2 = "main_path_blind_qpsk_dp2"  # (f): the main path's config at data_parallel = 2
EDGE_SNR, EDGE_SEED = 17.5, 21  # (e): sweep 5's first point


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, args: list[str]) -> list[str]:
    """``python *args`` once per rank of an ``n``-rank run, with torchrun's
    environment; the ranks share cuda:0 over gloo.  Returns each rank's
    stdout; a rank that fails or outlives RANK_TIMEOUT_S fails the phase,
    and every rank still running is killed."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *args], cwd=HERE, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(n)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {n} ({' '.join(args)}) exited {p.returncode}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    return [out for out, _ in outs]


def _launch_counters(res) -> dict:
    return dict(err_bit=int(res.err_bit), err_blk=int(res.err_blk), tot_bit=int(res.tot_bit),
                tot_blk=int(res.tot_blk), err_bit_sq=float(res.err_bit_sq))


def _timed_launches(runner, dev, var: float, launches: int) -> dict:
    """``launches`` launches at MP_SNR: their counters, the host wall of each
    (ended by a synchronise, started after a barrier), the memory the rank
    held before them and its peak during them."""
    import torch.distributed as dist

    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts = [], []
    for launch in range(launches):
        dist.barrier()
        t0 = time.monotonic()
        res = runner(MP_SNR, launch, var)
        counts.append(_launch_counters(res))
        torch.cuda.synchronize(dev)
        walls.append(time.monotonic() - t0)
    return dict(counters=counts, wall_s=walls, resident_bytes=resident,
                peak_bytes=torch.cuda.max_memory_allocated(dev))


def _spec_of(cfg):
    from kmldpc_torch.code import load_code
    from kmldpc_torch.io import parse_constellation
    from kmldpc_torch.sim import ChainSpec

    return ChainSpec.from_config(cfg, load_code(cfg.matrix_path()),
                                 parse_constellation(cfg.modem_path()))


def _mp_spec():
    """(d)'s configuration, configs/peg8064_model_parallel.toml, and its seed."""
    from kmldpc_torch.config import load_config

    cfg = load_config(os.path.join(HERE, "configs", MP_CONFIGS[0]))
    return _spec_of(cfg), cfg.tpu.seed


def _decode_peak(decode, llr: torch.Tensor, iters: int, dev: torch.device):
    """``decode(llr, iters)`` and the most it allocated on ``dev`` above
    what was allocated before it (its result included)."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res = decode(llr, iters)
    torch.cuda.synchronize(dev)
    return res, torch.cuda.max_memory_allocated(dev) - base


def _rank_dp(dev: torch.device, out: str) -> dict:
    """The 2-rank data-parallel runs: (a) one main-path launch and the full
    blind sweep, (b) folded sweep 1, and the data-parallel halves of (c)
    and (d)."""
    from kmldpc_torch.config import load_config
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate
    from kmldpc_torch.parallel import Grid, make_sharded_chunk_runner
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    quiet = SimLogger(log_dir=None, stdout=False)
    result = {}
    cfg = _replace(load_config(CONFIG), tpu=dict(data_parallel=2))
    sim = Simulator(cfg, quiet, device=dev)
    spec, b = sim.spec, sim.batch
    grid = Grid(2)
    run = make_sharded_chunk_runner(spec, b, grid, cfg.tpu.chunks_per_launch, dev, cfg.tpu.seed)
    kmeans_estimate.launches = 0
    result["a_launch"] = _launch_counters(run(15.0, 0, 10.0 ** -1.5))
    result["a_launch_k1"] = kmeans_estimate.launches
    kmeans_estimate.launches = 0
    t0 = time.monotonic()
    result["a_sweep"] = _sweep_results(sim.simulate())
    result["a_sweep_s"] = time.monotonic() - t0
    result["a_sweep_k1"] = kmeans_estimate.launches
    result["a_batch"] = b
    sim1 = Simulator(_sweep_cfg("sweep1_known_qpsk.toml", tpu=dict(data_parallel=2)), quiet,
                     device=dev)
    t0 = time.monotonic()
    result["b_sweep"] = _sweep_results(sim1.simulate())
    result["b_sweep_s"] = time.monotonic() - t0
    result["b_slots"] = sim1.snr_fold
    for name in MP_CONFIGS:
        c = _replace(load_config(os.path.join(HERE, "configs", name)),
                     tpu=dict(model_parallel=0))
        result[f"c_{name}"] = _sweep_results(Simulator(c, quiet, device=dev).simulate())
    spec, seed = _mp_spec()
    runner = make_sharded_chunk_runner(spec, MP_BATCH, grid, 1, dev, seed)
    result["d"] = _timed_launches(runner, dev, 10.0 ** (-0.1 * MP_SNR), 2)
    return result


def _rank_mp(dev: torch.device, out: str) -> dict:
    """The 8-rank (2 data x 4 model) runs: (d) two model-parallel launches,
    (e) the edge-sharded decoder alone on the LLRs the parent wrote, on each
    data row's 4 model ranks, single-phase and two-phase."""
    import torch.distributed as dist

    from kmldpc_torch.code import load_code
    from kmldpc_torch.parallel import (
        Grid,
        make_edge_sharded_decoder,
        make_model_parallel_chunk_runner,
    )

    grid = Grid(2, 4)
    spec, seed = _mp_spec()
    runner = make_model_parallel_chunk_runner(spec, MP_BATCH, grid, 1, dev, seed)
    result = {"d": _timed_launches(runner, dev, 10.0 ** (-0.1 * MP_SNR), 2)}
    edge = torch.load(os.path.join(out, "edge.pt"))
    llr = edge["llr"].to(dev)
    code = load_code(os.path.join(HERE, "assets", "PEG8064regular0.5.txt"))  # sweep 5's
    one = make_edge_sharded_decoder(code, grid, "sumprod", device=dev)
    two = make_edge_sharded_decoder(code, grid, "sumprod", phase1_iters=edge["phase1"],
                                    tile=edge["tile"], device=dev)
    walls, peaks = [], []
    for dec in (one, two):
        dist.barrier()
        t0 = time.monotonic()
        res, peak = _decode_peak(dec, llr, edge["iters"], dev)
        walls.append(time.monotonic() - t0)
        peaks.append(peak)
        if dec is one:
            single = res
    result["e_wall_s"], result["e_peak_bytes"] = walls, peaks
    result["e_two_phase_bitwise"] = all(torch.equal(a, b) for a, b in zip(single, res))
    same = True  # every rank holds rank 0's result
    for t in single:
        t0 = t.clone()
        dist.broadcast(t0, src=0)
        same = same and torch.equal(t0, t)
    result["e_same_on_ranks"] = same
    if dist.get_rank() == 0:
        torch.save({f: t.cpu() for f, t in zip(single._fields, single)},
                   os.path.join(out, "edge_out.pt"))
    return result


def _rank_campaign(dev: torch.device, out: str) -> dict:
    """(f) one rank of a campaign over the configs the parent listed: into
    ``campaign_r<rank>`` (only rank 0 may write), with K1's launches and
    whether the config's layout holds this rank, config by config."""
    import torch.distributed as dist

    from kmldpc_torch.campaign import run_campaign
    from kmldpc_torch.detect.kmeans_cuda import kmeans_estimate

    with open(os.path.join(out, "campaign_paths.json")) as f:
        paths = json.load(f)
    seen = {}

    @contextlib.contextmanager
    def watch(name, sim):
        kmeans_estimate.launches = 0
        yield
        seen[name] = dict(k1=kmeans_estimate.launches, active=sim.grid.active,
                          k1_path=not sim.cfg.decoder.true_h_arg
                          and sim.cfg.tpu.kmeans_impl in ("auto", "pallas"))

    with contextlib.redirect_stdout(io.StringIO()) as text:
        summary = run_campaign(os.path.join(out, f"campaign_r{dist.get_rank()}"), paths, dev,
                               watch)
    return {"f_configs": seen, "f_summary": summary, "f_stdout": text.getvalue()}


def rank_worker(task: str, out: str) -> int:
    """One rank of phase 11 (``--rank-task``): joins the process group from
    torchrun's environment, runs its task on cuda:(LOCAL_RANK % cards) and
    writes ``rank<r>.json`` into ``out``."""
    import torch.distributed as dist

    from kmldpc_torch.parallel import maybe_initialize, rank_device

    sys.path.insert(0, HERE)
    if not maybe_initialize("cuda"):
        raise SystemExit("chip_smoke --rank-task needs WORLD_SIZE > 1")
    dev = rank_device("cuda")
    rank = dist.get_rank()
    try:
        result = {"dp": _rank_dp, "mp": _rank_mp, "campaign": _rank_campaign,
                  "tools": _rank_tools}[task](dev, out)
        result["backend"] = dist.get_backend()
        result["device"] = str(dev)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def _read_ranks(out: str, n: int) -> list[dict]:
    results = []
    for r in range(n):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _z_sweep(name: str, points: list[dict], ref_name: str, info_bits: int) -> float:
    from tools.parity import compare, parse_reference_log

    rows = compare(parse_reference_log(os.path.join(PARITY_DIR, ref_name)), points, info_bits)
    for r in rows:
        log(f"multi-rank {name} {r['snr']:6.2f} dB: FER {r['our_fer']:.5f} (ref "
            f"{r['ref_fer']:.5f}, z {r['z_fer']:+.2f}), BER {r['our_ber']:.6f} "
            f"(ref {r['ref_ber']:.6f}, z {r['z_ber']:+.2f})")
    worst = _worst_z(rows)
    log(f"multi-rank {name} vs {ref_name}: worst |z| = {worst:.3f} over {len(rows)} points")
    if len(rows) != len(points) or not worst < 4.0:
        raise AssertionError(f"multi-rank {name}: {len(rows)} of {len(points)} points, "
                             f"worst |z| {worst:.3f}")
    return worst


def _point_counters(points: list[dict]) -> list[tuple]:
    """The counters of a sweep's points, without their rank-local walls."""
    return [(p["snr"], p["tot_blk"], p["err_blk"], p["err_bit"], p["tot_bit"], p["err_bit_sq"])
            for p in points]


def _cli_counters(out: str) -> tuple:
    """(tot_blk, err_blk, err_bit) of the last ``SNR = ... Total blk`` line."""
    found = re.findall(r"Total blk =\s+(\d+) Error blk =\s+(\d+) Error bit =\s+(\d+)", out)
    if not found:
        raise AssertionError(f"no counters in the CLI's output:\n{out[-2000:]}")
    return tuple(int(v) for v in found[-1])


def _mib(n: float) -> str:
    return f"{n / 2**20:.1f} MiB"


def phase_multi_rank(dev: torch.device, smi: str) -> tuple[list[int], dict]:
    """Phase 11: multi-rank runs as gloo ranks sharing cuda:0 (function and
    memory, not speed); returns K1's launches on each rank of (a)'s sweep,
    and on each rank of each config of (f)'s campaign that runs K1."""
    from kmldpc_torch.config import load_config
    from kmldpc_torch.decoder import flooding_decode_em
    from kmldpc_torch.sim import Simulator, make_chunk_runner
    from kmldpc_torch.utils import SimLogger

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        # (e)'s LLRs and its single-process reference, on the card
        spec5, params5, var5, front5 = _sweep_point("sweep5_blind_8064_64qam.toml", dev,
                                                    EDGE_SNR, MP_BATCH, EDGE_SEED)
        llr = _known_h_llr(spec5, front5, var5)
        tile = spec5.tile or max(8, MP_BATCH // 8)
        torch.save({"llr": llr.cpu(), "iters": spec5.max_iter, "phase1": spec5.phase1_iters,
                    "tile": tile}, os.path.join(out, "edge.pt"))
        ref_e, ref_peak = _decode_peak(lambda x, n: flooding_decode_em(params5.dec, x, n), llr,
                                       spec5.max_iter, dev)
        # (a)'s single-process launch: B/2 codewords, 2 x the sub-chunks
        cfg = load_config(CONFIG)
        ref_a = _launch_counters(make_chunk_runner(
            _spec_of(cfg), cfg.tpu.batch // 2, 2 * cfg.tpu.chunks_per_launch, dev,
            cfg.tpu.seed)(15.0, 0, 10.0 ** -1.5))
        del front5, params5
        torch.cuda.empty_cache()

        t0 = time.monotonic()
        _spawn(2, [__file__, "--rank-task", "dp", "--out", out])
        dp = _read_ranks(out, 2)
        dp_s = time.monotonic() - t0
        t0 = time.monotonic()
        _spawn(8, [__file__, "--rank-task", "mp", "--out", out])
        mp = _read_ranks(out, 8)
        mp_s = time.monotonic() - t0
        edge = torch.load(os.path.join(out, "edge_out.pt"))
        cli = {}
        for name in MP_CONFIGS:
            t0 = time.monotonic()
            outs = _spawn(8, ["-m", "kmldpc_torch", os.path.join(HERE, "configs", name),
                              "--device", "cuda", "--no-log-file"])
            cli[name] = (outs, time.monotonic() - t0)
        # (f) a campaign over configs/ and the main path at data_parallel = 2
        with open(CONFIG) as f:
            text = f.read().replace("[tpu]\n", "[tpu]\n    data_parallel = 2\n", 1)
        dp2 = os.path.join(out, F_DP2 + ".toml")
        with open(dp2, "w") as f:
            f.write(text)
        with open(os.path.join(out, "campaign_paths.json"), "w") as f:
            json.dump([os.path.join(HERE, "configs"), dp2], f)
        t0 = time.monotonic()
        _spawn(8, [__file__, "--rank-task", "campaign", "--out", out])
        camp_s = time.monotonic() - t0
        camp = _read_ranks(out, 8)
        camp_dirs = {r: sorted(os.listdir(os.path.join(out, f"campaign_r{r}")))
                     for r in range(8) if os.path.isdir(os.path.join(out, f"campaign_r{r}"))}
        camp_files = {}
        for n in camp_dirs.get(0, []):
            with open(os.path.join(out, "campaign_r0", n)) as f:
                camp_files[n] = json.load(f)

    failed = []
    backends = sorted({r["backend"] for r in dp + mp})
    devices = sorted({r["device"] for r in dp + mp})
    log(f"multi-rank: gloo ranks sharing {dev} ({smi}); backends {backends}, devices "
        f"{devices}; walls are host clock, function and memory, not speed")
    # (a) one launch, bitwise the single-process launch of B/2 x 2n, on both ranks
    a = [r["a_launch"] for r in dp]
    log(f"multi-rank (a) main path, 2 data ranks, B={dp[0]['a_batch']} "
        f"({dp[0]['a_batch'] // 2} a rank), 15 dB, "
        f"one launch: {a[0]}; single process B={cfg.tpu.batch // 2} x "
        f"{2 * cfg.tpu.chunks_per_launch} sub-chunks: {ref_a}; K1 launches "
        f"per rank {[r['a_launch_k1'] for r in dp]}")
    if a[0] != a[1]:
        failed.append("(a) counters differ between the ranks")
    if any(a[0][k] != ref_a[k] for k in ("err_bit", "err_blk", "tot_bit", "tot_blk")):
        failed.append("(a) counters differ from the single-process launch")
    if abs(a[0]["err_bit_sq"] - ref_a["err_bit_sq"]) > 1e-6 * abs(ref_a["err_bit_sq"]):
        failed.append("(a) err_bit_sq beyond rtol 1e-6")
    if any(r["a_launch_k1"] <= 0 for r in dp):
        failed.append("(a) K1 never launched on a rank")
    if any(_point_counters(dp[0][k]) != _point_counters(dp[1][k])
           for k in ("a_sweep", "b_sweep")):
        failed.append("(a)/(b) sweep counters differ between the ranks")
    k1_ranks = [r["a_sweep_k1"] for r in dp]
    _z_sweep("(a) blind QPSK, 2 data ranks", dp[0]["a_sweep"], "ref_blind_qpsk.log", INFO_BITS)
    log(f"multi-rank (a) sweep: {dp[0]['a_sweep_s']:.3f} s host clock on {smi}, K1 launches "
        f"per rank {k1_ranks}")
    if any(k <= 0 for k in k1_ranks):
        failed.append("(a) K1 never launched on a rank in the sweep")
    _z_sweep(f"(b) sweep 1 folded ({dp[0]['b_slots']} slots), 2 data ranks", dp[0]["b_sweep"],
             "ref_known_qpsk_r5.log", INFO_BITS)
    log(f"multi-rank (b) sweep: {dp[0]['b_sweep_s']:.3f} s host clock on {smi}")
    if not dp[0]["b_slots"]:
        failed.append("(b) sweep 1 did not run folded")
    # (c) the committed model-parallel configs, 8 ranks through the CLI
    for name in MP_CONFIGS:
        outs, wall = cli[name]
        ours = _cli_counters(outs[0])
        p = dp[0][f"c_{name}"][-1]
        want = (p["tot_blk"], p["err_blk"], p["err_bit"])
        log(f"multi-rank (c) {name}: 8 ranks via python -m kmldpc_torch, (tot_blk, err_blk, "
            f"err_bit) {ours}; 2 data ranks without model_parallel {want}; {wall:.3f} s host "
            f"clock on {smi}")
        if "Mesh: 2 data x 4 model ranks" not in outs[0] or any(o for o in outs[1:]):
            failed.append(f"(c) {name}: not a 2 x 4 run printed by rank 0 alone")
        if ours[0] != 16 or not ours[1] < 16 or ours != want:
            failed.append(f"(c) {name}: counters {ours}, data-parallel {want}")
    # (d) PEG8064 at B = 1024: 2 x 4 ranks against 2 data ranks
    dd, md = dp[0]["d"], mp[0]["d"]
    if any(r["d"]["counters"] != dd["counters"] for r in dp + mp):
        failed.append("(d) model-parallel counters differ from the data-parallel ones")
    b_rank = MP_BATCH // 2
    log(f"multi-rank (d) PEG8064 64QAM known-h flooding min-sum {MP_SNR:g} dB, B={MP_BATCH} "
        f"({b_rank} a data rank), two launches: counters {dd['counters']} (2 data ranks) == "
        f"2 x 4 ranks; c2v state a rank: data-parallel {_mib(24192 * b_rank * 4)}, "
        f"model-parallel {_mib(6048 * b_rank * 4)}")
    for label, runs in (("2 data ranks", dp), ("2 x 4 ranks", mp)):
        log(f"multi-rank (d) {label}: wall per launch (host clock, rank 0) "
            f"{', '.join(f'{w:.3f}' for w in runs[0]['d']['wall_s'])} s; per rank resident / "
            f"peak torch.cuda.max_memory_allocated: " + "; ".join(
                f"r{k} {_mib(r['d']['resident_bytes'])} / {_mib(r['d']['peak_bytes'])}"
                for k, r in enumerate(runs)) + f" ({smi}, ranks sharing one card)")
    peak_mp = max(r["d"]["peak_bytes"] - r["d"]["resident_bytes"] for r in mp)
    peak_dp = max(r["d"]["peak_bytes"] - r["d"]["resident_bytes"] for r in dp)
    log(f"multi-rank (d) peak above resident, worst rank: model-parallel {_mib(peak_mp)}, "
        f"data-parallel {_mib(peak_dp)} (ratio {peak_mp / peak_dp:.3f})")
    # (e) the edge-sharded decoder alone against the single-process decoder
    bitwise = all(torch.equal(edge[f], getattr(ref_e, f).cpu())
                  for f in ("uu_hat", "cc_hat", "converged", "iters"))
    ss_err = float((edge["soft_syndrome"] - ref_e.soft_syndrome.cpu()).abs().max())
    ss_ok = torch.allclose(edge["soft_syndrome"], ref_e.soft_syndrome.cpu(), rtol=1e-3,
                           atol=1e-4)
    log(f"multi-rank (e) edge-sharded decoder, sweep 5 at {EDGE_SNR:g} dB, B={MP_BATCH}, "
        f"4 model ranks (x 2 data rows): {int(edge['converged'].sum())} converged; decisions, "
        f"convergence, iterations == single process: {bitwise}; soft syndromes max |diff| "
        f"{ss_err:.3g} (rtol 1e-3, atol 1e-4: {ss_ok}); two-phase == single-phase bitwise on "
        f"every rank: {all(r['e_two_phase_bitwise'] for r in mp)}; every rank holds rank 0's "
        f"result: {all(r['e_same_on_ranks'] for r in mp)}; wall single / two-phase "
        f"{mp[0]['e_wall_s'][0]:.3f} / {mp[0]['e_wall_s'][1]:.3f} s host clock on {smi}")
    log(f"multi-rank (e) decode peak above what was allocated before it: single process "
        f"{_mib(ref_peak)}; per model rank, single-phase / two-phase: " + "; ".join(
            f"r{k} {_mib(r['e_peak_bytes'][0])} / {_mib(r['e_peak_bytes'][1])}"
            for k, r in enumerate(mp)) + f" (ratio of the worst single-phase rank "
        f"{max(r['e_peak_bytes'][0] for r in mp) / ref_peak:.3f}; c2v state "
        f"{_mib(24192 * MP_BATCH * 4)} whole, {_mib(6048 * MP_BATCH * 4)} a slab; {smi})")
    if not (bitwise and ss_ok and all(r["e_two_phase_bitwise"] and r["e_same_on_ranks"]
                                      for r in mp)):
        failed.append("(e) edge-sharded decoder disagrees")
    # (f) the campaign on 8 ranks: one layout a config over the first ranks
    k1_campaign = _judge_campaign(camp, camp_dirs, camp_files, dp, failed, smi)
    # (g) the main path at data_parallel = 2 in this one process
    t0 = time.monotonic()
    sim = Simulator(_replace(cfg, tpu=dict(data_parallel=2)), SimLogger(log_dir=None,
                                                                        stdout=False), device=dev)
    one = _sweep_results(sim.simulate())
    sim.close()
    same = _point_counters(one) == _point_counters(dp[0]["a_sweep"])
    log(f"multi-rank (g) main path at data_parallel = 2 in one process ({sim.ndata} data "
        f"shards on {sim.grid.ndata} rank, B={sim.batch}): counters == (a)'s 2-rank sweep "
        f"bitwise: {same}; {time.monotonic() - t0:.3f} s host clock on {smi}")
    if not same or (sim.ndata, sim.grid.ndata) != (2, 1):
        failed.append("(g) data_parallel = 2 in one process differs from (a)'s 2-rank sweep")
    log(f"multi-rank phase: {time.monotonic() - t_phase:.3f} s (2 ranks {dp_s:.3f} s, "
        f"8 ranks {mp_s:.3f} s, CLI {', '.join(f'{w:.3f}' for _, w in cli.values())} s, "
        f"campaign {camp_s:.3f} s) on {smi}")
    if failed:
        raise AssertionError("multi-rank: " + "; ".join(failed))
    return k1_ranks, k1_campaign


def _judge_campaign(camp: list[dict], dirs: dict, files: dict, dp: list[dict],
                    failed: list[str], smi: str) -> dict:
    """(f)'s checks: rank 0 alone prints and writes the JAX tool's files and
    fields; the data_parallel = 2 copy's counters are bitwise (a)'s 2-rank
    sweep; the model-parallel configs give (c)'s counters; the main path and
    the fast stack on 8 data ranks pass the z-test; K1 launched on every
    active rank of every config that runs it and on no other.  Returns K1's
    launches per rank of each config that runs it."""
    from kmldpc_torch.campaign import POINT_FIELDS

    names = [n.removesuffix(".toml") for n in sorted(os.listdir(os.path.join(HERE, "configs")))
             if n.endswith(".toml")] + [F_DP2]
    summary = camp[0]["f_summary"]
    want_files = sorted([f"{n}.json" for n in names] + ["campaign.json"])
    if list(dirs) != [0] or dirs[0] != want_files:
        failed.append(f"(f) written {dirs}, expected rank 0 alone with {want_files}")
    if any(r["f_stdout"] for r in camp[1:]) or camp[0]["f_stdout"].count("=== ") != len(names):
        failed.append("(f) not printed by rank 0 alone, one heading a config")
    if files.get("campaign.json") != summary or [s["config"] for s in summary] != names or any(
            list(s) != ["config", "wall_s", "points", "blocks"] for s in summary):
        failed.append(f"(f) campaign.json {files.get('campaign.json')}")
    if any(list(p) != list(POINT_FIELDS) for n in names for p in files.get(f"{n}.json", [{}])):
        failed.append("(f) a config's points lack the JAX tool's fields")
    for s in summary:
        active = [r for r in range(8) if camp[r]["f_configs"][s["config"]]["active"]]
        log(f"multi-rank (f) campaign config {s['config']}: {s['points']} points, {s['blocks']} "
            f"blocks, wall_s {s['wall_s']} host clock on {smi}; active ranks {active}; K1 "
            f"launches per rank {[r['f_configs'][s['config']]['k1'] for r in camp]}")
    if _point_counters(files.get(f"{F_DP2}.json", [])) != _point_counters(dp[0]["a_sweep"]):
        failed.append("(f) the data_parallel = 2 copy differs from (a)'s 2-rank sweep")
    for name in MP_CONFIGS:
        got, want = files.get(name.replace(".toml", ".json"), []), dp[0][f"c_{name}"]
        if (not got or _point_counters(got) != _point_counters(want)
                or got[-1]["tot_blk"] != 16 or not got[-1]["err_blk"] < 16):
            failed.append(f"(f) {name}: {_point_counters(got)}, 2 data ranks "
                          f"{_point_counters(want)}")
    for name in ("main_path_blind_qpsk", "fast_stack_qpsk"):
        _z_sweep(f"(f) {name}, 8 data ranks", files.get(f"{name}.json", []), "ref_blind_qpsk.log",
                 INFO_BITS)
    k1 = {}
    for name in names:
        need = 2 if name == F_DP2 else 8
        ranks = [r["f_configs"][name] for r in camp]
        if [c["active"] for c in ranks] != [r < need for r in range(8)]:
            failed.append(f"(f) {name}: active ranks {[c['active'] for c in ranks]}")
        if ranks[0]["k1_path"]:
            k1[name] = [c["k1"] for c in ranks]
        if any((c["k1"] > 0) != (c["active"] and c["k1_path"]) for c in ranks):
            failed.append(f"(f) {name}: K1 launches per rank {[c['k1'] for c in ranks]}")
    if not k1:
        failed.append("(f) no config ran K1")
    held = not any(f.startswith("(f)") for f in failed)
    log(f"multi-rank (f) checks {'held' if held else 'failed'}: rank 0 alone writes and prints, "
        f"the data_parallel = 2 copy == (a)'s 2-rank sweep bitwise, the model-parallel configs "
        f"== (c), K1 on every active rank of every config that runs it; K1 per rank {k1}")
    return k1


def write_counts(counts: dict, directory: str) -> None:
    """One file a parity run, in the format of benchmarks/parity/ours_*.json."""
    os.makedirs(directory, exist_ok=True)
    for name, points in counts.items():
        with open(os.path.join(directory, _counts_file(name)), "w") as f:
            json.dump(points, f, indent=1)
            f.write("\n")
    log(f"wrote {len(counts)} count files to {directory}")


def main(argv: list[str] | None = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--counts-dir", default=None,
                        help="also write each parity run's counters there, one JSON file a run")
    parser.add_argument("--rank-task", choices=("dp", "mp", "campaign", "tools"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_task:
        return rank_worker(args.rank_task, args.out)
    t_start = time.monotonic()
    card, smi = phase_device()
    sys.path.insert(0, HERE)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    phase_native(smi)
    ops_rate = fp32_ops_per_s()
    k1 = phase_k1(dev, ops_rate)
    k2 = phase_k2(dev, ops_rate)
    k3 = phase_k3(dev, ops_rate)
    k4 = phase_k4(dev, ops_rate)
    launches, k2_launches, k4_launches = phase_main_path(card, dev)
    from kmldpc_torch.decoder.bp_cuda import launch_k3
    from kmldpc_torch.ops.demap_cuda import launch_k4
    launch_k3.launches = launch_k4.launches = 0
    counts = phase_parity(dev, smi)
    k3_launches, k4_parity_launches = launch_k3.launches, launch_k4.launches
    fast_launches, counts["fast stack"] = phase_harness(dev)
    phase_layered(dev)
    phase_bf16(dev)
    phase_tools(dev, smi)
    k1_chain = phase_chain(dev, smi)
    phase_bench(smi)
    phase_profile(dev)
    phase_profile_dir(dev)
    k1_ranks, k1_campaign = phase_multi_rank(dev, smi)
    if args.counts_dir:
        write_counts(counts, args.counts_dir)
    qpsk = k1["times"]["PEG2304 2bits_QPSK.txt"]
    log(f"K1 launches: main path {launches}, fast stack (folded) {fast_launches}, main path "
        f"on 2 data ranks {k1_ranks} (per rank), chain rows {sum(k1_chain.values())}")
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
        # per rank, on the main path's sweep as 2 data ranks sharing the card
        "launches_per_rank_data_parallel": k1_ranks,
        # per rank, config by config, in phase 11 (f)'s 8-rank campaign
        "launches_per_rank_campaign": k1_campaign,
        # row by row, in phase 8c's chain group (blind rows; none on known-h)
        "launches_per_chain_row": {k: n for k, n in k1_chain.items() if n},
        "by_table": k1["times"],
    }, {
        "name": "K2 per-codeword flooding sum-product decode of a regular code",
        "route": "cuda",
        "source": "kmldpc_torch/csrc/bp_flood.cu",
        "replaces": None,  # no Pallas kernel: the JAX package decodes with XLA
        "launches": k2_launches,
        "ms": k2["PEG2304"]["ms"],
        "plain_ms": k2["PEG2304"]["plain_ms"],
        "bound_ms": k2["PEG2304"]["bound_ms"],
        "bound_by": k2["PEG2304"]["bound_by"],
        "library_ms": None,  # no single PyTorch call decodes an LDPC code
        "wrapper_ms": k2["PEG2304"]["wrapper_ms"],
        "eager_two_phase_ms": k2["PEG2304"]["eager_two_phase_ms"],
        "by_code": k2,
    }, {
        "name": "K3 per-codeword flooding sum-product decode of an irregular code",
        "route": "cuda",
        "source": "kmldpc_torch/csrc/bp_flood.cu",
        "replaces": None,  # no Pallas kernel: the JAX package decodes with XLA
        "launches": k3_launches,  # over the parity phase's sweeps
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,  # no single PyTorch call decodes an LDPC code
        "wrapper_ms": k3["wrapper_ms"],
        "eager_two_phase_ms": k3["eager_two_phase_ms"],
        "by_code": {"5G BG2": k3},
    }, {
        "name": "K4 soft demap of every symbol under its gain candidates",
        "route": "cuda",
        "source": "kmldpc_torch/csrc/demap.cu",
        "replaces": None,  # no Pallas kernel: the JAX package demaps with XLA
        "launches": k4_launches,
        "launches_parity": k4_parity_launches,  # over the parity phase's sweeps
        "ms": k4["PEG8064 64QAM"]["ms"],
        "plain_ms": k4["PEG8064 64QAM"]["plain_ms"],
        "bound_ms": k4["PEG8064 64QAM"]["bound_ms"],
        "bound_by": k4["PEG8064 64QAM"]["bound_by"],
        "library_ms": None,  # no single PyTorch call demaps a constellation
        "wrapper_ms": k4["PEG8064 64QAM"]["wrapper_ms"],
        "by_case": k4,
    }]}
    log(f"chip_smoke: {time.monotonic() - t_start:.3f} s")
    log(f"card: {smi}")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
