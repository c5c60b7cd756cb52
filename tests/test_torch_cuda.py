"""kmldpc_torch on the card: K1 against its plain version, its early exit
against its fixed loop, the slices (main path and parity sweeps) on CUDA
against the same slices on the CPU.

Marked ``cuda``; every test skips where torch.cuda.is_available() is False.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pathlib
import types

import numpy as np
import pytest
import torch

from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.detect import kmeans_cuda
from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates
from kmldpc_torch.ops import ModemTables, make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, build_frontend_fn

TABLES = [  # (table, symbols per PEG2304 codeword)
    ("2bits_QPSK.txt", 1152), ("4bit_16QAM_Gray.txt", 576), ("6bits_64QAM_Gray.txt", 384),
]
# rows K1 keeps in shared memory (PEG8064 codewords) and a ragged short row
OTHER_ROWS = [(f, n) for f, n8064 in [("2bits_QPSK.txt", 4032), ("4bit_16QAM_Gray.txt", 2016),
                                      ("6bits_64QAM_Gray.txt", 1344)] for n in (n8064, 100)]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's tolerance
SWEEPS = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "parity" / "configs"

pytestmark = pytest.mark.cuda


def llr_float64(yr, yi, hr, hi, var, points, bit0_mask) -> np.ndarray:
    """Bayes demap in float64 NumPy, the reference's semantics: symbol
    likelihoods exp(-|y - h s|^2 / var) normalised and clipped to
    [1e-12, 1 - 1e-12], marginalised to bits, LLR log(p0) - log(p1)
    clipped to ±LLR_CLIP.  yr/yi [B, Nsym], hr/hi [B]; returns [B, Nsym*m]."""
    from kmldpc_torch import constants

    y = np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)
    h = np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)
    d2 = np.abs(y[:, :, None] - h[:, None, None] * np.asarray(points, np.complex128)) ** 2
    logits = -d2 / np.float64(var)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    p = np.clip(p / p.sum(axis=-1, keepdims=True), constants.SMALLEST_PROB,
                1 - constants.SMALLEST_PROB)
    mask0 = np.asarray(bit0_mask, np.float64)
    llr = np.log(p @ mask0) - np.log(p @ (1 - mask0))
    return np.clip(llr.reshape(y.shape[0], -1), -constants.LLR_CLIP, constants.LLR_CLIP)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _rows(const, b, nsym, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, const.num_points, size=(b, nsym))
    h = (rng.normal(size=(b, 1)) + 1j * rng.normal(size=(b, 1))) * np.sqrt(0.5)
    w = (rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))) * np.sqrt(10**-1.5 / 2)
    y = h * const.points[idx] + w
    return y.real.astype(np.float32), y.imag.astype(np.float32)


@pytest.mark.parametrize("anchor", ["max", "first"])
@pytest.mark.parametrize("b", [1024, 100, 12, 7])
@pytest.mark.parametrize("fname,nsym", TABLES)
def test_k1_matches_plain(assets, cuda, fname, nsym, b, anchor):
    """K1 equals its plain version, writes every row, is deterministic, and
    its early exit gives the fixed loop's bits."""
    _check_k1(assets, cuda, fname, nsym, b, anchor)


@pytest.mark.parametrize("fname,nsym", OTHER_ROWS)
def test_k1_long_and_ragged_rows(assets, cuda, fname, nsym):
    for anchor in ("max", "first"):
        _check_k1(assets, cuda, fname, nsym, 64, anchor)


def _check_k1(assets, cuda, fname, nsym, b, anchor):
    const = parse_constellation(str(assets / fname))
    tables = ModemTables.from_constellation(const, cuda)
    yr, yi = (torch.from_numpy(a).to(cuda) for a in _rows(const, b, nsym, b))
    before = kmeans_cuda.kmeans_estimate.launches
    k1 = kmeans_cuda.kmeans_estimate(yr, yi, tables, 20, anchor)
    k1b = kmeans_cuda.kmeans_estimate(yr, yi, tables, 20, anchor)
    early = kmeans_cuda.kmeans_estimate(yr, yi, tables, 20, anchor, early_exit=True)
    plain = expand_candidates(*blind_estimate(yr, yi, tables, 20, anchor))
    torch.cuda.synchronize()
    assert kmeans_cuda.kmeans_estimate.launches == before + 3
    for a, a2, e, p in zip(k1, k1b, early, plain):
        assert a.shape == (b, 4) and bool(torch.isfinite(a).all())
        assert torch.equal(a, a2)
        assert torch.equal(a, e)
        torch.testing.assert_close(a, p, rtol=RTOL, atol=ATOL)


def test_k1_rounds_and_no_device_to_host_copy(assets, cuda):
    """A launch through the built estimator never synchronises (so it copies
    nothing to the host); the fixed loop runs every iteration, the early
    exit at most as many."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const, cuda)
    yr, yi = (torch.from_numpy(a).to(cuda) for a in _rows(const, 256, 1152, 3))
    estimate = kmeans_cuda.make_blind_estimator_cuda(tables)
    estimate(yr, yi)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h4 = estimate(yr, yi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pts_r = tables.points_re.cpu().numpy()
    pts_i = tables.points_im.cpu().numpy()
    k_init = int(np.argmax(pts_r * pts_r + pts_i * pts_i))
    rounds = {}
    for early in (False, True):
        rounds[early] = torch.zeros(256, dtype=torch.int32, device=cuda)
        got = kmeans_cuda.launch_k1(yr, yi, pts_r, pts_i, 20, k_init, False, early,
                                    rounds[early])
        for a, b in zip(got, h4):
            assert torch.equal(a, b)
    assert bool((rounds[False] == 20).all())
    assert bool((rounds[True] >= 1).all()) and bool((rounds[True] <= 20).all())


@pytest.mark.parametrize("table,known_h", [("2bits_QPSK.txt", False),
                                           ("4bit_16QAM_Gray.txt", False),
                                           ("2bits_QPSK.txt", True)])
def test_slice_on_card_counts_like_cpu(assets, cuda, table, known_h):
    """The same channel outputs through the back end on the card (K1) and
    on the CPU (plain version) give the same counters at 15 dB."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / table))
    spec = ChainSpec(code=code, constellation=const, known_h=known_h, fading=True,
                     metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    b = 64
    var = torch.tensor(10**-1.5, dtype=torch.float32)
    params_cpu = make_chain_params(code, "cpu")
    front = build_frontend_fn(spec, b, "cpu")(params_cpu, make_generator(5, "cpu"), var)
    cpu = build_backend_fn(spec, b, "cpu")(params_cpu, *front, var)
    before = kmeans_cuda.kmeans_estimate.launches
    gpu = build_backend_fn(spec, b, cuda)(
        make_chain_params(code, cuda), *(t.to(cuda) for t in front), var.to(cuda)
    )
    assert kmeans_cuda.kmeans_estimate.launches == before + (0 if known_h else 1)
    assert gpu.err_bit.device.type == "cuda"
    assert int(gpu.err_bit) == int(cpu.err_bit)
    assert int(gpu.err_blk) == int(cpu.err_blk)
    assert torch.equal(gpu.metrics.cpu(), cpu.metrics)


@pytest.mark.parametrize("sweep,snr_db", [
    ("sweep3_known_5g16qam.toml", 15.0), ("sweep4_blind_5g_soft.toml", 14.0),
    ("sweep8_blind_8064_fminsum.toml", 17.5), ("sweep9_known_qpsk_fminsum.toml", 5.0),
    ("sweep10_blind_qpsk_fminsum_prune.toml", 10.0),
    ("sweep3b_known_5g16qam_minsum.toml", 12.0), ("sweep6_known_qpsk_bf16.toml", 5.0),
    ("sweep7_blind_5g_soft_minsum.toml", 14.0),
])
def test_sweep_slice_on_card_counts_like_cpu(cuda, sweep, snr_db):
    """A parity sweep's configuration at one of its points, 64 blocks: the
    back end on the card and on the CPU, on the same channel outputs, give
    the same block errors and winners; with flooding min-sum also the same
    bit errors.  The bit errors of a codeword that never converges follow
    its LLRs to the last rounding: with sum-product (also with bfloat16
    messages) they may differ (ROADMAP.md Queue 3), and so they do with
    layered min-sum on the 5G 16QAM sweeps, whose demapped LLRs round
    differently on the card (3471 against 3605 bits at sweep 3b's 12 dB
    point).  The layered decoder itself is bitwise the CPU's on the same
    LLRs (test_layered_decoder_on_card_equals_cpu)."""
    cfg = load_config(str(SWEEPS / sweep))
    code = load_code(cfg.matrix_path())
    spec = ChainSpec.from_config(cfg, code, parse_constellation(cfg.modem_path()))
    b = 64
    var = torch.tensor(10 ** (-snr_db / 10), dtype=torch.float32)
    params_cpu = make_chain_params(code, "cpu", spec.schedule)
    front = build_frontend_fn(spec, b, "cpu")(params_cpu, make_generator(5, "cpu"), var)
    cpu = build_backend_fn(spec, b, "cpu")(params_cpu, *front, var)
    before = kmeans_cuda.kmeans_estimate.launches
    gpu = build_backend_fn(spec, b, cuda)(
        make_chain_params(code, cuda, spec.schedule), *(t.to(cuda) for t in front), var.to(cuda)
    )
    assert kmeans_cuda.kmeans_estimate.launches == before + (0 if spec.known_h else 1)
    assert gpu.err_bit.device.type == "cuda"
    assert int(gpu.err_blk) == int(cpu.err_blk)
    if spec.schedule == "flooding-minsum":
        assert int(gpu.err_bit) == int(cpu.err_bit)
    if spec.metric_type:
        # a losing candidate's soft syndrome can underflow to 0 on one
        # device and not on the other (|metric| inf against a large finite
        # value); the winners and their metrics agree
        g, c = gpu.metrics.cpu(), cpu.metrics
        assert torch.equal(g.argmin(dim=1), c.argmin(dim=1))
        torch.testing.assert_close(g.amin(dim=1), c.amin(dim=1), rtol=1e-4, atol=0)
    else:
        assert torch.equal(gpu.metrics.cpu(), cpu.metrics)


@pytest.mark.parametrize("code_file,use_qc", [("5GLDPCBG2a3_R12_K960.txt", True),
                                              ("5GLDPCBG2a3_R12_K960.txt", False),
                                              ("PEG2304regular0.5.txt", True)],
                         ids=["5g-qc", "5g-generic", "peg-whole-matrix"])
def test_layered_decoder_on_card_equals_cpu(assets, cuda, code_file, use_qc):
    """Layered min-sum on the same LLRs (B = 256, codewords that converge
    and codewords that never do): the card's hard outputs, iterations and
    convergence are bitwise the CPU's, and two runs on the card are bitwise
    equal in every output (no atomics: the generic path adds each column's
    updates in a fixed order)."""
    from kmldpc_torch.decoder import layered_minsum_decode, minsum_tables

    code = load_code(str(assets / code_file))
    rng = np.random.default_rng(7)
    uu = rng.integers(0, 2, size=(256, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])[:, code.punct:]
    llr = torch.from_numpy((4.0 * (1 - 2 * cc.astype(np.float64))
                            + rng.normal(scale=3.5, size=cc.shape)).astype(np.float32))
    cpu = layered_minsum_decode(minsum_tables(code, use_qc=use_qc), llr, 50)
    mt = minsum_tables(code, use_qc=use_qc, device=cuda)
    card = [layered_minsum_decode(mt, llr.to(cuda), 50) for _ in range(2)]
    assert 0 < int(cpu.converged.sum()) < 256
    for f in ("uu_hat", "cc_hat", "converged", "iters"):
        assert torch.equal(getattr(card[0], f).cpu(), getattr(cpu, f)), f
    for a, b in zip(*card):
        assert torch.equal(a, b)


def _cfg(assets, **over):
    import dataclasses

    cfg = load_config(str(assets / "config.toml"))
    for section, kv in over.items():
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kv)})
    return cfg


def _counts(results):
    return [(r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit, r.err_bit_sq) for r in results]


@pytest.mark.parametrize("known_h", [True, False], ids=["known-h", "blind"])
def test_folded_sweep_on_card_equals_sequential(assets, cuda, known_h):
    """On the card, a folded sweep (fold 3, K1 on the blind chain) gives
    bitwise the sequential per-point counters."""
    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    common = dict(range=dict(minimum_snr=6.0, maximum_snr=14.0, step_snr=4.0,
                             maximum_block_number=256, maximum_error_number=10**9),
                  decoder=dict(true_h_arg=known_h))
    runs = []
    for fold in (0, 3):
        before = kmeans_cuda.kmeans_estimate.launches
        sim = Simulator(_cfg(assets, tpu=dict(batch=64, chunks_per_launch=2, snr_fold=fold),
                             **common), SimLogger(log_dir=None, stdout=False), device=cuda)
        runs.append(sim.simulate())
        assert (kmeans_cuda.kmeans_estimate.launches > before) != known_h
    assert _counts(runs[0]) == _counts(runs[1])


def test_checkpoint_resume_on_card(assets, cuda, tmp_path):
    """Killed mid-point on the card, a sweep resumes bitwise; a checkpoint
    written on the CPU starts a CUDA run fresh (another generator stream)."""
    from kmldpc_torch.sim import Simulator, make_chunk_runner
    from kmldpc_torch.utils import SimLogger

    def cfg(ck):
        return _cfg(assets, range=dict(maximum_block_number=320, maximum_error_number=10**9,
                                       minimum_snr=4.0, maximum_snr=4.0),
                    decoder=dict(true_h_arg=True),
                    tpu=dict(batch=64, chunks_per_launch=1, checkpoint_path=str(ck)))

    class Killed(RuntimeError):
        pass

    calls = {"n": 0}

    def factory(spec, batch):
        real = make_chunk_runner(spec, batch, 1, cuda, 0)

        def run(*args):
            if calls["n"] == 3:
                raise Killed()
            calls["n"] += 1
            return real(*args)

        run.blocks_per_launch = batch
        return run

    quiet = SimLogger(log_dir=None, stdout=False)
    with pytest.raises(Killed):
        Simulator(cfg(tmp_path / "ck.json"), quiet, device=cuda, runner_factory=factory).simulate()
    resumed = Simulator(cfg(tmp_path / "ck.json"), quiet, device=cuda).simulate()
    control = Simulator(cfg(tmp_path / "ck2.json"), quiet, device=cuda).simulate()
    assert _counts(resumed) == _counts(control)
    Simulator(cfg(tmp_path / "cpu.json"), quiet, device="cpu").simulate()
    lines = []
    log = types.SimpleNamespace(info=lambda msg, to_stdout=True: lines.append(msg))
    fresh = Simulator(cfg(tmp_path / "cpu.json"), log, device=cuda).simulate()
    assert "Checkpoint fingerprint mismatch; starting fresh." in lines
    assert _counts(fresh) == _counts(control)


def test_histogram_and_kmeans_dump_on_card(assets, cuda, tmp_path, monkeypatch):
    """Histogram files folded == sequential on the card, and the k-means dump
    over K1: clusters = constellation x hHats[0], idx the nearest cluster."""
    import os

    from scipy.io import loadmat

    from kmldpc_torch.sim import Simulator
    from kmldpc_torch.utils import SimLogger

    quiet = SimLogger(log_dir=None, stdout=False)
    common = dict(range=dict(minimum_snr=16.0, maximum_snr=24.0, step_snr=4.0,
                             maximum_block_number=128, maximum_error_number=10**9),
                  decoder=dict(true_h_arg=False), histogram=dict(enable=True))
    files = {}
    for fold in (0, 2):
        monkeypatch.chdir(tmp_path)
        os.makedirs(str(fold))
        monkeypatch.chdir(tmp_path / str(fold))
        Simulator(_cfg(assets, tpu=dict(batch=64, snr_fold=fold), **common), quiet,
                  device=cuda).simulate()
        files[fold] = {f: open(f, "rb").read() for f in sorted(os.listdir("."))}
    assert len(files[0]) == 3 and files[0] == files[2]
    d = tmp_path / "km"
    sim = Simulator(_cfg(assets, range=dict(maximum_block_number=64),
                         decoder=dict(true_h_arg=False),
                         tpu=dict(batch=64, kmeans_dump_dir=str(d), kmeans_dump_blocks=4)),
                    quiet, device=cuda)
    before = kmeans_cuda.kmeans_estimate.launches
    sim.run_snr_point(18.0)
    assert kmeans_cuda.kmeans_estimate.launches == before + 1
    assert len(os.listdir(d)) == 4
    for name in os.listdir(d):
        m = loadmat(str(d / name))
        y, cl, const, h_hats = (np.asarray(m[k]).ravel()
                                for k in ("data", "cluster", "constellations", "hHats"))
        np.testing.assert_allclose(cl, const * h_hats[0], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(m["idx"]).ravel(),
                                      (np.abs(y[:, None] - cl[None, :]) ** 2).argmin(axis=1))


@pytest.mark.parametrize("sweep,snr_db", [("sweep3b_known_5g16qam_minsum.toml", 12.0),
                                          ("sweep7_blind_5g_soft_minsum.toml", 14.0)],
                         ids=["sweep3b", "sweep7"])
def test_card_llrs_no_further_from_float64_than_cpu(cuda, sweep, snr_db):
    """The demapped 16QAM LLRs on the card against a float64 Bayes demap:
    no further than the CPU's, by tests/test_torch_rounding.py's margin
    (1.10), on the sweep 3b (true h) and sweep 7 (the selection's winner)
    shapes, B = 256, from the port's front end."""
    import dataclasses

    from kmldpc_torch.ops.modem import make_soft_demapper

    cfg = load_config(str(SWEEPS / sweep))
    code = load_code(cfg.matrix_path())
    spec = ChainSpec.from_config(cfg, code, parse_constellation(cfg.modem_path()))
    b = 256
    var = torch.tensor(10 ** (-snr_db / 10), dtype=torch.float32)
    params = make_chain_params(code, cuda, spec.schedule)
    front = build_frontend_fn(spec, b, cuda)(params, make_generator(9, cuda), var.to(cuda))
    _, yr, yi, hr, hi = front
    if not spec.known_h:
        sel = build_backend_fn(dataclasses.replace(spec, histogram=True, debug_blocks=1), b, cuda)(
            params, *front, var.to(cuda))
        win = sel.metrics.argmin(dim=1)
        rows = torch.arange(b, device=cuda)
        hr, hi = sel.debug[2][rows, win], sel.debug[3][rows, win]
    const = spec.constellation
    card = make_soft_demapper(ModemTables.from_constellation(const, cuda))(
        yr, yi, hr, hi, var.to(cuda))[1].cpu().numpy()
    host = [t.cpu() for t in (yr, yi, hr, hi)]
    cpu = make_soft_demapper(ModemTables.from_constellation(const))(*host, var)[1].numpy()
    ref = llr_float64(*(t.numpy() for t in host), var.numpy(), const.points, const.bit0_mask())
    e_card, e_cpu = np.abs(card - ref), np.abs(cpu - ref)
    assert e_card.max() <= 1.10 * e_cpu.max() and e_card.mean() <= 1.10 * e_cpu.mean()


def test_edge_major_decoder_and_prior_demap_on_card(assets, cuda):
    """The edge-major reference decoder on the card against the CPU (B = 256
    at noise 2.6, where 140 codewords converge: convergence, iterations and
    the converged codewords' bits equal), and the uniform-prior demap equal
    to the soft demap."""
    from kmldpc_torch.decoder import DecoderTables, flooding_decode
    from kmldpc_torch.ops.modem import make_prior_demapper, make_soft_demapper

    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    rng = np.random.default_rng(7)
    uu = rng.integers(0, 2, size=(256, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])
    llr = torch.from_numpy((3.0 * (1 - 2 * cc.astype(np.float64))
                            + rng.normal(scale=2.6, size=cc.shape)).astype(np.float32))
    cpu = flooding_decode(DecoderTables.from_code(code), llr, 50)
    card = flooding_decode(DecoderTables.from_code(code, cuda), llr.to(cuda), 50)
    conv = cpu.converged
    assert 0 < int(conv.sum()) < 256
    assert torch.equal(card.converged.cpu(), conv) and torch.equal(card.iters.cpu(), cpu.iters)
    assert torch.equal(card.uu_hat.cpu()[conv], cpu.uu_hat[conv])
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    tables = ModemTables.from_constellation(const, cuda)
    yr, yi = (torch.from_numpy(a).to(cuda) for a in _rows(const, 64, 576, 8))
    hr, hi = (torch.randn(64, generator=make_generator(8, cuda), device=cuda) for _ in range(2))
    p0_u, llr_u = make_soft_demapper(tables)(yr, yi, hr, hi, 0.1)
    p0_p, llr_p = make_prior_demapper(tables)(yr, yi, hr, hi, 0.1, torch.full_like(p0_u, 0.5))
    torch.testing.assert_close(p0_p, p0_u, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(llr_p, llr_u, rtol=1e-4, atol=1e-4)


def test_microbench_kmeans_group_cuda_rows_on_card(cuda):
    """The microbench k-means group on the card: a ``cuda`` row (K1) beside
    each ``plain`` row, every time finite and positive, K1 launched for
    it, and K1's ĥ on one call's inputs within the kernel tolerance of the
    plain version's."""
    from kmldpc_torch.tools import microbench

    results = {}
    before = kmeans_cuda.kmeans_estimate.launches
    microbench.bench_kmeans(results, batch=1024, device=cuda, n1=2, n2=6)
    assert kmeans_cuda.kmeans_estimate.launches > before
    assert list(results) == [f"kmeans/{c}/{impl}" for c in ("QPSK", "16QAM", "64QAM")
                             for impl in ("plain", "cuda")]
    assert all(np.isfinite(r["us_per_call"]) and r["us_per_call"] > 0 for r in results.values())
    for name, fname, div in microbench.CONSTELLATIONS:
        tables = ModemTables.from_constellation(
            parse_constellation(str(pathlib.Path(microbench.ASSETS) / fname)), cuda)
        impls = microbench.kmeans_impls(tables, cuda)
        y = microbench.seeded_normal(3 << 32 | 7, (2, 1024, 1152 // div), cuda)
        ref, got = impls["plain"](y[0], y[1]), impls["cuda"](y[0], y[1])
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


# --- kernel K2: the per-codeword flooding sum-product decode -------------------

K2_LINKS = [(f, snr) for f in ("PEG2304regular0.5.txt", "PEG8064regular0.5.txt")
            for snr in (5.0, 10.0, 20.0)]
K2_BATCH = 2048


def _k2_link(assets, cuda, code_file, snr_db, b, seed):
    """A known-h QPSK link's channel LLRs on the card: (tables, llr [B, n])."""
    from kmldpc_torch.ops.modem import make_soft_demapper

    code = load_code(str(assets / code_file))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=True, fading=True,
                     metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10.0 ** (-0.1 * snr_db), dtype=torch.float32, device=cuda)
    params = make_chain_params(code, cuda)
    _, yr, yi, hr, hi = build_frontend_fn(spec, b, cuda)(params, make_generator(seed, cuda), var)
    _, llr = make_soft_demapper(ModemTables.from_constellation(const, cuda))(yr, yi, hr, hi, var)
    return params.dec, llr


@pytest.mark.parametrize("code_file,snr_db", K2_LINKS)
def test_k2_matches_plain_core_on_links(assets, cuda, code_file, snr_db):
    """K2 against its plain version (the slot-major core) on the card, by
    the limits of linkbench/traffic/peg2304-qpsk.blind.toml's [check]: rows
    whose iterations or convergence differ at most 0.002, rows whose
    decisions differ at most 0.005, and the 90th percentile of each row's
    largest soft-syndrome difference (1 where the rows decode apart) at
    most 0.001."""
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em
    from kmldpc_torch.decoder.bp_em import _decode_cols_padded

    t, llr = _k2_link(assets, cuda, code_file, snr_db, K2_BATCH, 19)
    before = bp_cuda.launch_k2.launches
    k2 = flooding_decode_em(t, llr, 50)
    assert bp_cuda.launch_k2.launches == before + 1
    plain = _decode_cols_padded(t, llr.T.contiguous(), 50)
    iters_apart = (k2.iters != plain.iters) | (k2.converged != plain.converged)
    decided_apart = (k2.cc_hat != plain.cc_hat.T).any(dim=1)
    ss_err = (k2.soft_syndrome - plain.soft_syndrome.T).abs().amax(dim=1)
    ss_err = torch.where(decided_apart | iters_apart, 1.0, ss_err)
    assert float(iters_apart.float().mean()) <= 0.002
    assert float(decided_apart.float().mean()) <= 0.005
    assert float(torch.quantile(ss_err, 0.9)) <= 0.001
    assert torch.equal(k2.uu_hat, k2.cc_hat[:, t.info_start: t.info_start + t.code_dim])
    assert int(k2.iters.min()) >= 1 and int(k2.iters.max()) <= 50


@pytest.mark.parametrize("code_file", ["PEG2304regular0.5.txt", "PEG8064regular0.5.txt"])
def test_k2_engineered_rows(assets, cuda, code_file):
    """All-strong LLRs (the all-zero word) converge on the first iteration
    with a soft syndrome of ones; rows of strong random signs never
    converge and run the whole budget; no iteration leaves the state as it
    started."""
    from kmldpc_torch.decoder import DecoderTables, flooding_decode_em

    t = DecoderTables.from_code(load_code(str(assets / code_file)), cuda)
    n = t.num_col - t.punct
    strong = flooding_decode_em(t, torch.full((64, n), 20.0, device=cuda), 50)
    assert bool((strong.iters == 1).all()) and bool(strong.converged.all())
    assert bool((strong.soft_syndrome == 1.0).all()) and not bool(strong.cc_hat.any())
    g = torch.Generator(device=cuda).manual_seed(5)
    signs = 1 - 2 * torch.randint(0, 2, (64, n), generator=g, device=cuda)
    noise = flooding_decode_em(t, 20.0 * signs.float(), 50)
    assert bool((noise.iters == 50).all()) and not bool(noise.converged.any())
    none = flooding_decode_em(t, 20.0 * signs.float(), 0)
    assert not bool(none.cc_hat.any()) and not bool(none.converged.any())
    assert bool((none.iters == 0).all()) and bool((none.soft_syndrome == 1.0).all())


def test_k2_makes_no_device_to_host_copy(assets, cuda):
    """A K2 decode never synchronises, so it copies nothing to the host; it
    counts its rows under ``fused_rows`` and its syncs (none) under
    ``syncs``, and the chain hands it the whole batch in one launch."""
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em
    from kmldpc_torch.utils import trace

    t, llr = _k2_link(assets, cuda, "PEG2304regular0.5.txt", 10.0, 1024, 3)
    flooding_decode_em(t, llr, 50)  # builds and loads the library
    torch.cuda.synchronize()
    trace.reset()
    before = bp_cuda.launch_k2.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.label("decode"):
            flooding_decode_em(t, llr, 50)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bp_cuda.launch_k2.launches == before + 1
    assert trace.snapshot() == {"decode.fused_rows": 1024, "decode.syncs": 0}
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=False, fading=True,
                     metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10**-1.0, dtype=torch.float32, device=cuda)
    params = make_chain_params(code, cuda)
    front = build_frontend_fn(spec, 256, cuda)(params, make_generator(9, cuda), var)
    before = bp_cuda.launch_k2.launches
    res = build_backend_fn(spec, 256, cuda)(params, *front, var)
    assert bp_cuda.launch_k2.launches == before + 1 and res.per_codeword is True
    trace.reset()


def test_k2_kernel_counts_under_the_chain_label(assets, cuda):
    """In a profiler's trace, as the benchmark reduces it, K2's kernel is
    device time under the chain label its launch sits in."""
    from torch.autograd.profiler import record_function

    from kmldpc_torch.decoder import flooding_decode_em
    from kmldpc_torch.utils import trace
    from linkbench.trace import SWEEP_SPAN, _profile, reduce

    t, llr = _k2_link(assets, cuda, "PEG2304regular0.5.txt", 10.0, 1024, 4)
    flooding_decode_em(t, llr, 50)
    torch.cuda.synchronize()
    with _profile() as prof:
        with record_function(SWEEP_SPAN):
            with trace.label("decode"):
                flooding_decode_em(t, llr, 50)
            torch.cuda.synchronize()
    s = reduce(prof.profiler.kineto_results.events())
    k2 = s.kernel_s("bp_flood_kernel")
    assert k2 > 0 and s.by_label.get("decode", 0.0) >= k2
    trace.reset()


def test_k1_kernel_counts_under_the_chain_label(assets, cuda):
    """In a traced blind launch of the PEG8064 64QAM link, as the benchmark
    reduces it, K1's kernel is device time under the chain's ``kmeans``
    label, tied to it by the span ``k1`` around its launch; the chain counts
    the launch's rows under ``kmeans.rows``."""
    from torch.autograd.profiler import record_function

    from kmldpc_torch.utils import trace
    from linkbench.trace import SWEEP_SPAN, _profile, reduce

    code = load_code(str(assets / "PEG8064regular0.5.txt"))
    const = parse_constellation(str(assets / "6bits_64QAM_Gray.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=False, fading=True,
                     metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10**-2.0, dtype=torch.float32, device=cuda)
    params = make_chain_params(code, cuda)
    front = build_frontend_fn(spec, 128, cuda)(params, make_generator(7, cuda), var)
    backend = build_backend_fn(spec, 128, cuda)
    backend(params, *front, var)  # builds and loads the library
    torch.cuda.synchronize()
    trace.reset()
    with _profile() as prof:
        with record_function(SWEEP_SPAN):
            backend(params, *front, var)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    assert any(e.name() == "k1" for e in events)
    s = reduce(events)
    k1 = s.kernel_s("kmeans_kernel")
    assert k1 > 0 and s.by_label.get("kmeans", 0.0) >= k1
    assert trace.snapshot()["kmeans.rows"] == 128
    trace.reset()


# --- kernel K3: the per-codeword flooding sum-product decode of an irregular code

G5 = "5GLDPCBG2a3_R12_K960.txt"
K3_LINKS = (12.0, 18.0, 24.0)  # known-h 16QAM, the grid of nr-bg2-16qam.known
K3_BATCH = 2048
# linkbench/traffic/nr-bg2-16qam.known.toml's [check]: rows whose iterations
# or convergence differ, rows whose decisions differ, soft p90
K3_LIMITS = dict(iters=0.002, decided=1e-4, soft=0.001)


def _k3_link(assets, cuda, snr_db, b, seed, known_h=True):
    """The 5G 16QAM link on the card: (tables, LLRs).  With known h the
    final decode's [B, n]; blind, the [4B, n] candidate-folded rows the soft
    metric decodes, from the chain's own K1 estimate and selector."""
    from kmldpc_torch.decoder import flooding_decode_em
    from kmldpc_torch.detect import make_ambiguity_selector
    from kmldpc_torch.ops.modem import make_soft_demapper

    code = load_code(str(assets / G5))
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=known_h, fading=True,
                     metric_type=True, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10.0 ** (-0.1 * snr_db), dtype=torch.float32, device=cuda)
    params = make_chain_params(code, cuda)
    _, yr, yi, hr, hi = build_frontend_fn(spec, b, cuda)(params, make_generator(seed, cuda), var)
    tables = ModemTables.from_constellation(const, cuda)
    if known_h:
        return params.dec, make_soft_demapper(tables)(yr, yi, hr, hi, var)[1]
    h4_r, h4_i = kmeans_cuda.make_blind_estimator_cuda(tables, 20, "max")(yr, yi)[:2]
    rows = []

    def keep(t, llr, it):
        rows.append(llr)
        return flooding_decode_em(t, llr, it)

    make_ambiguity_selector(code, tables, True, 5, decode=keep)(params.dec, yr, yi, h4_r, h4_i,
                                                                  var)
    return params.dec, rows[0]


def _plain_k3(t, llr, iter_count):
    """K3's plain version on the card: the degree-class core, batch-major."""
    from kmldpc_torch.decoder.bp_em import _batch_major, _decode_cols_classes, _insert_punct

    return _batch_major(_decode_cols_classes(t, _insert_punct(t, llr.T.contiguous()), iter_count))


def _k3_against_plain(t, llr, iter_count) -> bool:
    """One launch of K3 against its plain version within K3_LIMITS, a second
    launch bitwise the first; returns whether K3 is bitwise the plain core."""
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em

    before = bp_cuda.launch_k3.launches
    k3 = flooding_decode_em(t, llr, iter_count)
    again = flooding_decode_em(t, llr, iter_count)
    assert bp_cuda.launch_k3.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(k3, again))
    plain = _plain_k3(t, llr, iter_count)
    iters_apart = (k3.iters != plain.iters) | (k3.converged != plain.converged)
    decided_apart = (k3.cc_hat != plain.cc_hat).any(dim=1)
    ss_err = (k3.soft_syndrome - plain.soft_syndrome).abs().amax(dim=1)
    ss_err = torch.where(decided_apart | iters_apart, 1.0, ss_err)
    assert float(iters_apart.float().mean()) <= K3_LIMITS["iters"]
    assert float(decided_apart.float().mean()) <= K3_LIMITS["decided"]
    assert float(torch.quantile(ss_err, 0.9)) <= K3_LIMITS["soft"]
    assert torch.equal(k3.uu_hat, k3.cc_hat[:, t.info_start: t.info_start + t.code_dim])
    assert int(k3.iters.max()) <= iter_count
    return all(torch.equal(a, b) for a, b in zip(k3, plain))


@pytest.mark.parametrize("snr_db", K3_LINKS)
def test_k3_matches_degree_class_core_on_links(assets, cuda, snr_db):
    """K3 against its plain version (the degree-class core) on the card, on
    the known-h 16QAM 5G link, by the limits of nr-bg2-16qam.known."""
    t, llr = _k3_link(assets, cuda, snr_db, K3_BATCH, 19)
    assert _k3_against_plain(t, llr, 50)


def test_k3_matches_degree_class_core_on_metric_rows(assets, cuda):
    """K3 against the degree-class core on the soft metric's 4B
    candidate-folded rows at metric_iter = 5, from a blind 16QAM front end
    at the first point of nr-bg2-16qam.blind."""
    t, llr = _k3_link(assets, cuda, 14.0, 1024, 23, known_h=False)
    assert llr.shape == (4096, t.num_col - t.punct)
    assert _k3_against_plain(t, llr, 5)


def test_k3_engineered_rows(assets, cuda):
    """Rows whose every LLR is 0; the all-zero word with strong LLRs, whose
    punctured columns the checks alone decide; LLRs at the clip; rows of
    strong random signs, which never converge and run the whole budget;
    and a budget of 0 iterations: K3 is its plain version on each."""
    from kmldpc_torch import constants
    from kmldpc_torch.decoder import DecoderTables, flooding_decode_em

    t = DecoderTables.from_code(load_code(str(assets / G5)), cuda)
    n = t.num_col - t.punct
    zero = torch.zeros((64, n), device=cuda)
    assert _k3_against_plain(t, zero, 50)
    strong = torch.full((64, n), 20.0, device=cuda)
    assert _k3_against_plain(t, strong, 50)
    res = flooding_decode_em(t, strong, 50)
    assert bool(res.converged.all()) and not bool(res.cc_hat.any())
    g = torch.Generator(device=cuda).manual_seed(5)
    signs = (1 - 2 * torch.randint(0, 2, (64, n), generator=g, device=cuda)).float()
    assert _k3_against_plain(t, constants.LLR_CLIP * signs.abs(), 50)
    assert _k3_against_plain(t, 20.0 * signs, 50)
    noise = flooding_decode_em(t, 20.0 * signs, 50)
    assert bool((noise.iters == 50).all()) and not bool(noise.converged.any())
    none = flooding_decode_em(t, 20.0 * signs, 0)
    assert not bool(none.cc_hat.any()) and not bool(none.converged.any())
    assert bool((none.iters == 0).all()) and bool((none.soft_syndrome == 1.0).all())
    assert _k3_against_plain(t, 20.0 * signs, 0)


def test_k3_makes_no_device_to_host_copy(assets, cuda):
    """A K3 decode never synchronises, so it copies nothing to the host; it
    counts its rows under ``fused_rows`` and its syncs (none) under
    ``syncs``; the 5G chain hands it the whole batch of the final decode,
    and a blind one also its soft metric's 4B rows, one launch each."""
    from kmldpc_torch.decoder import bp_cuda, flooding_decode_em
    from kmldpc_torch.utils import trace

    t, llr = _k3_link(assets, cuda, 18.0, 1024, 3)
    flooding_decode_em(t, llr, 50)  # builds and loads the library
    torch.cuda.synchronize()
    trace.reset()
    before = bp_cuda.launch_k3.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with trace.label("decode"):
            flooding_decode_em(t, llr, 50)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bp_cuda.launch_k3.launches == before + 1
    assert trace.snapshot() == {"decode.fused_rows": 1024, "decode.syncs": 0}
    code = load_code(str(assets / G5))
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    params = make_chain_params(code, cuda)
    var = torch.tensor(10**-1.5, dtype=torch.float32, device=cuda)
    for known_h, launches in ((True, 1), (False, 2)):
        spec = ChainSpec(code=code, constellation=const, known_h=known_h, fading=True,
                         metric_type=True, metric_iter=5, max_iter=50, encoder_active=True)
        front = build_frontend_fn(spec, 256, cuda)(params, make_generator(9, cuda), var)
        trace.reset()
        before = bp_cuda.launch_k3.launches
        res = build_backend_fn(spec, 256, cuda)(params, *front, var)
        assert bp_cuda.launch_k3.launches == before + launches and res.per_codeword is True
        counts = trace.snapshot()
        assert counts["decode.fused_rows"] == 256 and counts["decode.syncs"] == 0
        assert counts.get("metric.fused_rows", 0) == (0 if known_h else 1024)
    trace.reset()


def test_k3_kernel_counts_under_the_chain_label(assets, cuda):
    """In a traced blind 5G launch, as the benchmark reduces it, K3's kernel
    is device time under the chain label its launch sits in, ``metric`` for
    the soft metric's decode and ``decode`` for the final one, tied to it by
    the span ``k3``."""
    from torch.autograd.profiler import record_function

    from kmldpc_torch.utils import trace
    from linkbench.trace import SWEEP_SPAN, _profile, reduce

    code = load_code(str(assets / G5))
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=False, fading=True,
                     metric_type=True, metric_iter=5, max_iter=50, encoder_active=True)
    var = torch.tensor(10**-1.4, dtype=torch.float32, device=cuda)
    params = make_chain_params(code, cuda)
    front = build_frontend_fn(spec, 512, cuda)(params, make_generator(7, cuda), var)
    backend = build_backend_fn(spec, 512, cuda)
    backend(params, *front, var)  # builds and loads the library
    torch.cuda.synchronize()
    with _profile() as prof:
        with record_function(SWEEP_SPAN):
            backend(params, *front, var)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    assert any(e.name() == "k3" for e in events)
    s = reduce(events)
    k3 = s.kernel_s("bp_classes_kernel")
    assert k3 > 0 and "bp_flood_kernel" not in " ".join(s.by_kernel)
    assert s.by_label.get("decode", 0.0) > 0 and s.by_label.get("metric", 0.0) > 0
    assert s.by_label["decode"] + s.by_label["metric"] >= k3
    trace.reset()
