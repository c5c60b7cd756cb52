"""kmldpc_torch on the card: K1 against its plain version, its early exit
against its fixed loop, the slices (main path and parity sweeps) on CUDA
against the same slices on the CPU.

Marked ``cuda``; every test skips where torch.cuda.is_available() is False.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import pathlib

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
])
def test_sweep_slice_on_card_counts_like_cpu(cuda, sweep, snr_db):
    """A parity sweep's configuration at one of its points, 64 blocks: the
    back end on the card and on the CPU, on the same channel outputs, give
    the same block errors and winners; with min-sum (exact messages) also
    the same bit errors.  With sum-product the bit errors of a codeword
    that never converges may differ by rounding (ROADMAP.md Queue 3)."""
    cfg = load_config(str(SWEEPS / sweep))
    code = load_code(cfg.matrix_path())
    spec = ChainSpec.from_config(cfg, code, parse_constellation(cfg.modem_path()))
    b = 64
    var = torch.tensor(10 ** (-snr_db / 10), dtype=torch.float32)
    params_cpu = make_chain_params(code, "cpu")
    front = build_frontend_fn(spec, b, "cpu")(params_cpu, make_generator(5, "cpu"), var)
    cpu = build_backend_fn(spec, b, "cpu")(params_cpu, *front, var)
    before = kmeans_cuda.kmeans_estimate.launches
    gpu = build_backend_fn(spec, b, cuda)(
        make_chain_params(code, cuda), *(t.to(cuda) for t in front), var.to(cuda)
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
