"""kmldpc_torch on the card: K1 against its plain version, the slice on
CUDA against the slice on the CPU.

Marked ``cuda``; every test skips where torch.cuda.is_available() is False.
This file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from kmldpc_tpu.code import load_code
from kmldpc_tpu.io import parse_constellation
from kmldpc_torch.detect import kmeans_cuda
from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates
from kmldpc_torch.ops import ModemTables, make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, build_frontend_fn

TABLES = [  # (table, symbols per PEG2304 codeword)
    ("2bits_QPSK.txt", 1152), ("4bit_16QAM_Gray.txt", 576), ("6bits_64QAM_Gray.txt", 384),
]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's tolerance

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
    """K1 equals its plain version, writes every row, and is deterministic."""
    const = parse_constellation(str(assets / fname))
    tables = ModemTables.from_constellation(const, cuda)
    yr, yi = (torch.from_numpy(a).to(cuda) for a in _rows(const, b, nsym, b))
    before = kmeans_cuda.kmeans_estimate.launches
    k1 = kmeans_cuda.kmeans_estimate(yr, yi, tables, 20, anchor)
    k1b = kmeans_cuda.kmeans_estimate(yr, yi, tables, 20, anchor)
    plain = expand_candidates(*blind_estimate(yr, yi, tables, 20, anchor))
    torch.cuda.synchronize()
    assert kmeans_cuda.kmeans_estimate.launches == before + 2
    for a, a2, p in zip(k1, k1b, plain):
        assert a.shape == (b, 4) and bool(torch.isfinite(a).all())
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, p, rtol=RTOL, atol=ATOL)


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
