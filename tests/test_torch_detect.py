"""kmldpc_torch blind detection against kmldpc_tpu: k-means, K1 wrapper,
hard ambiguity selector."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.code import load_code
from kmldpc_tpu.decoder.bp import DecoderTables as JaxDecoderTables
from kmldpc_tpu.detect.kmeans import make_blind_estimator as jax_make_blind_estimator
from kmldpc_tpu.detect.metric import make_ambiguity_selector as jax_make_selector
from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.ops.modem import ModemTables as JaxModemTables
from kmldpc_torch.decoder import DecoderTables
from kmldpc_torch.detect import kmeans_cuda
from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates, make_blind_estimator
from kmldpc_torch.detect.metric import make_ambiguity_selector
from kmldpc_torch.ops import ModemTables, encoder_table, make_encoder, make_mapper

TABLES = [  # (table, symbols per PEG2304 codeword)
    ("2bits_QPSK.txt", 1152), ("4bit_16QAM_Gray.txt", 576), ("6bits_64QAM_Gray.txt", 384),
]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def peg(assets):
    return load_code(str(assets / "PEG2304regular0.5.txt"))


def _channel_rows(const, b, nsym, seed, snr_db=15.0):
    """Faded, noisy symbols of random data (numpy, f32)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, const.num_points, size=(b, nsym))
    h = (rng.normal(size=(b, 1)) + 1j * rng.normal(size=(b, 1))) * np.sqrt(0.5)
    sigma = np.sqrt(10 ** (-snr_db / 10))
    w = (rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))) * sigma / np.sqrt(2)
    y = h * const.points[idx] + w
    return y.real.astype(np.float32), y.imag.astype(np.float32)


@pytest.mark.parametrize("anchor", ["max", "first"])
@pytest.mark.parametrize("b", [16, 12, 7])
@pytest.mark.parametrize("fname,nsym", TABLES)
def test_kmeans_matches_jax(assets, fname, nsym, b, anchor):
    const = parse_constellation(str(assets / fname))
    rng = np.random.default_rng(b)
    noise = (rng.normal(size=(b, nsym)).astype(np.float32) for _ in range(2))
    for yr, yi in (_channel_rows(const, b, nsym, b), tuple(noise)):
        ours = make_blind_estimator(ModemTables.from_constellation(const), 20, anchor)(
            torch.from_numpy(yr), torch.from_numpy(yi))
        ref = jax.jit(jax_make_blind_estimator(
            JaxModemTables.from_constellation(const), 20, anchor))(yr, yi)
        for a, r in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_kmeans_matches_pallas_interpret(assets):
    """One case against the Pallas kernel itself, in interpret mode as
    tests/test_pallas.py runs it."""
    from jax.experimental.pallas import tpu as pltpu

    from kmldpc_tpu.detect.kmeans_pallas import make_blind_estimator_pallas

    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    rng = np.random.default_rng(11)
    yr, yi = (rng.normal(size=(12, 288)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        ref = make_blind_estimator_pallas(JaxModemTables.from_constellation(const))(
            jnp.asarray(yr), jnp.asarray(yi))
    ours = make_blind_estimator(ModemTables.from_constellation(const))(
        torch.from_numpy(yr), torch.from_numpy(yi))
    for a, r in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


def test_k1_wrapper_on_cpu_runs_plain_version(assets):
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const)
    yr, yi = map(torch.from_numpy, _channel_rows(const, 7, 1152, 3))
    before = kmeans_cuda.kmeans_estimate.launches
    got = kmeans_cuda.make_blind_estimator_cuda(tables)(yr, yi)
    want = expand_candidates(*blind_estimate(yr, yi, tables))
    assert kmeans_cuda.kmeans_estimate.launches == before  # no kernel on the CPU
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    with pytest.raises(TypeError, match="float32"):
        kmeans_cuda.kmeans_estimate(yr.double(), yi.double(), tables)
    with pytest.raises(ValueError, match="contiguous"):
        kmeans_cuda.kmeans_estimate(yr.T, yi.T, tables)
    with pytest.raises(ValueError, match="anchor"):
        kmeans_cuda.make_blind_estimator_cuda(tables, anchor="middle")


def test_kmeans_empty_anchor_keeps_h(assets):
    """All-zero rows: every centroid lands on cluster 0 with h = 0 and the
    estimate stays finite (the reference's 0/0 is the documented divergence)."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    z = torch.zeros((3, 64))
    h_r, h_i = blind_estimate(z, z, ModemTables.from_constellation(const))
    assert torch.isfinite(h_r).all() and torch.isfinite(h_i).all()


@pytest.mark.parametrize("fname", ["2bits_QPSK.txt", "4bit_16QAM_Gray.txt"])
def test_hard_selector_matches_jax(assets, peg, fname):
    const = parse_constellation(str(assets / fname))
    nsym = peg.num_col // const.bits_per_symbol
    b = 8
    yr, yi = _channel_rows(const, b, nsym, 5, snr_db=8.0)
    h4 = jax_make_blind_estimator(JaxModemTables.from_constellation(const))(yr, yi)
    h4_r, h4_i = (np.array(a) for a in h4)
    var = np.float32(10 ** -0.8)
    ref = jax.jit(jax_make_selector(peg, JaxModemTables.from_constellation(const), False, 5))(
        JaxDecoderTables.from_code(peg), yr, yi, h4_r, h4_i, var)
    ours = make_ambiguity_selector(peg, ModemTables.from_constellation(const), False, 5)(
        DecoderTables.from_code(peg), *map(torch.from_numpy, (yr, yi, h4_r, h4_i)), var)
    hr, hi, metrics, llr = ours
    np.testing.assert_array_equal(metrics.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(hr.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(llr.numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-5)


def test_hard_selector_constructed_tie_takes_first(assets, peg):
    """QPSK + even-degree rows: the ĥ and -ĥ candidates tie exactly
    (detect/metric.py), so the first minimum must win.  Noiseless blocks
    with the true gain as candidate 0: candidates 0 and 2 both reach metric
    0 and the winner is candidate 0; with the true gain in slot 2 the
    winner is still slot 0 (its negation), as in JAX."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const)
    rng = np.random.default_rng(8)
    uu = torch.from_numpy(rng.integers(0, 2, size=(2, peg.code_dim)).astype(np.int8))
    _, cc = make_encoder(peg)(uu, encoder_table(peg))
    xr, xi = make_mapper(tables)(cc)
    hr0, hi0 = torch.tensor([0.8, -0.3]), torch.tensor([0.1, 0.9])
    yr = hr0[:, None] * xr - hi0[:, None] * xi
    yi = hr0[:, None] * xi + hi0[:, None] * xr
    h4_r, h4_i = expand_candidates(hr0, hi0)
    select = make_ambiguity_selector(peg, tables, False, 5)
    t = DecoderTables.from_code(peg)
    hr, hi, metrics, _ = select(t, yr, yi, h4_r, h4_i, 1e-3)
    assert (metrics[:, 0] == 0).all() and (metrics[:, 2] == 0).all()
    assert torch.equal(hr, hr0) and torch.equal(hi, hi0)
    # the same blocks with the candidates rotated by pi: the tie now picks
    # -ĥ_true (slot 0 of the rotated list), never slot 2
    hr, hi, metrics, _ = select(t, yr, yi, -h4_r, -h4_i, 1e-3)
    assert torch.equal(metrics[:, 0], metrics[:, 2])
    assert torch.equal(hr, -hr0) and torch.equal(hi, -hi0)
    ref = jax_make_selector(peg, JaxModemTables.from_constellation(const), False, 5)(
        JaxDecoderTables.from_code(peg), yr.numpy(), yi.numpy(),
        -h4_r.numpy(), -h4_i.numpy(), np.float32(1e-3))
    np.testing.assert_array_equal(hr.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(metrics.numpy(), np.asarray(ref[2]))


def test_argmin_first_minimum():
    """torch.argmin returns the first of tied minima (the selector's rule)."""
    m = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0], [5.0, 4.0, 9.0, 4.0]])
    assert torch.argmin(m, dim=1).tolist() == [1, 0, 1]
