"""kmldpc_torch blind detection against kmldpc_tpu: k-means, K1 wrapper,
and the ambiguity selectors (classic hard, soft, 5G hard, pruned)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.decoder.bp import DecoderTables as JaxDecoderTables
from kmldpc_tpu.decoder.bp_em import flooding_decode_em as jax_decode_em
from kmldpc_tpu.detect.kmeans import make_blind_estimator as jax_make_blind_estimator
from kmldpc_tpu.detect.metric import make_ambiguity_selector as jax_make_selector
from kmldpc_tpu.ops import fading_awgn_channel as jax_channel
from kmldpc_tpu.ops import make_encoder as jax_make_encoder
from kmldpc_tpu.ops import make_mapper as jax_make_mapper
from kmldpc_tpu.ops import random_bits as jax_random_bits
from kmldpc_tpu.ops.encode import encoder_table as jax_encoder_table
from kmldpc_tpu.ops.modem import ModemTables as JaxModemTables
from kmldpc_torch.code import load_code
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.decoder import DecoderTables, flooding_decode_em
from kmldpc_torch.detect import kmeans_cuda
from kmldpc_torch.detect.kmeans import blind_estimate, expand_candidates, make_blind_estimator
from kmldpc_torch.detect.metric import complement_closed, make_ambiguity_selector
from kmldpc_torch.ops import ModemTables, encoder_table, make_encoder, make_mapper

TABLES = [  # (table, symbols per PEG2304 codeword)
    ("2bits_QPSK.txt", 1152), ("4bit_16QAM_Gray.txt", 576), ("6bits_64QAM_Gray.txt", 384),
]
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py's tolerance


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("early_exit", [False, True])
def test_kmeans_matches_pallas_interpret(assets, early_exit):
    """One case against the Pallas kernel itself, in interpret mode as
    tests/test_pallas.py runs it; its early exit against the port's
    estimator built with early_exit (on the CPU, the plain fixed loop)."""
    from jax.experimental.pallas import tpu as pltpu

    from kmldpc_tpu.detect.kmeans_pallas import make_blind_estimator_pallas

    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    rng = np.random.default_rng(11)
    yr, yi = (rng.normal(size=(12, 288)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        ref = make_blind_estimator_pallas(JaxModemTables.from_constellation(const),
                                          early_exit=early_exit)(
            jnp.asarray(yr), jnp.asarray(yi))
    ours = kmeans_cuda.make_blind_estimator_cuda(ModemTables.from_constellation(const),
                                                 early_exit=early_exit)(
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


PEG, G5 = "PEG2304regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"
SELECTORS = [
    # (code, table, metric_type, check rule of the metric decodes, prune,
    #  SNR in dB, blocks whose two smallest soft metrics lie within rtol 1e-4)
    (PEG, "4bit_16QAM_Gray.txt", True, "sumprod", False, 8.0, ()),
    (PEG, "4bit_16QAM_Gray.txt", True, "minsum", False, 8.0, ()),
    (G5, "4bit_16QAM_Gray.txt", True, "sumprod", False, 14.0, ()),
    (G5, "4bit_16QAM_Gray.txt", False, "sumprod", False, 14.0, ()),
    (PEG, "2bits_QPSK.txt", False, "sumprod", True, 8.0, ()),
]


def _jax_blind_inputs(code, const, b, seed, snr_db):
    """JAX's faded channel outputs of random codewords and JAX's k-means
    candidates for them (numpy)."""
    tables = JaxModemTables.from_constellation(const)
    k_bits, k_chan = jax.random.split(jax.random.key(seed))
    uu = jax_random_bits(k_bits, (b, code.code_dim))
    _, cc_tx = jax_make_encoder(code)(uu, jax_encoder_table(code))
    xr, xi = jax_make_mapper(tables)(cc_tx)
    sigma = jnp.sqrt(jnp.float32(10 ** (-snr_db / 10)))
    yr, yi, _, _ = jax_channel(k_chan, xr, xi, sigma, fading=True)
    h4_r, h4_i = jax_make_blind_estimator(tables)(yr, yi)
    return [np.array(a) for a in (yr, yi, h4_r, h4_i)]


@pytest.mark.parametrize(
    "code_file,table,metric_type,cn_rule,prune,snr_db,near_ties", SELECTORS,
    ids=["soft-peg-16qam", "soft-minsum-peg-16qam", "soft-5g-16qam", "hard-5g-16qam",
         "pruned-peg-qpsk"],
)
def test_selector_matches_jax(assets, code_file, table, metric_type, cn_rule, prune, snr_db,
                              near_ties):
    """The selectors that decode (soft metric, 5G hard metric) and the
    pruned one, on JAX's channel outputs and candidates, B = 8: hard
    |metric| values exactly equal, soft ones within rtol 1e-4; winners and
    their LLRs equal, except on the blocks named in ``near_ties``."""
    code = load_code(str(assets / code_file))
    const = parse_constellation(str(assets / table))
    b = 8
    yr, yi, h4_r, h4_i = _jax_blind_inputs(code, const, b, 21, snr_db)
    var = np.float32(10 ** (-snr_db / 10))
    if prune:
        assert complement_closed(code, const)
    ref = jax.jit(jax_make_selector(
        code, JaxModemTables.from_constellation(const), metric_type, 5,
        decode=lambda t, llr, it: jax_decode_em(t, llr, it, cn_rule=cn_rule),
        prune_complement=prune,
    ))(JaxDecoderTables.from_code(code), yr, yi, h4_r, h4_i, var)
    hr, hi, metrics, llr = make_ambiguity_selector(
        code, ModemTables.from_constellation(const), metric_type, 5,
        decode=lambda t, llr, it: flooding_decode_em(t, llr, it, cn_rule),
        prune_complement=prune,
    )(DecoderTables.from_code(code), *map(torch.from_numpy, (yr, yi, h4_r, h4_i)), var)
    ref_hr, ref_hi, ref_metrics, ref_llr = (np.asarray(a) for a in ref)
    assert metrics.shape == (b, 4) and llr.shape == (b, code.tx_len)
    tied = ()  # exact hard ties go to the first minimum in both packages
    if metric_type:
        np.testing.assert_allclose(metrics.numpy(), ref_metrics, rtol=1e-4, atol=0)
        two = np.sort(ref_metrics, axis=1)[:, :2]
        tied = tuple(int(i) for i in np.nonzero(two[:, 1] - two[:, 0] <= 1e-4 * two[:, 0])[0])
    else:
        np.testing.assert_array_equal(metrics.numpy(), ref_metrics)
    assert tied == near_ties
    same = np.setdiff1d(np.arange(b), near_ties)
    np.testing.assert_array_equal(hr.numpy()[same], ref_hr[same])
    np.testing.assert_array_equal(hi.numpy()[same], ref_hi[same])
    np.testing.assert_allclose(llr.numpy()[same], ref_llr[same], rtol=1e-5, atol=1e-5)
    assert len(np.unique(metrics.numpy())) > 1  # the candidates were told apart


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
