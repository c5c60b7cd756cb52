"""kmldpc_torch channel ops against kmldpc_tpu: encode, map, demap, channel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.ops import make_encoder as jax_make_encoder
from kmldpc_tpu.ops import make_mapper as jax_make_mapper
from kmldpc_tpu.ops import make_soft_demapper as jax_make_soft_demapper
from kmldpc_tpu.ops.channel import (
    partitioned_fading_awgn_channel as jax_partitioned_channel,
)
from kmldpc_tpu.ops.encode import encoder_table as jax_encoder_table
from kmldpc_tpu.ops.modem import make_partition_demapper as jax_make_partition_demapper
from kmldpc_tpu.ops.modem import make_prior_demapper as jax_make_prior_demapper
from kmldpc_tpu.ops.source import random_symbols as jax_random_symbols
from kmldpc_torch.code import load_code
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import (
    ModemTables,
    chunk_seed,
    encoder_table,
    fading_awgn_channel,
    make_encoder,
    make_generator,
    make_mapper,
    make_partition_demapper,
    make_prior_demapper,
    make_soft_demapper,
    partitioned_fading_awgn_channel,
    random_bits,
    random_symbols,
)

from .oracle import demap_oracle, demap_prior_oracle

TABLES = ["2bits_QPSK.txt", "4bit_16QAM_Gray.txt", "6bits_64QAM_Gray.txt",
          "8bits_256QAM_Gray.txt"]


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


def test_encoder_bit_exact_vs_jax_and_oracle(peg):
    rng = np.random.default_rng(0)
    uu = rng.integers(0, 2, size=(8, peg.code_dim)).astype(np.int8)
    ref_full, ref_tx = jax.jit(jax_make_encoder(peg))(jnp.asarray(uu), jax_encoder_table(peg))
    cc_full, cc_tx = make_encoder(peg)(torch.from_numpy(uu), encoder_table(peg))
    assert cc_full.dtype == torch.int8
    np.testing.assert_array_equal(cc_full.numpy(), np.asarray(ref_full))
    np.testing.assert_array_equal(cc_tx.numpy(), np.asarray(ref_tx))
    for b in range(2):
        np.testing.assert_array_equal(cc_full[b].numpy(), peg.encode_reference(uu[b]))


@pytest.mark.parametrize("active", [True, False])
def test_encoder_5g_bit_exact_vs_jax_and_oracle(assets, active):
    """5G: cc_full = [info | parity] over all 2112 columns, the first 2Z =
    192 punctured from cc_tx (1920 bits = 480 16QAM symbols)."""
    g5 = load_code(str(assets / "5GLDPCBG2a3_R12_K960.txt"))
    uu = np.random.default_rng(6).integers(0, 2, size=(8, g5.code_dim)).astype(np.int8)
    ref_full, ref_tx = jax.jit(jax_make_encoder(g5, active))(jnp.asarray(uu), jax_encoder_table(g5))
    cc_full, cc_tx = make_encoder(g5, active)(torch.from_numpy(uu), encoder_table(g5))
    assert cc_full.shape == (8, 2112) and cc_tx.shape == (8, g5.tx_len) == (8, 1920)
    np.testing.assert_array_equal(cc_full.numpy(), np.asarray(ref_full))
    np.testing.assert_array_equal(cc_tx.numpy(), np.asarray(ref_tx))
    if active:
        np.testing.assert_array_equal(cc_full[:, : g5.code_dim].numpy(), uu)
        for b in range(2):
            np.testing.assert_array_equal(cc_full[b].numpy(), g5.encode_reference(uu[b]))
    else:
        assert not cc_full.any()


def test_encoder_inactive_all_zero(peg):
    uu = torch.ones((3, peg.code_dim), dtype=torch.int8)
    cc_full, _ = make_encoder(peg, active=False)(uu, encoder_table(peg))
    assert not cc_full.any()


@pytest.mark.parametrize("fname", TABLES)
def test_mapper_bit_exact_vs_jax(assets, fname):
    c = parse_constellation(str(assets / fname))
    m = c.bits_per_symbol
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(4, 96 * m)).astype(np.int8)
    xr, xi = make_mapper(ModemTables.from_constellation(c))(torch.from_numpy(bits))
    rr, ri = jax_make_mapper(JaxModemTables.from_constellation(c))(jnp.asarray(bits))
    np.testing.assert_array_equal(xr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(xi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("fname", TABLES)
def test_demap_matches_jax(assets, fname):
    c = parse_constellation(str(assets / fname))
    rng = np.random.default_rng(2)
    b, nsym = 6, 48
    yr, yi = (rng.normal(size=(b, nsym)).astype(np.float32) for _ in range(2))
    hr, hi = (rng.normal(size=b).astype(np.float32) for _ in range(2))
    var = np.float32(10 ** -1.0)
    p0, llr = make_soft_demapper(ModemTables.from_constellation(c))(
        *map(torch.from_numpy, (yr, yi, hr, hi)), var
    )
    rp0, rllr = jax.jit(jax_make_soft_demapper(JaxModemTables.from_constellation(c)))(
        yr, yi, hr, hi, var
    )
    np.testing.assert_allclose(p0.numpy(), np.asarray(rp0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(llr.numpy(), np.asarray(rllr), rtol=1e-5, atol=1e-5)
    assert np.isfinite(llr.numpy()).all()


@pytest.mark.parametrize("fname", ["2bits_QPSK.txt", "4bit_16QAM_Gray.txt"])
def test_demap_matches_bayes_oracle(assets, fname):
    """Same float64 oracle and tolerances as tests/test_ops.py."""
    c = parse_constellation(str(assets / fname))
    demap = make_soft_demapper(ModemTables.from_constellation(c))
    rng = np.random.default_rng(3)
    b, nsym = 3, 5
    y = rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))
    h = rng.normal(size=b) + 1j * rng.normal(size=b)
    var = 0.3
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    bit_p0, chan_llr = demap(t(y.real), t(y.imag), t(h.real), t(h.imag), var)
    bit_p0 = bit_p0.numpy().reshape(b, nsym, c.bits_per_symbol)
    for i in range(b):
        for s in range(nsym):
            expect = demap_oracle(y[i, s], h[i], var, c.points, c.bits)
            np.testing.assert_allclose(bit_p0[i, s], expect, rtol=5e-3, atol=1e-5)
    ll = chan_llr.numpy().reshape(b, nsym, -1)
    np.testing.assert_allclose(
        ll[0, 0], np.log(bit_p0[0, 0] / (1 - bit_p0[0, 0])), rtol=1e-3, atol=1e-4
    )


def test_demap_noiseless_certain_and_finite(assets):
    c = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(c)
    bits = torch.tensor([[0, 0, 0, 1, 1, 0, 1, 1]], dtype=torch.int8)
    xr, xi = make_mapper(tables)(bits)
    one, zero = torch.ones(1), torch.zeros(1)
    p0, llr = make_soft_demapper(tables)(xr, xi, one, zero, 1e-4)
    np.testing.assert_array_equal((p0.numpy() < 0.5).astype(np.int8), bits.numpy())
    assert np.isfinite(llr.numpy()).all()
    # each bit class holds 2 clipped points: |LLR| = log(1 / 2e-12), as in JAX
    _, ref = jax_make_soft_demapper(JaxModemTables.from_constellation(c))(
        jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()), jnp.ones(1), jnp.zeros(1), 1e-4
    )
    np.testing.assert_allclose(llr.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(np.abs(llr.numpy()), np.log(0.5e12), rtol=1e-6)


def test_channel_statistics():
    g = make_generator(7, "cpu")
    b, n = 512, 64
    sigma = 0.5
    yr, yi, hr, hi = fading_awgn_channel(g, torch.ones((b, n)), torch.zeros((b, n)), sigma)
    h2 = (hr**2 + hi**2).numpy()
    assert abs(h2.mean() - 1.0) < 0.15  # E|h|^2 = 1
    res = (yr - hr[:, None]).numpy()
    assert abs(res.var() - sigma**2 / 2) < 0.01  # sigma^2/2 per component
    yr, _, hr, hi = fading_awgn_channel(g, torch.ones((4, 8)), torch.zeros((4, 8)), 0.0, False)
    np.testing.assert_array_equal(hr.numpy(), 1.0)
    np.testing.assert_array_equal(yr.numpy(), 1.0)


def test_random_bits_and_chunk_seeds():
    bits = random_bits(make_generator(0, "cpu"), (64, 1000), "cpu")
    assert bits.dtype == torch.int8
    assert 0.47 < bits.double().mean().item() < 0.53
    again = random_bits(make_generator(0, "cpu"), (64, 1000), "cpu")
    assert torch.equal(bits, again)
    seeds = {chunk_seed(0, snr, launch, sub)
             for snr in (5.0, 7.5, -2.5) for launch in range(3) for sub in range(2)}
    assert len(seeds) == 18
    assert chunk_seed(1, 5.0, 0, 0) != chunk_seed(0, 5.0, 0, 0)
    assert chunk_seed(0, 15.0, 2, 1) == chunk_seed(0, 15.0004, 2, 1)  # milli-dB key
    assert all(0 <= s < 2**63 for s in seeds)


def test_random_symbols_distribution_as_jax():
    """Uniform over [0, qary) as int32, as the JAX package's draw (the two
    generators differ, so the draws are held to the same distribution
    check as tests/test_sim.py's), and a seed replays its draw."""
    ours = random_symbols(make_generator(0, "cpu"), 5, (4000,), "cpu")
    ref = np.asarray(jax_random_symbols(jax.random.key(0), 5, (4000,)))
    assert ours.dtype == torch.int32 and ref.dtype == np.int32
    for s in (ours.numpy(), ref):
        assert s.min() >= 0 and s.max() <= 4
        assert (np.abs(np.bincount(s, minlength=5) / 4000 - 0.2) < 0.04).all()
    assert torch.equal(ours, random_symbols(make_generator(0, "cpu"), 5, (4000,), "cpu"))


def test_partitioned_channel_as_jax():
    """One h per equal segment: without noise y = h_p x on segment p, in the
    port as in the JAX package; one part draws what fading_awgn_channel
    draws; an indivisible count raises the JAX package's ValueError."""
    rng = np.random.default_rng(8)
    xr, xi = (rng.normal(size=(3, 12)).astype(np.float32) for _ in range(2))
    ours = partitioned_fading_awgn_channel(make_generator(2, "cpu"), torch.from_numpy(xr),
                                           torch.from_numpy(xi), 0.0, 3)
    ref = jax_partitioned_channel(jax.random.key(2), jnp.asarray(xr), jnp.asarray(xi), 0.0, 3)
    for yr, yi, hr, hi in ((t.numpy() for t in ours), (np.asarray(a) for a in ref)):
        assert hr.shape == hi.shape == (3, 3)
        h = np.repeat(hr + 1j * hi, 4, axis=1)
        np.testing.assert_allclose(yr + 1j * yi, h * (xr + 1j * xi), rtol=1e-6, atol=1e-6)
    one = partitioned_fading_awgn_channel(make_generator(4, "cpu"), torch.from_numpy(xr),
                                          torch.from_numpy(xi), 0.3, 1)
    plain = fading_awgn_channel(make_generator(4, "cpu"), torch.from_numpy(xr),
                                torch.from_numpy(xi), 0.3)
    for a, b in zip(one, plain):
        assert torch.equal(a.reshape(b.shape), b)
    with pytest.raises(ValueError) as e:
        partitioned_fading_awgn_channel(make_generator(0, "cpu"), torch.zeros((1, 8)),
                                        torch.zeros((1, 8)), 0.1, 3)
    with pytest.raises(ValueError) as e_ref:
        jax_partitioned_channel(jax.random.key(0), jnp.zeros((1, 8)), jnp.zeros((1, 8)), 0.1, 3)
    assert str(e.value) == str(e_ref.value) == "8 symbols not divisible into 3 parts"


@pytest.mark.parametrize("fname", TABLES)
def test_prior_demap_matches_jax_and_oracle(assets, fname):
    """Non-uniform priors: the prior-in / extrinsic-out demapper against the
    JAX package's under jax.jit (rtol 1e-5, as the soft demapper) and
    against tests/oracle.py's float64 demap_prior_oracle at
    tests/test_ops.py's tolerances."""
    c = parse_constellation(str(assets / fname))
    m = c.bits_per_symbol
    rng = np.random.default_rng(11)
    b, nsym = 3, 5
    y = rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))
    h = rng.normal(size=b) + 1j * rng.normal(size=b)
    prior = rng.uniform(0.05, 0.95, size=(b, nsym * m))
    var = np.float32(0.3)
    args = [a.astype(np.float32) for a in (y.real, y.imag, h.real, h.imag)]
    p0, llr = make_prior_demapper(ModemTables.from_constellation(c))(
        *map(torch.from_numpy, args), var, torch.from_numpy(prior.astype(np.float32)))
    rp0, rllr = jax.jit(jax_make_prior_demapper(JaxModemTables.from_constellation(c)))(
        *args, var, prior.astype(np.float32))
    np.testing.assert_allclose(p0.numpy(), np.asarray(rp0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(llr.numpy(), np.asarray(rllr), rtol=1e-5, atol=1e-5)
    got, ll = p0.numpy().reshape(b, nsym, m), llr.numpy().reshape(b, nsym, m)
    for i in range(b):
        for s in range(nsym):
            expect = demap_prior_oracle(y[i, s], h[i], float(var), c.points, c.bits,
                                        prior[i, s * m:(s + 1) * m])
            np.testing.assert_allclose(got[i, s], expect, rtol=5e-3, atol=1e-5)
            np.testing.assert_allclose(ll[i, s], np.log(expect / (1 - expect)),
                                       rtol=5e-3, atol=1e-3)


def test_prior_demap_uniform_equals_soft_demap(assets):
    """At uniform priors the prior demapper is the soft demapper, pinned as
    tests/test_ops.py pins it for the JAX package."""
    c = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    tables = ModemTables.from_constellation(c)
    rng = np.random.default_rng(5)
    b, nsym = 4, 8
    yr, yi = (torch.tensor(rng.normal(size=(b, nsym)), dtype=torch.float32) for _ in range(2))
    hr, hi = (torch.tensor(rng.normal(size=b), dtype=torch.float32) for _ in range(2))
    p0_u, llr_u = make_soft_demapper(tables)(yr, yi, hr, hi, 0.25)
    prior = torch.full((b, nsym * c.bits_per_symbol), 0.5)
    p0_p, llr_p = make_prior_demapper(tables)(yr, yi, hr, hi, 0.25, prior)
    np.testing.assert_allclose(p0_p.numpy(), p0_u.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(llr_p.numpy(), llr_u.numpy(), rtol=1e-4, atol=1e-4)


def test_partition_demap_as_jax(assets):
    """Two segments: the partition demapper equals the JAX package's on the
    same arrays and recovers each segment's bits with its own gain, where a
    single-h demap fails on the second segment (tests/test_aux.py); one
    part is the plain soft demapper; an indivisible count raises JAX's
    ValueError."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const)
    rng = np.random.default_rng(0)
    b, nsym, m = 4, 64, 2
    bits = rng.integers(0, 2, size=(b, nsym * m)).astype(np.int8)
    xr, xi = make_mapper(tables)(torch.from_numpy(bits))
    yr, yi, hr, hi = partitioned_fading_awgn_channel(make_generator(5, "cpu"), xr, xi, 1e-3, 2)
    _, llr = make_partition_demapper(tables, 2)(yr, yi, hr, hi, np.float32(1e-6))
    _, ref = jax_make_partition_demapper(JaxModemTables.from_constellation(const), 2)(
        *(t.numpy() for t in (yr, yi, hr, hi)), np.float32(1e-6))
    np.testing.assert_allclose(llr.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal((llr.numpy() <= 0).astype(np.int8), bits)
    _, llr1 = make_soft_demapper(tables)(yr, yi, hr[:, 0], hi[:, 0], np.float32(1e-6))
    wrong = (llr1.numpy() <= 0).astype(np.int8) != bits
    assert wrong[:, nsym // 2 * m:].mean() > 0.2
    p1, l1 = make_soft_demapper(tables)(yr, yi, hr[:, 0], hi[:, 0], np.float32(0.1))
    p2, l2 = make_partition_demapper(tables, 1)(yr, yi, hr[:, :1], hi[:, :1], np.float32(0.1))
    assert torch.equal(p1, p2) and torch.equal(l1, l2)
    with pytest.raises(ValueError) as e:
        make_partition_demapper(tables, 3)(torch.zeros((1, 8)), torch.zeros((1, 8)),
                                           torch.zeros((1, 3)), torch.zeros((1, 3)), 0.1)
    with pytest.raises(ValueError) as e_ref:
        jax_make_partition_demapper(JaxModemTables.from_constellation(const), 3)(
            jnp.zeros((1, 8)), jnp.zeros((1, 8)), jnp.zeros((1, 3)), jnp.zeros((1, 3)), 0.1)
    assert str(e.value) == str(e_ref.value)
