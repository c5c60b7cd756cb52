"""kmldpc_torch channel ops against kmldpc_tpu: encode, map, demap, channel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.code import load_code
from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.ops import make_encoder as jax_make_encoder
from kmldpc_tpu.ops import make_mapper as jax_make_mapper
from kmldpc_tpu.ops import make_soft_demapper as jax_make_soft_demapper
from kmldpc_tpu.ops.encode import encoder_table as jax_encoder_table
from kmldpc_torch.ops import (
    ModemTables,
    chunk_seed,
    encoder_table,
    fading_awgn_channel,
    make_encoder,
    make_generator,
    make_mapper,
    make_soft_demapper,
    random_bits,
)

from .oracle import demap_oracle

TABLES = ["2bits_QPSK.txt", "4bit_16QAM_Gray.txt", "6bits_64QAM_Gray.txt"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
