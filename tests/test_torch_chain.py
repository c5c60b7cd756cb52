"""The whole slice: JAX's channel outputs through both packages' back ends."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.code import load_code
from kmldpc_tpu.io import parse_constellation
from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.ops import fading_awgn_channel as jax_channel
from kmldpc_tpu.ops import make_encoder as jax_make_encoder
from kmldpc_tpu.ops import make_mapper as jax_make_mapper
from kmldpc_tpu.ops import random_bits as jax_random_bits
from kmldpc_tpu.sim import chain as jchain
from kmldpc_torch.params import from_jax_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, make_chunk_runner

B = 16
VAR_15DB = np.float32(10 ** -1.5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _specs(assets, table, known_h):
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / table))
    kw = dict(code=code, constellation=const, known_h=known_h, fading=True,
              metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    return jchain.ChainSpec(**kw, histogram=False), ChainSpec(**kw)


def _jax_channel_outputs(spec, params, key, var):
    """The JAX front end's (uu, yr, yi, hr, hi), drawn as build_frontend_fn
    draws them."""
    tables = JaxModemTables.from_constellation(spec.constellation)

    def front(params, key, var):
        k_bits, k_chan = jax.random.split(key)
        uu = jax_random_bits(k_bits, (B, spec.code.code_dim))
        _, cc_tx = jax_make_encoder(spec.code)(uu, params.gen_t)
        xr, xi = jax_make_mapper(tables)(cc_tx)
        return (uu,) + jax_channel(k_chan, xr, xi, jnp.sqrt(var), fading=True)

    return [np.array(a) for a in jax.jit(front)(params, key, var)]


@pytest.mark.parametrize(
    "table,known_h,seed",
    [("2bits_QPSK.txt", False, 0), ("4bit_16QAM_Gray.txt", False, 1),
     ("2bits_QPSK.txt", True, 2)],
    ids=["blind-qpsk", "blind-16qam", "known-h-qpsk"],
)
def test_backend_counters_equal_jax(assets, table, known_h, seed):
    jspec, tspec = _specs(assets, table, known_h)
    jparams = jchain.make_chain_params(jspec)
    key = jax.random.key(seed)
    ref = jax.jit(jchain.build_chain_fn(jspec, B))(jparams, key, VAR_15DB)
    uu, yr, yi, hr, hi = _jax_channel_outputs(jspec, jparams, key, VAR_15DB)
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    ours = build_backend_fn(tspec, B, "cpu")(
        params, *map(torch.from_numpy, (uu, yr, yi, hr, hi)), VAR_15DB
    )
    assert int(ours.err_bit) == int(ref.err_bit)
    assert int(ours.err_blk) == int(ref.err_blk)
    assert ours.tot_bit == int(ref.tot_bit) and ours.tot_blk == int(ref.tot_blk) == B
    assert float(ours.err_bit_sq) == float(ref.err_bit_sq)
    assert float(ours.iters) == pytest.approx(float(ref.iters), rel=1e-6)
    np.testing.assert_array_equal(ours.metrics.numpy(), np.asarray(ref.metrics))
    if not known_h:
        assert int(ref.err_blk) > 0  # the blind QPSK tie leaves block errors


def test_chunk_runner_deterministic_and_folded(assets):
    """A launch replays bit-identically; chunks_per_launch = 2 sums the two
    sub-chunks that the launch's seeds name."""
    _, spec = _specs(assets, "2bits_QPSK.txt", False)
    one = make_chunk_runner(spec, 8, 1, "cpu", seed=3)
    two = make_chunk_runner(spec, 4, 2, "cpu", seed=3)
    a, b = one(12.5, 5, 10 ** -1.25), one(12.5, 5, 10 ** -1.25)
    assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))
    c = one(12.5, 6, 10 ** -1.25)
    assert not torch.equal(a.metrics, c.metrics)
    f = two(12.5, 5, 10 ** -1.25)
    assert f.tot_blk == 8 and f.metrics.shape == (8, 4)
    assert two.blocks_per_launch == 8


ALL_TABLES = [
    "2bits_4PSK.txt", "2bits_QPSK.txt", "4bit_16QAM_Gray.txt",
    "4bit_16QAM_phi1.txt", "4bit_16QAM_phi2.txt", "6bits_64QAM_Gray.txt",
]


@pytest.mark.parametrize(
    "code_file,table",
    [("PEG2304regular0.5.txt", t) for t in ALL_TABLES]
    + [("PEG8064regular0.5.txt", "6bits_64QAM_Gray.txt")],
)
def test_every_table_runs_on_the_peg_codes(assets, code_file, table):
    """Known-h at 25 dB decodes every block; blind runs the K1 wrapper and
    the hard metric on every table (QPSK-like tables keep the ±ĥ tie)."""
    code = load_code(str(assets / code_file))
    const = parse_constellation(str(assets / table))
    for known_h in (True, False):
        spec = ChainSpec(code=code, constellation=const, known_h=known_h, fading=True,
                         metric_type=False, metric_iter=5, max_iter=50,
                         encoder_active=True)
        res = make_chunk_runner(spec, 2, 1, "cpu", seed=1)(25.0, 0, 10 ** -2.5)
        assert res.tot_blk == 2 and res.tot_bit == 2 * code.code_dim
        assert bool(torch.isfinite(res.metrics).all())
        if known_h:
            assert int(res.err_blk) == 0
