"""The port's float32 rounding on the 5G 16QAM paths, held against a float64
demap and against the JAX package over seeds 0-11.

The chain's bit errors on codewords that never converge follow the
demapper's LLRs to the last rounding, so the two packages' chains agree on
block errors but not always on bit errors.  These tests pin that this is
rounding and nothing more: the port's LLRs are no further from a float64
Bayes demap than the JAX package's, and every bit-error difference lies on
a codeword that converges in neither package.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kmldpc_tpu.config import load_config as jax_load_config
from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.ops import make_soft_demapper as jax_make_soft_demapper
from kmldpc_tpu.sim import chain as jchain
from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import ModemTables, make_soft_demapper
from kmldpc_torch.params import from_jax_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn

from .oracle import demap_oracle
from .test_torch_chain import B, SWEEPS, _jax_channel_outputs
from .test_torch_cuda import llr_float64

SEEDS = range(12)
# the port's worst and mean |LLR error| against the float64 demap may exceed
# the closer of the JAX package's two forms by at most this factor (see
# test_demap_llrs_no_further_from_float64_than_jax)
LLR_MARGIN = 1.10


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sweep(name):
    path = str(SWEEPS / name)
    cfg = load_config(path)
    code = load_code(cfg.matrix_path())
    const = parse_constellation(cfg.modem_path())
    jspec = jchain.ChainSpec.from_config(jax_load_config(path), code, const)
    return jspec, ChainSpec.from_config(cfg, code, const), const


def test_float64_demap_is_the_oracle(assets):
    """The vectorised float64 demap gives tests/oracle.py's bit
    probabilities on symbols whose bits are not clipped."""
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    rng = np.random.default_rng(4)
    y = (rng.normal(size=(2, 6)) + 1j * rng.normal(size=(2, 6))).astype(np.complex64)
    h = (rng.normal(size=2) + 1j * rng.normal(size=2)).astype(np.complex64)
    var = np.float32(0.3)
    llr = llr_float64(y.real, y.imag, h.real, h.imag, var, const.points, const.bit0_mask())
    for i in range(2):
        for s in range(6):
            p0 = demap_oracle(complex(y[i, s]), complex(h[i]), float(var), const.points, const.bits)
            np.testing.assert_allclose(llr[i, 4 * s:4 * s + 4], np.log(p0 / (1 - p0)),
                                       rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("sweep,snr_db", [("sweep3b_known_5g16qam_minsum.toml", 12.0),
                                          ("sweep7_blind_5g_soft_minsum.toml", 14.0)],
                         ids=["sweep3b", "sweep7"])
def test_demap_llrs_no_further_from_float64_than_jax(sweep, snr_db):
    """On identical channel outputs (the JAX front end's, seeds 0-11, B = 16,
    5G BG2 K = 960, 16QAM): (a) the port's demapper on the CPU, (b) the JAX
    package's demapper under jax.jit and (c) the LLRs JAX's jitted front end
    hands its final decode, each against a float64 Bayes demap of the same
    (y, h, var).  Known-h (sweep 3b) demaps with the true h; blind (sweep 7)
    with the winner of JAX's selection, for all three.

    Measured first (max over the seeds, mean over all LLRs): sweep 3b
    (a) 9.749e-6 / 5.848e-7, (b) 1.080e-5 / 5.535e-7, (c) 1.282e-5 / 6.094e-7;
    sweep 7 (a) 9.613e-6 / 7.276e-7, (b) and (c) 9.613e-6 / 6.919e-7.  The
    port's mean is 1.057 and 1.051 times the closer JAX form's, its worst
    no larger.  The likely cause is XLA's CPU backend fusing h·s into a
    multiply-add that rounds once where PyTorch rounds twice.  The port
    keeps its rounding: changing it would change the sweeps' counters.
    Hence the margin LLR_MARGIN = 1.10 on the worst and the mean error,
    against the closer of (b) and (c)."""
    jspec, _, const = _sweep(sweep)
    jspec = dataclasses.replace(jspec, debug_blocks=1)  # the candidates, for the winner
    jparams = jchain.make_chain_params(jspec)
    var = np.float32(10 ** (-snr_db / 10))
    front = jax.jit(jchain.build_frontend_fn(jspec, B))
    jax_demap = jax.jit(jax_make_soft_demapper(JaxModemTables.from_constellation(const)))
    demap = make_soft_demapper(ModemTables.from_constellation(const))
    errs = {"a": [], "b": [], "c": []}
    for seed in SEEDS:
        key = jax.random.key(seed)
        _, yr, yi, hr, hi = _jax_channel_outputs(jspec, jparams, key, var)
        _, chain_llr, metrics, _, debug = front(jparams, key, var)
        if not jspec.known_h:
            win = np.argmin(np.asarray(metrics), axis=1)
            hr = np.asarray(debug[2])[np.arange(B), win]
            hi = np.asarray(debug[3])[np.arange(B), win]
        ref = llr_float64(yr, yi, hr, hi, var, const.points, const.bit0_mask())
        ours = demap(*map(torch.from_numpy, (yr, yi, hr, hi)), var)[1].numpy()
        for name, llr in (("a", ours), ("b", np.asarray(jax_demap(yr, yi, hr, hi, var)[1])),
                          ("c", np.asarray(chain_llr))):
            errs[name].append(np.abs(llr.astype(np.float64) - ref))
    worst = {k: max(float(e.max()) for e in v) for k, v in errs.items()}
    mean = {k: float(np.mean(v)) for k, v in errs.items()}
    assert worst["a"] <= LLR_MARGIN * min(worst["b"], worst["c"]), (worst, mean)
    assert mean["a"] <= LLR_MARGIN * min(mean["b"], mean["c"]), (worst, mean)
    assert 0 < worst["a"] < 1e-4


@pytest.mark.parametrize(
    "sweep,snr_db",
    [("sweep3_known_5g16qam.toml", 15.0), ("sweep3b_known_5g16qam_minsum.toml", 15.0),
     ("sweep6_known_qpsk_bf16.toml", 5.0), ("sweep7_blind_5g_soft_minsum.toml", 19.0)],
    ids=["sweep3", "sweep3b", "sweep6", "sweep7"],
)
def test_chain_counters_over_seeds_differ_only_where_neither_converges(sweep, snr_db):
    """The JAX package's whole chain, and the port's back end on JAX's
    channel outputs and parameters, at the points of
    test_sweep_backend_counters_equal_jax, on every seed 0-11 (B = 16):
    block errors equal on every seed, and a codeword's bit errors differ
    only where it converges in neither package."""
    jspec, tspec, _ = _sweep(sweep)
    jparams = jchain.make_chain_params(jspec)
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    var = np.float32(10 ** (-snr_db / 10))
    jax_chain = jax.jit(jchain.build_chain_fn(jspec, B))
    backend = build_backend_fn(tspec, B, "cpu")
    differing = 0
    for seed in SEEDS:
        key = jax.random.key(seed)
        ref = jax_chain(jparams, key, var)
        uu, yr, yi, hr, hi = _jax_channel_outputs(jspec, jparams, key, var)
        ours = backend(params, *map(torch.from_numpy, (uu, yr, yi, hr, hi)), var)
        assert int(ours.err_blk) == int(ref.err_blk), seed
        ref_errs = (uu != np.asarray(ref.raw[0])).sum(axis=1)
        our_errs = (uu != ours.raw.uu_hat.numpy()).sum(axis=1)
        ref_conv, our_conv = np.asarray(ref.raw[2]), ours.raw.converged.numpy()
        for i in np.nonzero(ref_errs != our_errs)[0]:
            assert not ref_conv[i] and not our_conv[i], (seed, i)
            differing += 1
    # the known differences (ROADMAP.md Queue 3) are still there: this tests
    # the rule, not seeds where nothing differs
    if tspec.schedule == "layered-minsum" or tspec.dtype == "bfloat16":
        assert differing > 0
