"""kmldpc_torch flooding decoder against kmldpc_tpu's and the float64 oracle."""

import jax
import numpy as np
import pytest
import torch

from kmldpc_tpu import constants
from kmldpc_tpu.code import compile_code, load_code
from kmldpc_tpu.code.gf2 import gf2_matvec
from kmldpc_tpu.decoder.bp import DecoderTables as JaxDecoderTables
from kmldpc_tpu.decoder.bp import phi as jax_phi
from kmldpc_tpu.decoder.bp_em import flooding_decode_em as jax_decode_em
from kmldpc_torch.decoder import (
    DecoderTables,
    count_failed_checks,
    flooding_decode_em,
    flooding_decode_two_phase,
    phi,
)

from .oracle import bp_decode_prob
from .test_decoder import hamming74


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def peg(assets):
    return load_code(str(assets / "PEG2304regular0.5.txt"))


@pytest.fixture(scope="module")
def ham():
    return compile_code(hamming74(), name="hamming74")


def _noisy_llr(code, rng, b, amp, noise):
    uu = rng.integers(0, 2, size=(b, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])
    sig = 1 - 2 * cc.astype(np.float64)
    return (amp * sig + rng.normal(scale=noise, size=cc.shape)).astype(np.float32)


def test_phi_matches_jax():
    x = np.concatenate([
        np.float32([1e-6, 1e-3, 0.5, 4.999, 5.0, 5.001, 20.0, 27.6]),
        np.random.default_rng(0).uniform(1e-6, 30.0, size=1000).astype(np.float32),
    ])
    np.testing.assert_allclose(
        phi(torch.from_numpy(x)).numpy(), np.asarray(jax_phi(x)), rtol=1e-5, atol=0
    )


def _decode_both(peg, noise):
    llr = _noisy_llr(peg, np.random.default_rng(int(noise * 10)), 16, 3.0, noise)
    ours = flooding_decode_em(DecoderTables.from_code(peg), torch.from_numpy(llr), 50)
    ref = jax.jit(jax_decode_em, static_argnums=2)(JaxDecoderTables.from_code(peg), llr, 50)
    return ours, ref


@pytest.mark.parametrize("noise", [1.6, 2.0, 2.4, 2.6, 3.0])
def test_decode_matches_jax(peg, noise):
    """PEG2304, B=16, from all-converged to none-converged: hard decisions,
    iteration counts and convergence exactly equal to JAX's
    flooding_decode_em on the same LLRs."""
    ours, ref = _decode_both(peg, noise)
    np.testing.assert_array_equal(ours.cc_hat.numpy(), np.asarray(ref.cc_hat))
    np.testing.assert_array_equal(ours.uu_hat.numpy(), np.asarray(ref.uu_hat))
    np.testing.assert_array_equal(ours.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(ours.converged.numpy(), np.asarray(ref.converged))


@pytest.mark.parametrize("noise", [1.6, 2.0, 2.2, 3.0])
def test_decode_soft_syndrome_matches_jax(peg, noise):
    """Soft syndromes within rtol 1e-5 of JAX's.  Codewords that converge
    slowly in the waterfall (noise 2.4-2.6 here) drift further: the two
    frameworks' tanh/log differ by ulps, phi amplifies that near its branch
    point, and BP iterates it (ROADMAP.md Queue 3)."""
    ours, ref = _decode_both(peg, noise)
    np.testing.assert_allclose(
        ours.soft_syndrome.numpy(), np.asarray(ref.soft_syndrome), rtol=1e-5, atol=0
    )


def test_matches_prob_domain_oracle(ham):
    """Same oracle and tolerances as tests/test_decoder.py, on Hamming(7,4)."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0.05, 0.95, size=(40, ham.num_col))
    pc = np.clip(p0, constants.SMALLEST_PROB, 1 - constants.SMALLEST_PROB)
    llr = torch.tensor(np.log(pc / (1 - pc)), dtype=torch.float32)
    res = flooding_decode_em(DecoderTables.from_code(ham), llr, 10)
    for i in range(p0.shape[0]):
        cc_exp, conv_exp, iters_exp, ss_exp = bp_decode_prob(ham, p0[i], 10)
        np.testing.assert_array_equal(res.cc_hat[i].numpy(), cc_exp, err_msg=f"case {i}")
        assert bool(res.converged[i]) == conv_exp, f"case {i}"
        assert int(res.iters[i]) == iters_exp, f"case {i}"
        np.testing.assert_allclose(
            res.soft_syndrome[i].numpy(), ss_exp, rtol=1e-3, atol=1e-5, err_msg=f"case {i}"
        )


def test_two_phase_identical_to_single_phase(peg):
    llr = torch.from_numpy(_noisy_llr(peg, np.random.default_rng(9), 64, 3.0, 2.4))
    t = DecoderTables.from_code(peg)
    r1 = flooding_decode_em(t, llr, 50)
    r2 = flooding_decode_two_phase(t, llr, 50, phase1_iters=3, tile=8)
    assert (r1.iters > 3).sum() > 8  # several phase-2 tiles
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


def test_exit_check_interval_does_not_change_results(peg):
    from kmldpc_torch.decoder.bp_em import _decode_cols_padded

    llr = torch.from_numpy(_noisy_llr(peg, np.random.default_rng(4), 16, 3.0, 1.6))
    t = DecoderTables.from_code(peg)
    col = llr.T.contiguous()
    r1 = _decode_cols_padded(t, col, 50, exit_check_every=1)
    r7 = _decode_cols_padded(t, col, 50, exit_check_every=7)
    assert bool(r1.converged.all())
    for a, b in zip(r1, r7):
        assert torch.equal(a, b)


def test_count_failed_checks(ham, peg):
    rng = np.random.default_rng(5)
    for code in (ham, peg):
        uu = rng.integers(0, 2, size=code.code_dim).astype(np.uint8)
        cc = code.encode_reference(uu)
        words = np.stack([cc, 1 - cc, rng.integers(0, 2, code.num_col)]).astype(np.int8)
        got = count_failed_checks(DecoderTables.from_code(code), torch.from_numpy(words))
        h = code.dense_h()
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), [int(gf2_matvec(h, w).sum()) for w in words]
        )
