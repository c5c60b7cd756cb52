"""kmldpc_torch flooding decoder against kmldpc_tpu's and the float64 oracle:
the slot-major core (PEG2304), the degree-class core (5G BG2 K=960),
both check rules, the two-phase schedule, and the edge-major reference
decoder."""

import jax
import numpy as np
import pytest
import torch

from kmldpc_tpu.decoder.bp import DecoderTables as JaxDecoderTables
from kmldpc_tpu.decoder.bp import flooding_decode as jax_flooding_decode
from kmldpc_tpu.decoder.bp import phi as jax_phi
from kmldpc_tpu.decoder import bp_em as jax_bp_em
from kmldpc_tpu.decoder.bp_em import flooding_decode_em as jax_decode_em
from kmldpc_torch import constants
from kmldpc_torch.code import compile_code, load_code
from kmldpc_torch.code.gf2 import gf2_matvec
from kmldpc_torch.decoder import (
    DecoderTables,
    count_failed_checks,
    flooding_decode,
    flooding_decode_em,
    make_flooding_decoder,
    phi,
    two_phase_generic,
)
from kmldpc_torch.decoder.bp import channel_llr_to_columns
from kmldpc_torch.decoder.bp_em import _decode_cols_classes, _insert_punct

from .oracle import bp_decode_prob
from .test_decoder import hamming74


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


@pytest.fixture(scope="module")
def g5(assets):
    return load_code(str(assets / "5GLDPCBG2a3_R12_K960.txt"))


@pytest.fixture(scope="module")
def ham():
    return compile_code(hamming74(), name="hamming74")


def _noisy_llr(code, rng, b, amp, noise):
    """[B, tx_len] LLRs amp*(1-2c) + N(0, noise^2) of random codewords (a 5G
    code transmits all but its punctured leading columns)."""
    uu = rng.integers(0, 2, size=(b, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])[:, code.punct:]
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


@pytest.mark.parametrize("noise", [2.4, 2.6])
def test_drifting_soft_syndromes_as_close_to_oracle_as_jax(peg, noise):
    """Where the soft syndromes drift from JAX's (noise 2.4-2.6), the float64
    prob-domain oracle decides: on the two codewords that converge last,
    both packages are within tests/test_decoder.py's tolerance of it, and
    the port's worst relative error is no larger than JAX's."""
    llr = _noisy_llr(peg, np.random.default_rng(int(noise * 10)), 16, 3.0, noise)
    ours, ref = _decode_both(peg, noise)
    iters = np.where(ours.converged.numpy(), ours.iters.numpy(), -1)
    for i in np.argsort(-iters, kind="stable")[:2]:
        assert ours.converged[i]
        p0 = 1.0 / (1.0 + np.exp(-llr[i].astype(np.float64)))
        cc_exp, conv_exp, iters_exp, ss_exp = bp_decode_prob(peg, p0, 50)
        assert conv_exp and iters_exp == int(ours.iters[i]) == int(ref.iters[i])
        np.testing.assert_array_equal(ours.cc_hat[i].numpy(), cc_exp)
        port, jax_ss = ours.soft_syndrome[i].numpy(), np.asarray(ref.soft_syndrome[i])
        np.testing.assert_allclose(port, ss_exp, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(jax_ss, ss_exp, rtol=1e-3, atol=1e-5)
        rel = lambda ss: float(np.max(np.abs(ss - ss_exp) / np.abs(ss_exp)))  # noqa: E731
        assert rel(port) <= rel(jax_ss), (i, rel(port), rel(jax_ss))


_jax_classes = jax.jit(jax_bp_em._decode_cols_classes, static_argnums=(2, 3, 4, 5))


def _classes_both(g5, noise, cn_rule="sumprod"):
    """The 5G code, B=16: the port's and JAX's degree-class cores on the
    same punctured column LLRs."""
    llr = _noisy_llr(g5, np.random.default_rng(int(noise * 10)), 16, 3.0, noise)
    t = DecoderTables.from_code(g5)
    col = _insert_punct(t, torch.from_numpy(llr).T.contiguous())
    ours = _decode_cols_classes(t, col, 50, cn_rule)
    ref = _jax_classes(JaxDecoderTables.from_code(g5), col.numpy(), 50, np.float32, cn_rule, 0.75)
    return llr, ours, ref


@pytest.mark.parametrize("noise", [1.6, 2.0, 2.4, 2.6])
def test_class_core_matches_jax(g5, noise):
    """Hard decisions, iteration counts and convergence exactly equal to
    JAX's _decode_cols_classes, from all-converged (1.6) to codewords that
    need 26 iterations (2.6)."""
    _, ours, ref = _classes_both(g5, noise)
    for f in ("cc_hat", "uu_hat", "iters", "converged"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("noise", [1.6, 2.0, 2.4])
def test_class_core_soft_syndrome_matches_jax(g5, noise):
    _, ours, ref = _classes_both(g5, noise)
    np.testing.assert_allclose(
        ours.soft_syndrome.numpy(), np.asarray(ref.soft_syndrome), rtol=1e-5, atol=1e-6
    )


def test_class_core_drift_as_close_to_oracle_as_jax(g5):
    """At noise 2.6 the soft syndromes of the slowest codewords drift from
    JAX's beyond 1e-5 (as on PEG2304, ROADMAP.md Queue 3); on the two that
    converge last, both packages are within tests/test_decoder.py's
    tolerance of the float64 oracle, punctured columns at P0 = 0.5, and
    the port's worst relative error is no larger than JAX's."""
    llr, ours, ref = _classes_both(g5, 2.6)
    t = DecoderTables.from_code(g5)
    llr_cols = channel_llr_to_columns(t, torch.from_numpy(llr)).numpy()
    iters = np.where(ours.converged.numpy(), ours.iters.numpy(), -1)
    ss_ours, ss_jax = ours.soft_syndrome.T.numpy(), np.asarray(ref.soft_syndrome).T
    for i in np.argsort(-iters, kind="stable")[:2]:
        assert ours.converged[i]
        p0 = 1.0 / (1.0 + np.exp(-llr_cols[i].astype(np.float64)))
        cc_exp, conv_exp, iters_exp, ss_exp = bp_decode_prob(g5, p0, 50)
        assert conv_exp and iters_exp == int(ours.iters[i]) == int(ref.iters[i])
        np.testing.assert_array_equal(ours.cc_hat[:, i].numpy(), cc_exp)
        np.testing.assert_allclose(ss_ours[i], ss_exp, rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(ss_jax[i], ss_exp, rtol=1e-3, atol=1e-5)
        rel = lambda ss: float(np.max(np.abs(ss - ss_exp) / np.abs(ss_exp)))  # noqa: E731
        assert rel(ss_ours[i]) <= rel(ss_jax[i]), (i, rel(ss_ours[i]), rel(ss_jax[i]))


@pytest.mark.parametrize("noise", [1.6, 2.4, 2.8])
@pytest.mark.parametrize("code_fixture", ["peg", "g5"])
def test_minsum_matches_jax(request, code_fixture, noise):
    """cn_rule = "minsum" through the public decoder (slot-major core for
    PEG2304, degree-class core for 5G), against JAX's: hard outputs exactly
    equal, also for the codewords that never converge (2.8); soft
    syndromes (a sigmoid of exact min-sum messages) within rtol 1e-6."""
    code = request.getfixturevalue(code_fixture)
    llr = _noisy_llr(code, np.random.default_rng(int(noise * 10)), 16, 3.0, noise)
    ours = flooding_decode_em(DecoderTables.from_code(code), torch.from_numpy(llr), 50, "minsum")
    ref = jax.jit(jax_decode_em, static_argnums=(2, 3, 4, 5))(
        JaxDecoderTables.from_code(code), llr, 50, np.float32, "minsum", 0.75)
    for f in ("cc_hat", "uu_hat", "iters", "converged"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(
        ours.soft_syndrome.numpy(), np.asarray(ref.soft_syndrome), rtol=1e-6, atol=0
    )


def _two_phase(t, llr, phase1_iters, tile, **kw):
    """The exact two-phase schedule over the flooding decoder, 50 iterations."""
    return two_phase_generic(lambda x, n: flooding_decode_em(t, x, n, **kw), llr, 50,
                             phase1_iters=phase1_iters, tile=tile)


@pytest.mark.parametrize("cn_rule", ["sumprod", "minsum"])
def test_two_phase_identical_to_single_phase_5g(g5, cn_rule):
    llr = torch.from_numpy(_noisy_llr(g5, np.random.default_rng(9), 64, 3.0, 2.6))
    t = DecoderTables.from_code(g5)
    r1 = flooding_decode_em(t, llr, 50, cn_rule)
    r2 = _two_phase(t, llr, 3, 8, cn_rule=cn_rule)
    assert (r1.iters > 3).sum() > 8  # several phase-2 tiles
    assert r1.cc_hat.shape == (64, g5.num_col) and r1.uu_hat.shape == (64, g5.code_dim)
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


def test_unknown_cn_rule_raises(peg):
    with pytest.raises(ValueError, match="cn_rule"):
        flooding_decode_em(DecoderTables.from_code(peg), torch.zeros((2, peg.num_col)), 5, "max")


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
    r2 = _two_phase(t, llr, 3, 8)
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


def test_count_failed_checks(ham, peg, g5):
    rng = np.random.default_rng(5)
    for code in (ham, peg, g5):
        uu = rng.integers(0, 2, size=code.code_dim).astype(np.uint8)
        cc = code.encode_reference(uu)
        words = np.stack([cc, 1 - cc, rng.integers(0, 2, code.num_col)]).astype(np.int8)
        got = count_failed_checks(DecoderTables.from_code(code), torch.from_numpy(words))
        h = code.dense_h()
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), [int(gf2_matvec(h, w).sum()) for w in words]
        )


@pytest.mark.parametrize("code_fixture", ["peg", "g5"])
def test_bfloat16_messages_match_jax(request, code_fixture):
    """bfloat16 message storage in both cores (slot-major PEG2304,
    degree-class 5G) on tests/test_decoder.py::test_bfloat16_message_mode's
    inputs: hard outputs, iterations and convergence equal to JAX's bf16
    decode, every block decoded, and the two-phase decode equal to the
    single-phase one."""
    code = request.getfixturevalue(code_fixture)
    t = DecoderTables.from_code(code)
    rng = np.random.default_rng(13)
    b = 32
    uu = rng.integers(0, 2, size=(b, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])
    sig = 1 - 2 * cc[:, code.punct :].astype(np.float64)
    llr = (6.0 * sig + rng.normal(scale=2.0, size=sig.shape)).astype(np.float32)
    ours = flooding_decode_em(t, torch.from_numpy(llr), 50, msg_dtype=torch.bfloat16)
    ref = jax.jit(jax_decode_em, static_argnums=(2, 3))(
        JaxDecoderTables.from_code(code), llr, 50, jax.numpy.bfloat16)
    for f in ("cc_hat", "uu_hat", "iters", "converged"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(ours.uu_hat.numpy(), uu)
    assert bool(ours.converged.all())
    two = _two_phase(t, torch.from_numpy(llr), 4, 8, msg_dtype=torch.bfloat16)
    for a, b2 in zip(ours, two):
        assert torch.equal(a, b2)


@pytest.mark.parametrize("noise", [2.8, 3.0])
def test_class_core_unconverged_as_close_to_oracle_as_jax(g5, noise):
    """Sum-product on the 5G code, B = 16: the codewords that never converge
    (12 of 16 at 2.8, all 16 at 3.0).  Where the port's hard decisions
    differ from JAX's (one codeword at each noise: 2 bits and 1 bit), the
    float64 oracle decides, codeword by codeword: the port is no further
    from it than JAX (measured: 1 against 3 bits, 0 against 1).  Elsewhere
    the two are bitwise equal, so equally far."""
    llr, ours, ref = _classes_both(g5, noise)
    t = DecoderTables.from_code(g5)
    llr_cols = channel_llr_to_columns(t, torch.from_numpy(llr)).numpy()
    unconv = np.flatnonzero(~ours.converged.numpy())
    np.testing.assert_array_equal(ours.converged.numpy(), np.asarray(ref.converged))
    port, jx = ours.cc_hat.numpy().T, np.asarray(ref.cc_hat).T
    differ = [i for i in unconv if not np.array_equal(port[i], jx[i])]
    assert len(unconv) >= 12 and len(differ) <= 1
    for i in differ:
        p0 = 1.0 / (1.0 + np.exp(-llr_cols[i].astype(np.float64)))
        cc_exp, conv_exp, _, _ = bp_decode_prob(g5, p0, 50)
        assert not conv_exp
        assert int((port[i] != cc_exp).sum()) <= int((jx[i] != cc_exp).sum())


@pytest.mark.parametrize("code_fixture,noise", [("peg", 1.6), ("peg", 2.4), ("peg", 3.0),
                                                ("g5", 1.6), ("g5", 2.0), ("g5", 2.4)])
def test_edge_major_decode_matches_jax(request, code_fixture, noise):
    """The edge-major reference decoder against the JAX package's jitted
    flooding_decode on the same LLRs (B = 16): hard decisions, iterations
    and convergence exactly equal, soft syndromes within rtol 1e-5 below
    the waterfall, and the same hard outputs as the port's chain decoder
    (slot-major or degree-class core).  The noise ranges are the cores'
    tests': PEG2304 from all-converged to none-converged, 5G up to 2.4,
    since 5G codewords that never converge follow the float32 rounding of
    tanh and log in a few bits (test_class_core_unconverged_as_close_to_oracle_as_jax)."""
    code = request.getfixturevalue(code_fixture)
    llr = _noisy_llr(code, np.random.default_rng(int(noise * 10) + 1), 16, 3.0, noise)
    ours = flooding_decode(DecoderTables.from_code(code), torch.from_numpy(llr), 50)
    ref = jax.jit(jax_flooding_decode, static_argnums=2)(JaxDecoderTables.from_code(code),
                                                         llr, 50)
    for f in ("uu_hat", "cc_hat", "converged", "iters"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert ours.cc_hat.dtype == torch.int8 and ours.iters.dtype == torch.int32
    if noise < 2.4:
        np.testing.assert_allclose(ours.soft_syndrome.numpy(), np.asarray(ref.soft_syndrome),
                                   rtol=1e-5, atol=0)
    core = flooding_decode_em(DecoderTables.from_code(code), torch.from_numpy(llr), 50)
    for f in ("uu_hat", "cc_hat", "converged", "iters"):
        assert torch.equal(getattr(ours, f), getattr(core, f)), f


def test_edge_major_matches_prob_domain_oracle(ham):
    """The float64 oracle and tolerances of tests/test_decoder.py, through
    make_flooding_decoder on Hamming(7,4)."""
    rng = np.random.default_rng(0)
    p0 = rng.uniform(0.05, 0.95, size=(40, ham.num_col))
    pc = np.clip(p0, constants.SMALLEST_PROB, 1 - constants.SMALLEST_PROB)
    res = make_flooding_decoder(ham)(torch.tensor(np.log(pc / (1 - pc)), dtype=torch.float32), 10)
    for i in range(p0.shape[0]):
        cc_exp, conv_exp, iters_exp, ss_exp = bp_decode_prob(ham, p0[i], 10)
        np.testing.assert_array_equal(res.cc_hat[i].numpy(), cc_exp, err_msg=f"case {i}")
        assert bool(res.converged[i]) == conv_exp, f"case {i}"
        assert int(res.iters[i]) == iters_exp, f"case {i}"
        np.testing.assert_allclose(
            res.soft_syndrome[i].numpy(), ss_exp, rtol=1e-3, atol=1e-5, err_msg=f"case {i}"
        )


@pytest.mark.parametrize("code_fixture", ["ham", "peg", "g5"])
def test_edge_major_noiseless_recovery(request, code_fixture):
    """Clipped noiseless LLRs decode in one iteration (5G: the punctured
    columns carry LLR 0), as tests/test_decoder.py pins."""
    code = request.getfixturevalue(code_fixture)
    rng = np.random.default_rng(1)
    uu = rng.integers(0, 2, size=(4, code.code_dim)).astype(np.uint8)
    cc = np.stack([code.encode_reference(u) for u in uu])[:, code.punct:]
    llr = torch.tensor(np.where(cc == 0, 12.0, -12.0), dtype=torch.float32)
    decode = make_flooding_decoder(code)
    assert decode.tables.num_edges == code.num_edges
    res = decode(llr, 50)
    np.testing.assert_array_equal(res.uu_hat.numpy(), uu)
    assert bool(res.converged.all())
