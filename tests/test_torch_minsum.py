"""kmldpc_torch layered min-sum against kmldpc_tpu's and a float64 oracle:
the QC path (5G BG2 K=960), the generic path (5G without QC, PEG2304's
whole-matrix layer), the two-phase schedule and the layered tables."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kmldpc_tpu.decoder import minsum as jax_minsum
from kmldpc_tpu.sim import chain as jchain
from kmldpc_torch import constants
from kmldpc_torch.code import load_code
from kmldpc_torch.decoder import layered_minsum_decode, minsum_tables, two_phase_generic
from kmldpc_torch.decoder.bp import channel_llr_to_columns
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.params import from_jax_params, make_chain_params

from .test_torch_decoder import _noisy_llr

FIELDS = ("cc_hat", "uu_hat", "iters", "converged")
_jax_decode = jax.jit(jax_minsum.layered_minsum_decode, static_argnums=(2, 3))


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


def _llr(code, noise, b=32):
    """[B, tx_len] LLRs 4(1-2c) + N(0, noise^2), seeded by the noise."""
    return _noisy_llr(code, np.random.default_rng(int(noise * 10)), b, 4.0, noise)


def _both(code, noise, use_qc=True):
    """The port's and JAX's layered decoders on the same LLRs (B = 32, 50
    iterations), each on its own package's tables."""
    llr = _llr(code, noise)
    mt = minsum_tables(code, use_qc=use_qc)
    ours = layered_minsum_decode(mt, torch.from_numpy(llr), 50)
    ref = _jax_decode(jax_minsum.minsum_tables(code, use_qc=use_qc), llr, 50, 0.75)
    return mt, ours, ref


def _assert_equal_to_jax(ours, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(
        ours.soft_syndrome.numpy(), np.asarray(ref.soft_syndrome), rtol=1e-6, atol=0
    )


@pytest.mark.parametrize("noise", [2.2, 2.6, 3.0, 3.6])
def test_qc_path_matches_jax(g5, noise):
    """5G, B = 32: hard outputs, iterations and convergence equal to JAX's,
    soft syndromes within rtol 1e-6.  All codewords converge at 2.2-3.0
    (in 3-7 iterations); at 3.6, 14 of 32 never do."""
    mt, ours, ref = _both(g5, noise)
    assert mt.qc is not None
    _assert_equal_to_jax(ours, ref)
    if noise == 3.6:
        assert 0 < int(ours.converged.sum()) < 32


@pytest.mark.parametrize(
    "code_fixture,noise", [("g5", 3.6), ("peg", 2.6), ("peg", 3.4)],
    ids=["5g-no-qc", "peg-2.6", "peg-3.4"],
)
def test_generic_path_matches_jax(request, code_fixture, noise):
    """The generic path: the 5G code in its 12 block-row layers without the
    QC path, and PEG2304's one whole-matrix layer, where each column takes
    three updates a layer, added in flat (row, slot) order.  Adding them in
    reverse order moves the PEG2304 soft syndromes beyond rtol 1e-6, so
    the check holds the order."""
    mt, ours, ref = _both(request.getfixturevalue(code_fixture), noise, use_qc=False)
    assert mt.qc is None
    assert mt.add_pos.shape[1] == (1 if code_fixture == "g5" else 3)
    _assert_equal_to_jax(ours, ref)


def test_qc_path_equals_generic_path(g5):
    """Both paths on the same 5G LLRs: every output bitwise equal."""
    llr = torch.from_numpy(_llr(g5, 3.6))
    qc = layered_minsum_decode(minsum_tables(g5), llr, 50)
    generic = layered_minsum_decode(minsum_tables(g5, use_qc=False), llr, 50)
    for a, b in zip(qc, generic):
        assert torch.equal(a, b)


def test_two_phase_generic_equals_single_phase(g5):
    """phase1_iters = 6, tile = 16, B = 48: every output bitwise equal to the
    single-phase decode, over several phase-2 tiles."""
    llr = torch.from_numpy(_llr(g5, 3.6, b=48))
    mt = minsum_tables(g5)

    def decode(x, it):
        return layered_minsum_decode(mt, x, it)

    r1 = decode(llr, 50)
    r2 = two_phase_generic(decode, llr, 50, phase1_iters=6, tile=16)
    assert int((r1.iters > 6).sum()) > 16  # at least two tiles
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


def _layered_oracle(code, llr_cols, layers, iter_count, alpha=0.75):
    """Float64 layered normalised min-sum of one codeword.  Every row of a
    layer reads the posteriors as the layer found them; then the layer's
    updates are added.  Outputs freeze as the decoder's do: the soft
    syndrome of the iteration that converges is not kept.
    Returns (cc_hat, converged, iters, soft_syndrome)."""
    rows = [code.row_edge_col[r][code.row_mask[r]] for r in range(code.num_row)]
    post = llr_cols.astype(np.float64)
    c2v = [np.zeros(len(cols)) for cols in rows]
    ss = np.ones(code.num_row)
    for it in range(1, iter_count + 1):
        ss_new = np.empty(code.num_row)
        for layer in layers:
            deltas = []
            for r in layer:
                v2c = post[rows[r]] - c2v[r]
                mag, sgn = np.abs(v2c), np.where(v2c < 0, -1.0, 1.0)
                k = int(np.argmin(mag))
                excl = np.full(mag.shape, mag[k])
                excl[k] = np.delete(mag, k).min(initial=np.inf)
                new = alpha * np.prod(sgn) * sgn * np.minimum(excl, constants.LLR_CLIP)
                deltas.append(new - c2v[r])
                c2v[r] = new
                ss_new[r] = 1.0 / (1.0 + np.exp(-np.prod(sgn) * mag[k]))
            for r, d in zip(layer, deltas):
                post[rows[r]] += d
        cc_hat = (post <= 0).astype(np.int8)
        if all(cc_hat[cols].sum() % 2 == 0 for cols in rows):
            return cc_hat, True, it, ss
        ss = ss_new
    return cc_hat, False, iter_count, ss


@pytest.mark.parametrize("code_fixture", ["g5", "peg"])
def test_matches_float64_oracle(request, code_fixture):
    """The codeword that converges last in a B = 32 batch at noise 3.0 (5G:
    QC path, 7 iterations; PEG2304: the generic whole-matrix layer, 11)
    against a float64 layered min-sum: hard decisions and iterations equal,
    soft syndromes within rtol 1e-5 (measured: 2.1e-6 and 1.8e-6; float32
    drift grows with the iterations, to 1e-3 after 17 on the 5G code)."""
    code = request.getfixturevalue(code_fixture)
    llr = _llr(code, 3.0)
    mt = minsum_tables(code)
    res = layered_minsum_decode(mt, torch.from_numpy(llr), 50)
    i = int(np.argmax(np.where(res.converged.numpy(), res.iters.numpy(), -1)))
    assert res.converged[i] and int(res.iters[i]) >= 7
    if mt.qc is not None:
        z = mt.qc[0][0]
        layers = [range(l * z, (l + 1) * z) for l in range(code.num_row // z)]
    else:
        layers = [range(code.num_row)]
    llr_cols = channel_llr_to_columns(mt.base, torch.from_numpy(llr[i : i + 1]))[0].numpy()
    cc_exp, conv_exp, iters_exp, ss_exp = _layered_oracle(code, llr_cols, layers, 50)
    assert conv_exp and iters_exp == int(res.iters[i])
    np.testing.assert_array_equal(res.cc_hat[i].numpy(), cc_exp)
    np.testing.assert_allclose(res.soft_syndrome[i].numpy(), ss_exp, rtol=1e-5, atol=0)


def test_tables_match_jax(g5, peg):
    """The QC structure of the 5G code and the generic layer tables (5G in
    Z-row layers, PEG2304 in one layer) equal the JAX package's."""
    ours, ref = minsum_tables(g5), jax_minsum.minsum_tables(g5)
    assert ours.qc == ref.qc and len(ours.qc) == 1 + g5.num_row // g5.lifting_factor
    assert ours.l_edge_col.shape == (0, 0, 0) and ours.add_pos.shape[:2] == (0, 0)
    for code in (g5, peg):
        ours = minsum_tables(code, use_qc=False)
        ref = jax_minsum.minsum_tables(code, use_qc=False)
        assert ours.qc is None and ref.qc is None
        for f in ("l_edge_idx", "l_edge_col", "l_mask"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)


def test_from_jax_params_carries_layered_tables(g5, assets):
    """from_jax_params takes the JAX package's layered tables across: the
    same tables as the port builds, and None for a flooding schedule."""
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    kw = dict(code=g5, constellation=const, known_h=True, fading=True, metric_type=False,
              metric_iter=5, max_iter=50, encoder_active=True, histogram=False)
    for schedule in ("layered-minsum", "flooding"):
        jparams = jchain.make_chain_params(jchain.ChainSpec(**kw, schedule=schedule))
        got = from_jax_params(jax.tree.map(np.asarray, jparams)).ms
        want = make_chain_params(g5, schedule=schedule).ms
        if schedule == "flooding":
            assert got is None and want is None
            continue
        assert got.qc == want.qc
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if f.name == "base":
                assert all(torch.equal(getattr(a, g.name), getattr(b, g.name))
                           if torch.is_tensor(getattr(b, g.name))
                           else getattr(a, g.name) == getattr(b, g.name)
                           for g in dataclasses.fields(b))
            elif f.name == "qc_cols":
                assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
            elif torch.is_tensor(b):
                assert torch.equal(a, b), f.name


def test_standalone_decoder_recovers_noiseless_words(g5, peg):
    """The layered decoder at each code's default tables (5G: QC path,
    PEG2304: generic): noiseless LLRs of random codewords decode to their
    info bits in one iteration."""
    rng = np.random.default_rng(0)
    for code in (g5, peg):
        mt = minsum_tables(code)
        uu = rng.integers(0, 2, size=(4, code.code_dim)).astype(np.uint8)
        cc = np.stack([code.encode_reference(u) for u in uu])[:, code.punct:]
        llr = torch.from_numpy(np.where(cc == 0, 12.0, -12.0).astype(np.float32))
        res = layered_minsum_decode(mt, llr, 20)
        np.testing.assert_array_equal(res.uu_hat.numpy(), uu)
        assert bool(res.converged.all()) and res.iters.tolist() == [1] * 4
        assert res.cc_hat.shape == (4, code.num_col)
