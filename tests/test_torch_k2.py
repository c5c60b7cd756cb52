"""Kernel K2's host side on the CPU (``decoder/bp_cuda.py``): where it
engages, its shared-memory reckoning, the wrapper's checks, the two-phase
schedule's one whole-batch call of a per-codeword decoder, the chain's
where K2 engages, and the counters the harness keeps for it.  K2 itself
runs only on a card (``tests/test_torch_cuda.py``)."""

import dataclasses
import types

import pytest
import torch

from kmldpc_torch.code import load_code
from kmldpc_torch.decoder import DecoderTables, bp_cuda, bp_em
from kmldpc_torch.decoder.bp_em import (
    flooding_decode_em,
    flooding_decoder,
    fused_decode_engages,
    two_phase_generic,
)
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim import Simulator
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, build_frontend_fn
from kmldpc_torch.utils import trace

CARD = types.SimpleNamespace(device=torch.device("cuda", 0))  # LLRs as if on a card


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tabs(assets):
    return {name: DecoderTables.from_code(load_code(str(assets / f)), "cpu") for name, f in (
        ("peg2304", "PEG2304regular0.5.txt"), ("peg8064", "PEG8064regular0.5.txt"),
        ("5g", "5GLDPCBG2a3_R12_K960.txt"))}


@pytest.mark.parametrize("code,cn_rule,dtype,on_card,engages", [
    ("peg2304", "sumprod", torch.float32, True, True),
    ("peg8064", "sumprod", torch.float32, True, True),
    ("5g", "sumprod", torch.float32, True, True),
    ("peg2304", "minsum", torch.float32, True, False),
    ("peg2304", "sumprod", torch.bfloat16, True, False),
    ("peg2304", "sumprod", torch.float32, False, False),
], ids=["peg2304", "peg8064", "5g-irregular", "minsum", "bfloat16", "cpu-tensors"])
def test_k2_engages_only_on_regular_sumprod_float32_cuda(tabs, code, cn_rule, dtype, on_card,
                                                         engages):
    """K2 takes the regular codes and refuses the 5G code, which is
    irregular: there the predicate engages through K3 instead."""
    t = tabs[code]
    llr = CARD if on_card else torch.zeros((2, t.num_col - t.punct))
    assert fused_decode_engages(t, llr, cn_rule, dtype) is engages
    assert bp_cuda.fits(t) is t.is_regular and bp_cuda.fits_classes(t) is not t.is_regular


@pytest.mark.parametrize("change", [dict(dr=33), dict(num_col=40000, num_row=20000)],
                         ids=["row-degree", "shared-memory"])
def test_k2_refuses_a_code_that_does_not_fit(tabs, change):
    t = dataclasses.replace(tabs["peg2304"], **change)
    assert not bp_cuda.fits(t)
    assert not fused_decode_engages(t, CARD, "sumprod", torch.float32)


@pytest.mark.parametrize("code,smem,words", [("peg2304", 50688, 4), ("peg8064", 177408, 1)])
def test_k2_shared_memory_reckoning(tabs, code, smem, words):
    """c2v [dr * num_row], posteriors and LLRs [num_col] each, soft syndrome
    [num_row], float32: of an SM's 228 KB, less 1 KB the runtime keeps for
    each resident block, four PEG2304 codewords, one PEG8064."""
    t = tabs[code]
    assert t.dr * t.num_row == t.dc * t.num_col == t.num_edges
    assert bp_cuda.smem_bytes(t) == smem == 4 * (t.num_edges + 2 * t.num_col + t.num_row)
    assert smem <= bp_cuda.SMEM_PER_BLOCK and bp_cuda.fits(t)
    assert 228 * 1024 // (smem + 1024) == words


def test_k2_tables_are_int32_copies(tabs):
    for t in tabs.values():
        assert t.perm_sm_c2r32.dtype == t.row_col_sm32.dtype == torch.int32
        assert torch.equal(t.perm_sm_c2r32.long(), t.perm_sm_c2r)
        assert torch.equal(t.row_col_sm32.long(), t.row_col_sm)


@pytest.mark.parametrize("llr,error", [
    (torch.zeros((4, 2304), dtype=torch.float64), TypeError),
    (torch.zeros((4, 2303)), ValueError),
    (torch.zeros((2304,)), ValueError),
    (torch.zeros((4, 2304)), ValueError),
], ids=["dtype", "shape", "rank", "device"])
def test_k2_wrapper_raises_before_loading_the_library(tabs, monkeypatch, llr, error):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(bp_cuda, "load_library", no_load)
    before = bp_cuda.launch_k2.launches
    with pytest.raises(error):
        bp_cuda.launch_k2(tabs["peg2304"], llr, 50)
    assert bp_cuda.launch_k2.launches == before


def _plain_kernels(monkeypatch, engaged: bool) -> list:
    """The decoder's one predicate answering ``engaged``, with the plain
    core standing in for K2 and K3; returns the list into which every core
    decode puts its (rows, iterations)."""
    calls = []
    core = bp_em._decode_cols

    def plain(t, llr_col, it, *args):
        calls.append((llr_col.shape[1], it))
        return core(t, llr_col, it, *args)

    def kernel(t, llr, it):
        return bp_em._batch_major(plain(t, bp_em._insert_punct(t, llr.T.contiguous()), it))

    monkeypatch.setattr(bp_em, "_decode_cols", plain)
    monkeypatch.setattr(bp_em, "fused_decode_engages", lambda *a: engaged)
    monkeypatch.setattr(bp_cuda, "launch_k2", kernel)
    monkeypatch.setattr(bp_cuda, "launch_k3", kernel)
    return calls


@pytest.mark.parametrize("per_codeword", [True, False], ids=["per-codeword", "eager"])
def test_two_phase_calls_a_per_codeword_decoder_once(tabs, per_codeword):
    """A decoder that runs each codeword to its own convergence gets one
    call of the whole batch with the whole budget; an eager one (the
    flooding decoder of CPU LLRs) phase 1 and tiles of B/8.  The results
    are the decoder's own on the whole batch either way."""
    t = tabs["peg2304"]
    b = 64
    gen = torch.Generator().manual_seed(3)
    llr = 2.5 * (1.0 + 0.8 * torch.randn((b, t.num_col - t.punct), generator=gen))
    eager = flooding_decoder(t, llr)
    assert eager.per_codeword is False
    calls = []

    def decode(x, it):
        calls.append((x.shape[0], it))
        return eager(x, it)

    decode.per_codeword = per_codeword
    got = two_phase_generic(decode, llr, 50, phase1_iters=3, tile=b // 8)
    if per_codeword:
        assert calls == [(b, 50)]
    else:
        assert calls[0] == (b, 3) and len(calls) > 1
        assert all(call == (b // 8, 50) for call in calls[1:])
    for a, want in zip(got, flooding_decode_em(t, llr, 50)):
        assert torch.equal(a, want)


@pytest.mark.parametrize("engaged", [True, False], ids=["k2-whole-batch", "two-phase"])
def test_chain_hands_k2_the_whole_batch(assets, monkeypatch, engaged):
    """Where K2 engages the chain makes one decode call on the whole batch
    with the whole budget, else phase 1 and tiles of B/8, and reports the
    decoder's answer; the counters and results are the same either way."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=True, fading=True,
                     metric_type=False, metric_iter=5, max_iter=50, encoder_active=True)
    b = 64
    var = torch.tensor(10 ** -0.2, dtype=torch.float32)
    params = make_chain_params(code, "cpu")
    front = build_frontend_fn(spec, b, "cpu")(params, make_generator(5, "cpu"), var)
    want = build_backend_fn(spec, b, "cpu")(params, *front, var)
    calls = _plain_kernels(monkeypatch, engaged)
    got = build_backend_fn(spec, b, "cpu")(params, *front, var)
    if engaged:
        assert calls == [(b, 50)] and got.per_codeword is True
    else:
        assert calls[0] == (b, spec.phase1_iters) and len(calls) > 1
        assert all(call == (b // 8, 50) for call in calls[1:]) and got.per_codeword is False
    assert int(got.err_bit) == int(want.err_bit) and want.per_codeword is False
    for f, a in zip(want.raw._fields, want.raw):
        assert torch.equal(a, getattr(got.raw, f)), f


@pytest.mark.parametrize("per_codeword,ndata", [(False, 1), (True, 1), (True, 2)],
                         ids=["eager", "k2", "two-data-ranks"])
def test_harness_counts_k2_rows_as_run_at_consume(per_codeword, ndata):
    """K2 runs each codeword the iterations it needs: a launch whose final
    decode ran per codeword adds its needed iterations (this data rank's
    share) to the run count too, so the useful share reads 1.0 on a K2
    launch, and the reader of host syncs reads the zero K2 counts."""
    from linkbench.metrics import decode_syncs_per_launch, decode_useful_share

    trace.reset()
    harness = types.SimpleNamespace(grid=types.SimpleNamespace(ndata=ndata))
    Simulator._count_launch(harness, 3.5, 16, per_codeword)
    counts = trace.snapshot()
    assert counts["decode.cw_iters_needed"] == 56 // ndata
    assert counts.get("decode.cw_iters_run", 0) == (56 // ndata if per_codeword else 0)
    trace.count("syncs", 0, stage="decode")
    if per_codeword:
        assert decode_useful_share.read(None, None) == 1.0
    assert decode_syncs_per_launch.read(None, None) == 0.0
    trace.reset()
