"""Kernel K3's host side on the CPU (``decoder/bp_cuda.py``): where it
engages, its shared-memory reckoning, its int32 class tables, the wrapper's
checks, the chain's one whole-batch call where it engages, and the counters
the harness keeps for it.  K3 itself runs only on a card
(``tests/test_torch_cuda.py``)."""

import dataclasses
import types

import pytest
import torch

from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.decoder import DecoderTables, bp_cuda, bp_em
from kmldpc_torch.decoder.bp_em import fused_decode_engages
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim import Simulator
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, build_frontend_fn
from kmldpc_torch.utils import SimLogger, trace

from .test_torch_k2 import _plain_kernels

CARD = types.SimpleNamespace(device=torch.device("cuda", 0))  # LLRs as if on a card
G5 = "5GLDPCBG2a3_R12_K960.txt"
SWEEP3 = "benchmarks/parity/configs/sweep3_known_5g16qam.toml"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g5(assets):
    return load_code(str(assets / G5))


@pytest.fixture(scope="module")
def t5(g5):
    return DecoderTables.from_code(g5, "cpu")


@pytest.mark.parametrize("cn_rule,dtype,on_card,engages", [
    ("sumprod", torch.float32, True, True),
    ("minsum", torch.float32, True, False),
    ("sumprod", torch.bfloat16, True, False),
    ("sumprod", torch.float32, False, False),
], ids=["sumprod-float32-card", "minsum", "bfloat16", "cpu-tensors"])
def test_k3_engages_only_on_sumprod_float32_cuda(t5, cn_rule, dtype, on_card, engages):
    llr = CARD if on_card else torch.zeros((2, t5.num_col - t5.punct))
    assert bp_cuda.fits_classes(t5) and not bp_cuda.fits(t5)
    assert fused_decode_engages(t5, llr, cn_rule, dtype) is engages


def test_k3_refuses_a_regular_code(assets):
    t = DecoderTables.from_code(load_code(str(assets / "PEG2304regular0.5.txt")), "cpu")
    assert not bp_cuda.fits_classes(t) and bp_cuda.fits(t)


@pytest.mark.parametrize("change", [
    dict(row_classes=((4, 192), (5, 288), (6, 288), (8, 192), (33, 192))),
    dict(num_edges=60000),
    dict(col_classes=tuple((d, 132) for d in range(1, 17)) + ((17, 0),)),
], ids=["row-degree-33", "shared-memory", "classes"])
def test_k3_refuses_a_code_that_does_not_fit(t5, change):
    t = dataclasses.replace(t5, **change)
    assert not bp_cuda.fits_classes(t)
    assert not fused_decode_engages(t, CARD, "sumprod", torch.float32)


def test_k3_shared_memory_reckoning(t5):
    """c2v [num_edges], posteriors and LLRs [num_col] each, soft syndrome
    [num_row], float32, beside the two sides' class descriptors: of an SM's
    228 KB, less 1 KB the runtime keeps for each resident block, four 5G
    codewords."""
    assert (t5.num_col, t5.num_row, t5.num_edges, t5.punct) == (2112, 1152, 7392, 192)
    assert len(t5.col_classes) == 7 and len(t5.row_classes) == 5
    smem = bp_cuda.smem_bytes(t5)
    assert smem == 51072 == 4 * (t5.num_edges + 2 * t5.num_col + t5.num_row)
    assert smem + bp_cuda.CLASS_SMEM_BYTES <= bp_cuda.SMEM_PER_BLOCK
    assert 228 * 1024 // (smem + bp_cuda.CLASS_SMEM_BYTES + 1024) == 4


def test_k3_class_boundaries_fall_on_warps(t5):
    """Every class boundary of BG2 Z = 96 is a multiple of 32 on both
    sides, so no warp of K3 straddles two degrees."""
    for classes in (t5.col_classes, t5.row_classes):
        assert all(n % 32 == 0 for _, n in classes)
        assert [d for d, _ in classes] == sorted({d for d, _ in classes})


def test_k3_tables_are_int32_copies(t5):
    for f in ("perm_cf_c2r", "row_col_cf", "col_sort", "col_unsort", "row_unsort"):
        t32 = getattr(t5, f + "32")
        assert t32.dtype == torch.int32 and torch.equal(t32.long(), getattr(t5, f)), f


def test_k3_class_arguments(t5):
    """The host arrays K3's entry point takes: each side's degrees, node
    counts and number of classes."""
    cdeg, ccnt, ncols, rdeg, rcnt, nrows = bp_cuda.class_args(t5)
    assert (list(cdeg), list(ccnt), ncols) == (
        [d for d, _ in t5.col_classes], [n for _, n in t5.col_classes], 7)
    assert (list(rdeg), list(rcnt), nrows) == (
        [d for d, _ in t5.row_classes], [n for _, n in t5.row_classes], 5)
    assert sum(ccnt) == t5.num_col and sum(rcnt) == t5.num_row
    assert sum(d * n for d, n in zip(cdeg, ccnt)) == sum(d * n for d, n in zip(rdeg, rcnt))


@pytest.mark.parametrize("llr,error", [
    (torch.zeros((4, 1920), dtype=torch.float64), TypeError),
    (torch.zeros((4, 2112)), ValueError),
    (torch.zeros((1920,)), ValueError),
    (torch.zeros((4, 1920)), ValueError),
], ids=["dtype", "shape", "rank", "device"])
def test_k3_wrapper_raises_before_loading_the_library(t5, monkeypatch, llr, error):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(bp_cuda, "load_library", no_load)
    before = bp_cuda.launch_k3.launches
    with pytest.raises(error):
        bp_cuda.launch_k3(t5, llr, 50)
    assert bp_cuda.launch_k3.launches == before


@pytest.mark.parametrize("known_h", [True, False], ids=["known", "blind"])
@pytest.mark.parametrize("engaged", [True, False], ids=["k3-whole-batch", "two-phase"])
def test_chain_hands_k3_the_whole_batch(assets, g5, monkeypatch, engaged, known_h):
    """Where K3 engages the 5G chain makes one final decode call on the
    whole batch with the whole budget, else phase 1 and tiles of B/8, and
    reports the decoder's answer; a blind chain's soft metric decodes its
    4B candidate rows in one call of ``metric_iter`` either way; counters
    and results are the same."""
    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    spec = ChainSpec(code=g5, constellation=const, known_h=known_h, fading=True,
                     metric_type=True, metric_iter=5, max_iter=50, encoder_active=True)
    b = 64
    var = torch.tensor(10 ** -1.4, dtype=torch.float32)
    params = make_chain_params(g5, "cpu")
    front = build_frontend_fn(spec, b, "cpu")(params, make_generator(7, "cpu"), var)
    want = build_backend_fn(spec, b, "cpu")(params, *front, var)
    calls = _plain_kernels(monkeypatch, engaged)
    got = build_backend_fn(spec, b, "cpu")(params, *front, var)
    soft = [] if known_h else [(4 * b, 5)]
    assert calls[:len(soft)] == soft
    final = calls[len(soft):]
    if engaged:
        assert final == [(b, 50)] and got.per_codeword is True
    else:
        assert final[0] == (b, spec.phase1_iters) and got.per_codeword is False
        assert len(final) > 1 and all(call == (b // 8, 50) for call in final[1:])
    assert int(got.err_bit) == int(want.err_bit) and want.per_codeword is False
    assert torch.equal(got.metrics, want.metrics)
    for f, a in zip(want.raw._fields, want.raw):
        assert torch.equal(a, getattr(got.raw, f)), f


def test_harness_counts_k3_rows_at_consume(assets, monkeypatch):
    """A cut of sweep 3 (known-h 5G 16QAM, folded) with K3 standing in:
    every final decode is one launch of the whole batch, counted under
    ``decode.fused_rows`` with no host sync, and the harness counts those
    rows' needed iterations as run at consume, so the useful share reads
    1.0.  The stand-in decodes with the plain core under a label of its
    own, so that its loop's counts stay out of ``decode``."""
    from linkbench.metrics import decode_syncs_per_launch, decode_useful_share

    def k3(t, llr, it):
        with trace.label("plain"):
            res = bp_em._batch_major(bp_em._decode_cols(t, bp_em._insert_punct(t, llr.T), it))
        k3.rows += llr.shape[0]
        return bp_cuda._result(t, (res.cc_hat, res.converged, res.iters, res.soft_syndrome))

    k3.rows = 0
    monkeypatch.setattr(bp_em, "fused_decode_engages", lambda *a: True)
    monkeypatch.setattr(bp_cuda, "launch_k3", k3)
    cfg = load_config(str(assets.parent / SWEEP3))
    cfg = dataclasses.replace(
        cfg, range=dataclasses.replace(cfg.range, minimum_snr=12.0, maximum_snr=15.0,
                                       maximum_block_number=64),
        tpu=dataclasses.replace(cfg.tpu, batch=32, chunks_per_launch=1))
    trace.reset()
    results = Simulator(cfg, SimLogger(log_dir=None, stdout=False), device="cpu").simulate()
    counts = trace.snapshot()
    blocks = sum(r.tot_blk for r in results)
    assert len(results) == 2 and blocks == 128
    assert k3.rows == counts["decode.fused_rows"] >= blocks
    assert counts["decode.syncs"] == 0 and "decode.exit_check" not in counts
    assert counts["decode.cw_iters_run"] == counts["decode.cw_iters_needed"] > 0
    assert decode_useful_share.read(None, None) == 1.0
    assert decode_syncs_per_launch.read(None, None) == 0.0
    trace.reset()
