"""Kernel K4, the soft demapper in registers (``ops/demap_cuda.py``,
``csrc/demap.cu``).

On the CPU: the wrapper's refusals before it loads the library, the plain
version's candidate folding (bitwise the candidate-expanded rows), and the
chain's unexpanded hand-over with the counter ``demap.fused_rows``.  On a
card (marked ``cuda``, skipped where torch.cuda.is_available() is False): K4
bitwise the plain version, both against a float64 demap, at each cell's
symbols a codeword and SNR range, the complement property, repeatability
and the refusal of an unsupported table.  This file imports no jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kmldpc_torch.code import load_code
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import ModemTables, demap_cuda, make_generator, modem
from kmldpc_torch.ops.modem import make_plain_soft_demapper, make_soft_demapper
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim.chain import ChainSpec, build_backend_fn, build_frontend_fn
from kmldpc_torch.utils import trace

from .test_torch_cuda import llr_float64

# (table, symbols a codeword, the SNR range of its cells in dB)
LINKS = [("2bits_QPSK.txt", 1152, (5.0, 20.0)),  # peg2304-qpsk.blind
         ("4bit_16QAM_Gray.txt", 480, (12.0, 24.0)),  # nr-bg2-16qam.known and .blind
         ("6bits_64QAM_Gray.txt", 1344, (17.5, 25.0)),  # peg8064-64qam.blind
         ("8bits_256QAM_Gray.txt", 1008, (22.5, 32.5))]  # peg8064-256qam.blind
LLR_MARGIN = 1.10  # tests/test_torch_rounding.py's margin on |LLR - float64|
SHIPPED = ["2bits_QPSK.txt", "2bits_4PSK.txt", "4bit_16QAM_Gray.txt", "4bit_16QAM_phi1.txt",
           "4bit_16QAM_phi2.txt", "6bits_64QAM_Gray.txt", "8bits_256QAM_Gray.txt"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _link(const, b, nsym, nc, snr_db, seed):
    """Received symbols [B, Nsym] of a Rayleigh block-fading link and nc
    gain candidates a codeword [B, nc], float32 NumPy: the true gain, off
    by a little, times 1, j, -1, -j, as the blind estimate's four."""
    rng = np.random.default_rng(seed)
    var = np.float32(10.0 ** (-snr_db / 10))
    h = (rng.normal(size=(b, 1)) + 1j * rng.normal(size=(b, 1))) * np.sqrt(0.5)
    s = const.points[rng.integers(0, const.num_points, size=(b, nsym))]
    w = (rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))) * np.sqrt(var / 2)
    y = h * s + w
    h_est = h * (1 + 0.02 * (rng.normal(size=(b, 1)) + 1j * rng.normal(size=(b, 1))))
    h4 = h_est * np.array([1, 1j, -1, -1j])[None, :nc]
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    return f32(y.real), f32(y.imag), f32(h4.real), f32(h4.imag), var


def _expanded(yr, yi, hr, hi):
    """The candidate-expanded rows the selector used to build: codeword b
    under candidate c at row b * nc + c."""
    b, nsym = yr.shape
    nc = hr.shape[1]
    return (yr[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym),
            yi[:, None, :].expand(b, nc, nsym).reshape(b * nc, nsym),
            hr.reshape(b * nc), hi.reshape(b * nc))


# --- on the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("fname", SHIPPED)
def test_every_shipped_table_takes_k4(assets, fname):
    tables = ModemTables.from_constellation(parse_constellation(str(assets / fname)))
    table = demap_cuda.K4Table.read(tables.points_re, tables.points_im, tables.bit0_mask)
    assert table.refusal is None
    assert table.points_re.dtype == np.float32 and table.points_re.shape == (tables.num_points,)


def _eight_psk() -> ModemTables:
    """An 8-point table, which K4 is not instantiated for."""
    k = np.arange(8)
    bits = (k[:, None] >> np.arange(2, -1, -1)) & 1
    pts = np.exp(2j * np.pi * k / 8)
    return ModemTables(3, torch.tensor(pts.real, dtype=torch.float32),
                       torch.tensor(pts.imag, dtype=torch.float32),
                       torch.tensor(bits == 0, dtype=torch.float32),
                       torch.tensor([4.0, 2.0, 1.0]))


@pytest.mark.parametrize("case,error", [
    ("cpu", ValueError), ("mixed", ValueError), ("meta", ValueError),
    ("8-points", ValueError), ("labels", ValueError),
], ids=["cpu", "mixed", "meta", "8-points", "labels"])
def test_k4_wrapper_raises_before_loading_the_library(assets, monkeypatch, case, error):
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(demap_cuda, "load_library", no_load)
    tables = ModemTables.from_constellation(parse_constellation(str(assets / "2bits_QPSK.txt")))
    if case == "8-points":
        tables = _eight_psk()
    elif case == "labels":  # points 0 and 1 swap places, their labels do not
        tables = dataclasses.replace(tables, bit0_mask=tables.bit0_mask[[1, 0, 2, 3]])
    table = demap_cuda.K4Table.read(tables.points_re, tables.points_im, tables.bit0_mask)
    dev = "meta" if case == "meta" else "cpu"
    yr, yi = torch.zeros((4, 8), device=dev), torch.zeros((4, 8), device=dev)
    h_dev = "meta" if case == "mixed" else dev
    hr, hi = torch.ones((4, 4), device=h_dev), torch.zeros((4, 4), device=h_dev)
    before = demap_cuda.launch_k4.launches
    with pytest.raises(error, match="K4"):
        demap_cuda.launch_k4(table, yr, yi, hr, hi, 0.1)
    if case in ("mixed", "meta", "8-points"):  # off the CPU the demapper launches K4 or raises
        if case == "8-points":
            yr, yi, hr, hi = (t.to("meta") for t in (yr, yi, hr, hi))
        with pytest.raises(error, match="K4"):
            make_soft_demapper(tables)(yr, yi, hr, hi, 0.1)
    assert demap_cuda.launch_k4.launches == before


@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("fname,nsym,snrs", LINKS, ids=["qpsk", "16qam", "64qam", "256qam"])
def test_plain_folds_candidates_bitwise(assets, fname, nsym, snrs, nc):
    """The plain version on [B, Nsym] symbols with [B, nc] gains gives,
    bitwise, the rows of the candidate-expanded call the selector made
    before K4 (a slice of [B, 4] candidates, as the selector passes); on
    CPU tensors the chain's demapper is the plain version."""
    const = parse_constellation(str(assets / fname))
    tables = ModemTables.from_constellation(const)
    yr, yi, h4r, h4i, var = map(torch.as_tensor, _link(const, 5, nsym // 8, 4, snrs[0], 3))
    hr, hi = h4r[:, :nc], h4i[:, :nc]
    plain = make_plain_soft_demapper(tables)
    want = plain(*_expanded(yr, yi, hr, hi), var)
    for got in (plain(yr, yi, hr, hi, var), make_soft_demapper(tables)(yr, yi, hr, hi, var)):
        for a, w in zip(got, want):
            assert a.shape == (5 * nc, nsym // 8 * const.bits_per_symbol)
            assert torch.equal(a, w)


def _k4_stand_in(tables, calls):
    """K4 as the chain would launch it, on the CPU: the plain version on the
    operands K4 gets, counted as K4 counts."""
    plain = make_plain_soft_demapper(tables)

    def k4(table, yr, yi, hr, hi, var):
        calls.append((tuple(yr.shape), tuple(hr.shape)))
        return demap_cuda._counted(*plain(yr, yi, hr, hi, var))

    return k4


@pytest.mark.parametrize("mode", ["blind", "blind-prune", "known", "histogram"])
def test_chain_hands_k4_the_unexpanded_symbols(assets, monkeypatch, mode):
    """Where K4 engages, the selector hands the demapper each codeword's
    symbols once, [B, Nsym], with its nc candidates [B, nc] (4, or 2 with
    the complement pruning; 4 copies of the true gain in histogram mode),
    and the known-h back end its symbols with one gain a codeword; the
    counter ``demap.fused_rows`` counts the rows demapped under the label
    the host is in; counters and results are those of the plain chain."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=mode in ("known", "histogram"),
                     fading=True, metric_type=False, metric_iter=5, max_iter=20,
                     encoder_active=True, metric_prune=mode == "blind-prune",
                     histogram=mode == "histogram")
    b, nsym = 16, 1152
    var = torch.tensor(10 ** -1.0, dtype=torch.float32)
    params = make_chain_params(code, "cpu")
    front = build_frontend_fn(spec, b, "cpu")(params, make_generator(11, "cpu"), var)
    want = build_backend_fn(spec, b, "cpu")(params, *front, var)
    calls = []
    monkeypatch.setattr(modem, "k4_engages", lambda *t: True)
    monkeypatch.setattr(modem, "launch_k4", _k4_stand_in(ModemTables.from_constellation(const),
                                                         calls))
    trace.reset()
    got = build_backend_fn(spec, b, "cpu")(params, *front, var)
    counts = trace.snapshot()
    nc = {"blind": 4, "blind-prune": 2, "known": None, "histogram": 4}[mode]
    assert calls == [((b, nsym), (b,) if nc is None else (b, nc))]
    key = "demap.demap.fused_rows" if mode == "known" else "metric.demap.fused_rows"
    assert counts[key] == b * (nc or 1)
    assert int(got.err_bit) == int(want.err_bit) and int(got.err_blk) == int(want.err_blk)
    torch.testing.assert_close(got.metrics, want.metrics, rtol=0, atol=0, equal_nan=True)
    if mode != "histogram":
        for f, a in zip(want.raw._fields, want.raw):
            assert torch.equal(a, getattr(got.raw, f)), f


# --- on a card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [7, 133])
@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("fname,nsym,snrs", LINKS, ids=["qpsk", "16qam", "64qam", "256qam"])
def test_k4_against_plain_and_float64(assets, cuda, fname, nsym, snrs, nc, b):
    """K4 and the plain version on the card, each against a float64 demap,
    at both ends of the cells' SNR range: K4's worst and mean |LLR error|
    within LLR_MARGIN of the plain version's, the same hard decisions
    wherever the float64 |LLR| exceeds 1e-4, and P(bit=0) in its clip."""
    const = parse_constellation(str(assets / fname))
    tables = ModemTables.from_constellation(const, cuda)
    k4, plain = make_soft_demapper(tables), make_plain_soft_demapper(tables)
    for i, snr in enumerate(snrs):
        host = _link(const, b, nsym, nc, snr, 100 * b + 10 * nc + i)
        yr, yi, hr, hi = (torch.from_numpy(a).to(cuda) for a in host[:4])
        var = torch.tensor(host[4], device=cuda)
        before = demap_cuda.launch_k4.launches
        p0_k, llr_k = k4(yr, yi, hr, hi, var)
        assert demap_cuda.launch_k4.launches == before + 1
        p0_p, llr_p = plain(yr, yi, hr, hi, var)
        ref = llr_float64(*(t.numpy() for t in _expanded(*map(torch.from_numpy, host[:4]))),
                          host[4], const.points, const.bit0_mask())
        e_k = np.abs(llr_k.cpu().numpy().astype(np.float64) - ref)
        e_p = np.abs(llr_p.cpu().numpy().astype(np.float64) - ref)
        assert e_k.max() <= LLR_MARGIN * e_p.max(), (snr, e_k.max(), e_p.max())
        assert e_k.mean() <= LLR_MARGIN * e_p.mean(), (snr, e_k.mean(), e_p.mean())
        sure = np.abs(ref) > 1e-4
        d_k, d_p = (p0_k > 0.5).cpu().numpy(), (p0_p > 0.5).cpu().numpy()
        assert np.array_equal(d_k[sure], d_p[sure])
        p0 = p0_k.cpu().numpy()
        assert p0.min() >= np.float32(1e-12) and p0.max() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("fname,nsym,snrs", LINKS, ids=["qpsk", "16qam", "64qam", "256qam"])
def test_k4_is_bitwise_the_plain_version_on_card(assets, cuda, fname, nsym, snrs, nc):
    """K4 sums in the order PyTorch's CUDA reductions take over the plain
    version's tensors, and rounds every other step as it does, so on the
    card the two give the same bits, at each cell's B and both ends of its
    SNR range (B = 512 here)."""
    const = parse_constellation(str(assets / fname))
    tables = ModemTables.from_constellation(const, cuda)
    k4, plain = make_soft_demapper(tables), make_plain_soft_demapper(tables)
    for i, snr in enumerate(snrs):
        host = _link(const, 512, nsym, nc, snr, 7 * nc + i)
        args = [torch.from_numpy(a).to(cuda) for a in host[:4]]
        var = torch.tensor(host[4], device=cuda)
        got, want = k4(*args, var), plain(*args, var)
        for name, a, w in zip(("bit_p0", "chan_llr"), got, want):
            apart = int((a != w).sum())
            assert apart == 0, (snr, name, apart, float((a - w).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("snr_db", [5.0, 12.5, 20.0])
def test_k4_complements_decisions_under_negated_gain(assets, cuda, snr_db):
    """On the complement-closed QPSK table, the candidates h and -h give
    exactly complementary decisions (what detect/metric.py's pruning of
    candidates 2 and 3 rests on), at PEG2304's 1,152 symbols."""
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    tables = ModemTables.from_constellation(const, cuda)
    yr, yi, hr, hi, var = _link(const, 133, 1152, 1, snr_db, 5)
    h = np.concatenate([hr, -hr], axis=1), np.concatenate([hi, -hi], axis=1)
    args = [torch.from_numpy(a).to(cuda) for a in (yr, yi, *h)]
    p0, _ = make_soft_demapper(tables)(*args, float(var))
    d = (p0 > 0.5).reshape(133, 2, -1)
    assert torch.equal(d[:, 0], ~d[:, 1])


@pytest.mark.cuda
def test_k4_repeats_bitwise_without_a_sync(assets, cuda):
    """Two launches give the same bits; a launch with var on the card never
    synchronises, and a float var gives the same bits as a 0-d one."""
    const = parse_constellation(str(assets / "6bits_64QAM_Gray.txt"))
    tables = ModemTables.from_constellation(const, cuda)
    demap = make_soft_demapper(tables)
    host = _link(const, 133, 1344, 4, 20.0, 9)
    args = [torch.from_numpy(a).to(cuda) for a in host[:4]]
    var = torch.tensor(host[4], device=cuda)
    first = demap(*args, var)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = demap(*args, var)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b, c in zip(first, again, demap(*args, float(host[4]))):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_k4_refuses_an_unsupported_table_on_card(cuda):
    tables = _eight_psk()
    tables = ModemTables(3, *(t.to(cuda) for t in (tables.points_re, tables.points_im,
                                                  tables.bit0_mask, tables.pack_weights)))
    y = torch.zeros((2, 8), device=cuda)
    h = torch.ones((2, 4), device=cuda)
    with pytest.raises(ValueError, match="8-point"):
        make_soft_demapper(tables)(y, y, h, h, 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("b,nsym", [(1, 1008), (133, 1008), (133, 100)])
def test_k4_is_bitwise_the_plain_version_at_256_points(assets, cuda, b, nsym, nc):
    """At 256 points K4 makes three passes over the points and sums in the
    orders PyTorch's CUDA reductions take over the plain version's 256-point
    tensors, which differ from those at 4-64 points: the two give the same
    bits on B and Nsym that fill no whole block of K4, at both ends of the
    256QAM cell's grid."""
    const = parse_constellation(str(assets / "8bits_256QAM_Gray.txt"))
    tables = ModemTables.from_constellation(const, cuda)
    k4, plain = make_soft_demapper(tables), make_plain_soft_demapper(tables)
    for i, snr in enumerate((22.5, 32.5)):
        host = _link(const, b, nsym, nc, snr, 31 * b + nc + i)
        args = [torch.from_numpy(a).to(cuda) for a in host[:4]]
        if nc == 1:
            args[2], args[3] = args[2][:, 0], args[3][:, 0]
        var = torch.tensor(host[4], device=cuda)
        before = demap_cuda.launch_k4.launches
        got, want = k4(*args, var), plain(*args, var)
        assert demap_cuda.launch_k4.launches == before + 1
        for name, a, w in zip(("bit_p0", "chan_llr"), got, want):
            assert a.shape == (b * nc, nsym * 8)
            apart = int((a != w).sum())
            assert apart == 0, (snr, name, apart, float((a - w).abs().max()))
