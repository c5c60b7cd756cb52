"""The PEG8064 R = 1/2 64QAM Gray link of the benchmark cell
``peg8064-64qam.blind`` (PARITY.md sweep 5) on the CPU, against the
benchmark's plain reference (``linkbench/reference``) in float64: the code
and constellation tables, the front end, the plain k-means at 64 points,
and whole launches judged as a run judges them, at a batch of 8 on the
cell's own grid.  The blind estimate's row counter, ``kmeans.rows``, counts
a blind launch's rows and none with known h."""

import numpy as np
import pytest
import torch

from kmldpc_torch.code.ldpc import load_code as port_code
from kmldpc_torch.config import config_from_dict
from kmldpc_torch.detect.kmeans import blind_estimate
from kmldpc_torch.io.constellation import parse_constellation
from kmldpc_torch.ops import ModemTables
from kmldpc_torch.ops.source import make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn, make_chunk_runner
from kmldpc_torch.utils import trace
from linkbench import judge, spec
from linkbench.reference import chain as ref
from linkbench.reference.code import load_code, load_constellation
from linkbench.reference.draw import chunk_seed

CELL = "peg8064-64qam.blind"
BATCH = 8
SEED = 11
POINTS = spec.load_cell(CELL).points  # 17.5, 20, 22.5, 25 dB


def _setup(known_h: bool = False):
    over = {"range": {"maximum_block_number": BATCH}, "tpu": {"batch": BATCH}}
    if known_h:
        over["decoder"] = {"true_h_arg": True}
    cell = spec.load_cell(CELL, overrides=over)
    cfg = config_from_dict(cell.sweep_tables(SEED), asset_dir=str(spec.ASSETS))
    chain_spec = ChainSpec.from_config(cfg, port_code(cfg.matrix_path()),
                                       parse_constellation(cfg.modem_path()))
    link, g = judge.reference_link(cell, torch.float64, "cpu")
    return cell, chain_spec, link, g


def test_cell_is_sweep_5s_link_at_its_batch():
    cell, chain_spec, link, _ = _setup()
    assert POINTS == [17.5, 20.0, 22.5, 25.0] and cell.blind and not cell.folded
    code = link.code
    assert (code.num_row, code.num_col, code.info_bits, code.num_edges) == (4032, 8064, 4032,
                                                                            24192)
    assert link.const.points.size == 64 and code.tx_len // link.const.bits_per_symbol == 1344
    assert not chain_spec.metric_type and chain_spec.max_iter == 50
    full = spec.load_cell(CELL)
    assert (full.batch, full.subs, full.launches_per_point) == (4096, 1, 4)


def test_tables_are_the_ports():
    path = str(spec.ASSETS / "PEG8064regular0.5.txt")
    mine, port = load_code(path), port_code(path)
    assert (mine.num_row, mine.num_col, mine.info_bits, mine.punct, mine.info_start) == (
        port.num_row, port.num_col, port.code_dim, port.punct, port.info_slice.start)
    assert np.array_equal(mine.parity_gen, port.parity_gen)
    dense = np.zeros((mine.num_row, mine.num_col), dtype=np.uint8)
    for r in range(mine.num_row):
        dense[r, mine.row_cols[r][mine.row_mask[r]]] = 1
    assert np.array_equal(dense, port.dense_h())
    modem = str(spec.ASSETS / "6bits_64QAM_Gray.txt")
    mine_c, port_c = load_constellation(modem), parse_constellation(modem)
    assert mine_c.bits_per_symbol == port_c.bits_per_symbol == 6
    np.testing.assert_allclose(mine_c.points, port_c.points, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("snr", POINTS)
def test_front_end_is_the_references(snr):
    """The draws, the systematic encode, the map and the channel of a launch
    equal the reference's: bits exactly, the channel to float32 rounding."""
    cell, chain_spec, link, g = _setup()
    params = make_chain_params(chain_spec.code, "cpu", chain_spec.schedule)
    var = torch.tensor(10 ** (-0.1 * snr), dtype=torch.float32)
    frontend = build_frontend_fn(chain_spec, BATCH, "cpu")
    uu, yr, yi, hr, hi = frontend(params, make_generator(chunk_seed(SEED, snr, 2, 0), "cpu"),
                                  var)
    ruu, ryr, ryi, rhr, rhi, _ = ref.channel(link, g, SEED, snr, 2, 0)
    assert torch.equal(uu, ruu) and torch.equal(ref.launch_bits(link, SEED, snr, 2), uu)
    for a, b in ((yr, ryr), (yi, ryi), (hr, rhr), (hi, rhi)):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("snr", POINTS)
def test_plain_kmeans_is_the_references_at_64_points(snr):
    """The port's plain k-means (the CPU path and K1's plain version) on a
    launch's received rows, in float32, against the reference's in float64
    on the same rows: the same gain to float32 rounding of its sums."""
    _, chain_spec, link, g = _setup()
    _, yr, yi, _, _, _ = ref.channel(link, g, SEED, snr, 3, 0)
    yr32, yi32 = yr.float(), yi.float()
    tables = ModemTables.from_constellation(chain_spec.constellation, "cpu")
    h_r, h_i = blind_estimate(yr32, yi32, tables, 20, "max")
    r_r, r_i, passes = ref.kmeans(yr32.double(), yi32.double(), link.const)
    assert bool((passes <= ref.KMEANS_ITERS).all())
    torch.testing.assert_close(h_r.double(), r_r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(h_i.double(), r_i, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("snr", POINTS)
def test_launch_is_judged_correct(snr):
    """Every codeword of a launch at the cell's grid point, judged by
    ``judge.compare`` against the float64 reference: counters exact, no
    outcome apart, every compared number within the cell's ``[check]``."""
    cell, chain_spec, link, g = _setup()
    run = make_chunk_runner(chain_spec, BATCH, cell.subs, "cpu", seed=SEED)
    res = run(snr, 1, 10.0 ** (-0.1 * snr))
    kept = judge.Kept(res.err_bit, res.err_blk, torch.tensor(res.tot_blk), res.raw.uu_hat,
                      res.metrics, res.raw.uu_hat, res.raw.converged, res.raw.iters,
                      res.raw.soft_syndrome)
    rows = torch.arange(BATCH)
    pairs = [(kept, ref.launch_bits(link, SEED, snr, 1), ref.run_rows(link, g, SEED, snr, 1,
                                                                        rows))]
    numbers, bad = judge.compare(pairs, blind=True)
    assert bad == 0 and numbers["sampled_words"] == BATCH
    assert numbers["counter_gap"] == 0 and numbers["decode_gap"] == 0
    assert set(cell.limits) == {"counter_gap", "iters_gap", "decode_gap", "soft_gap",
                                "select_gap", "metric_gap"}
    for k, limit in cell.limits.items():
        assert numbers[k] <= limit, (k, numbers)


@pytest.mark.parametrize("known_h", [False, True], ids=["blind", "known-h"])
def test_kmeans_rows_counts_the_estimated_rows(known_h):
    """``kmeans.rows`` adds a blind launch's B rows, and nothing with known h."""
    cell, chain_spec, _, _ = _setup(known_h)
    run = make_chunk_runner(chain_spec, BATCH, cell.subs, "cpu", seed=SEED)
    trace.reset()
    try:
        run(25.0, 0, 10.0 ** -2.5)
        run(25.0, 1, 10.0 ** -2.5)
        assert trace.snapshot().get("kmeans.rows", 0) == (0 if known_h else 2 * BATCH)
    finally:
        trace.reset()
