"""The plain reference against the port, on the CPU: the same code tables
from the raw files, the same draws and channel, and the launches of every
cell judged as a run judges them."""

import numpy as np
import pytest
import torch

from kmldpc_torch.code.ldpc import load_code as port_code
from kmldpc_torch.config import config_from_dict
from kmldpc_torch.io.constellation import parse_constellation
from kmldpc_torch.ops.source import chunk_seed as port_chunk_seed, make_generator
from kmldpc_torch.params import make_chain_params
from kmldpc_torch.sim.chain import ChainSpec, build_frontend_fn, make_chunk_runner
from linkbench import judge, spec
from linkbench.reference import chain as ref
from linkbench.reference.code import load_code
from linkbench.reference.draw import chunk_seed

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("matrix", ["PEG2304regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"])
def test_code_tables_match_the_port(matrix):
    path = str(spec.ASSETS / matrix)
    mine, port = load_code(path), port_code(path)
    assert (mine.num_row, mine.num_col, mine.info_bits, mine.punct, mine.info_start) == (
        port.num_row, port.num_col, port.code_dim, port.punct, port.info_slice.start)
    assert np.array_equal(mine.parity_gen, port.parity_gen)
    dense = np.zeros((mine.num_row, mine.num_col), dtype=np.uint8)
    for r in range(mine.num_row):
        dense[r, mine.row_cols[r][mine.row_mask[r]]] = 1
    assert np.array_equal(dense, port.dense_h())
    assert mine.num_edges == port.num_edges


def test_chunk_seed_is_the_ports():
    for args in ((0, 5.0, 0, 0), (2**62 + 3, -2.5, 17, 1), (123, 24.0, 2, 1)):
        assert chunk_seed(*args) == port_chunk_seed(*args)


def setup(name: str, batch: int = 8, lo: float = 14.0, hi: float = 16.5):
    cell = spec.load_cell(name, overrides={
        "range": {"minimum_snr": lo, "maximum_snr": hi, "maximum_block_number": batch},
        "tpu": {"batch": batch}})
    cfg = config_from_dict(cell.sweep_tables(11), asset_dir=str(spec.ASSETS))
    chain_spec = ChainSpec.from_config(cfg, port_code(cfg.matrix_path()),
                                       parse_constellation(cfg.modem_path()))
    link, g = judge.reference_link(cell, torch.float64, "cpu")
    return cell, chain_spec, link, g


@pytest.mark.parametrize("name", CELLS)
def test_front_end_is_the_ports(name):
    cell, chain_spec, link, g = setup(name)
    params = make_chain_params(chain_spec.code, "cpu", chain_spec.schedule)
    var = torch.tensor(10 ** (-1.45), dtype=torch.float32)
    frontend = build_frontend_fn(chain_spec, cell.batch, "cpu")
    uu, yr, yi, hr, hi = frontend(params, make_generator(chunk_seed(11, 14.5, 2, 0), "cpu"), var)
    rows = torch.tensor([1, 2, 6])
    ruu, ryr, ryi, rhr, rhi, _ = ref.channel(link, g, 11, 14.5, 2, 0, rows)
    assert torch.equal(uu[rows], ruu)
    for a, b in ((yr, ryr), (yi, ryi), (hr, rhr), (hi, rhi)):
        torch.testing.assert_close(a[rows].double(), b, rtol=1e-5, atol=1e-5)
    assert torch.equal(ref.launch_bits(link, 11, 14.5, 2), uu)


@pytest.mark.parametrize("name", CELLS)
def test_launches_are_judged_correct(name):
    cell, chain_spec, link, g = setup(name)
    run = make_chunk_runner(chain_spec, cell.batch, cell.subs, "cpu", seed=11)
    rows = [0, 3, 4, 7]
    pairs = []
    for snr in cell.points:
        res = run(snr, 1, 10.0 ** (-0.1 * snr))
        take = lambda x: x[rows]  # noqa: E731
        kept = judge.Kept(res.err_bit, res.err_blk, torch.tensor(res.tot_blk), res.raw.uu_hat,
                          take(res.metrics) if cell.blind else None, take(res.raw.uu_hat),
                          take(res.raw.converged), take(res.raw.iters),
                          take(res.raw.soft_syndrome))
        pairs.append((kept, ref.launch_bits(link, 11, snr, 1),
                      ref.run_rows(link, g, 11, snr, 1, torch.tensor(rows))))
    numbers, bad = judge.compare(pairs, cell.blind)
    assert bad == 0 and numbers["sampled_words"] == 4 * len(cell.points)
    for k, limit in cell.limits.items():
        assert numbers[k] <= limit, (k, numbers)
    assert numbers["decode_gap"] == 0


def test_sample_is_drawn_from_the_seed():
    cell = spec.load_cell("peg2304-qpsk.blind")
    a, b = judge.Sample(cell, 2**33 + 1), judge.Sample(cell, 2**33 + 1)
    assert a.keys == b.keys and a.rows == b.rows
    assert a.keys != judge.Sample(cell, 2**33 + 2).keys or a.rows != judge.Sample(
        cell, 2**33 + 2).rows
    points = [a.keys[s][0] for s in range(len(cell.points))]
    assert sorted(points) == cell.points, "every point before any repeats"
    assert all(len(r) == judge.SAMPLE_ROWS and r == sorted(set(r)) for r in a.rows.values())


def test_a_traffic_file_sets_the_rows_judged():
    """``[sample] rows`` of the known-h cell, the judge's default elsewhere,
    never more than a launch holds."""
    known = spec.load_cell("nr-bg2-16qam.known")
    assert known.sample_rows == 8192 and "sample" not in known.tables
    assert all(len(r) == 8192 for r in judge.Sample(known, 5).rows.values())
    small = spec.load_cell("nr-bg2-16qam.known", overrides={"tpu": {"batch": 64}})
    assert all(r == list(range(64)) for r in judge.Sample(small, 5).rows.values())
    assert spec.load_cell("peg2304-qpsk.blind").sample_rows == 0


def test_the_reference_refuses_what_it_does_not_model():
    cell = spec.load_cell("nr-bg2-16qam.blind", overrides={"tpu": {"schedule": "layered-minsum"}})
    with pytest.raises(NotImplementedError, match="schedule"):
        judge.reference_link(cell, torch.float64, "cpu")
