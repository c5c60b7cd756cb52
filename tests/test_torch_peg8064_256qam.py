"""The PEG8064 R = 1/2 256QAM Gray link of the benchmark cell
``peg8064-256qam.blind`` on the CPU, against the benchmark's plain
reference (``linkbench/reference``) in float64: the table against
TS 38.211 5.1.5, the plain k-means and the plain soft demapper at 256
points, and whole launches judged as a run judges them, at a batch of 8 on
the cell's own grid.  The point counters ``kmeans.point_evals`` and
``demap.point_evals`` count what the estimate and the demap evaluate,
kernels K1 and K4 take 256-point tables, and the benchmark's
``demap_roofline`` reads K4's rows from the program's counters."""

import functools
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kmldpc_torch.code.ldpc import load_code as port_code
from kmldpc_torch.config import config_from_dict
from kmldpc_torch.detect import kmeans_cuda
from kmldpc_torch.detect.kmeans import blind_estimate
from kmldpc_torch.io.constellation import parse_constellation
from kmldpc_torch.ops import ModemTables, demap_cuda
from kmldpc_torch.ops.modem import make_plain_soft_demapper
from kmldpc_torch.sim.chain import ChainSpec, make_chunk_runner
from kmldpc_torch.utils import trace
from linkbench import judge, spec
from linkbench.reference import chain as ref
from linkbench.metrics import demap_roofline
from linkbench.reference.code import load_constellation
from linkbench.roofline import HBM_BYTES_PER_S

CELL = "peg8064-256qam.blind"
BATCH = 8
SEED = 11
POINTS = spec.load_cell(CELL).points  # 22.5, 25, 27.5, 30, 32.5 dB
TABLE = spec.ASSETS / "8bits_256QAM_Gray.txt"
NSYM = 1008


@functools.lru_cache(maxsize=None)
def _setup(known_h: bool = False):
    """(cell, chain spec, float64 reference link, its graph) at the test
    batch, built once a process."""
    over = {"range": {"maximum_block_number": BATCH}, "tpu": {"batch": BATCH}}
    if known_h:
        over["decoder"] = {"true_h_arg": True}
    cell = spec.load_cell(CELL, overrides=over)
    cfg = config_from_dict(cell.sweep_tables(SEED), asset_dir=str(spec.ASSETS))
    chain_spec = ChainSpec.from_config(cfg, port_code(cfg.matrix_path()),
                                       parse_constellation(cfg.modem_path()))
    link, g = judge.reference_link(cell, torch.float64, "cpu")
    return cell, chain_spec, link, g


def _ts38211(label: int) -> complex:
    """TS 38.211 5.1.5: the 256QAM point of the 8 bits b0 ... b7 (b0 first)."""
    b = [(label >> (7 - j)) & 1 for j in range(8)]
    s = [1 - 2 * x for x in b]
    re = s[0] * (8 - s[2] * (4 - s[4] * (2 - s[6])))
    im = s[1] * (8 - s[3] * (4 - s[5] * (2 - s[7])))
    return complex(re, im) / np.sqrt(170)


def test_cell_is_the_256qam_link_at_its_batch():
    cell, chain_spec, link, _ = _setup()
    assert POINTS == [22.5, 25.0, 27.5, 30.0, 32.5] and cell.blind and not cell.folded
    code = link.code
    assert (code.num_row, code.num_col, code.info_bits, code.num_edges) == (4032, 8064, 4032,
                                                                            24192)
    assert link.const.points.size == 256 and code.tx_len // link.const.bits_per_symbol == NSYM
    assert not chain_spec.metric_type and chain_spec.max_iter == 50
    full = spec.load_cell(CELL)
    assert (full.batch, full.subs, full.launches_per_point) == (4096, 1, 4)
    assert full.sample_rows == 512


def test_table_is_ts_38211s_256qam():
    """Point k carries label k, at the standard's position to 1e-9 after the
    loaders' normalisation to unit mean energy; nearest neighbours differ in
    one bit (a Gray map); the port's, the reference's and the JAX package's
    loaders read the same points and bits."""
    from kmldpc_tpu.io.constellation import parse_constellation as jax_parse

    port, mine, jax = (load(str(TABLE)) for load in (parse_constellation, load_constellation,
                                                     jax_parse))
    want = np.array([_ts38211(k) for k in range(256)])
    assert port.bits_per_symbol == mine.bits_per_symbol == jax.bits_per_symbol == 8
    np.testing.assert_allclose(port.points, want, rtol=0, atol=1e-9)
    assert abs(np.mean(np.abs(port.points) ** 2) - 1) < 1e-12
    labels = (port.bits.astype(np.int64) << np.arange(7, -1, -1)).sum(1)
    assert np.array_equal(labels, np.arange(256))
    for other in (mine, jax):
        assert np.array_equal(other.points, port.points)
        assert np.array_equal(np.asarray(other.bits, np.int64), port.bits.astype(np.int64))
    step = 2 / np.sqrt(170)
    pairs = 0
    for a, b in itertools.combinations(range(256), 2):
        if abs(abs(port.points[a] - port.points[b]) - step) < 1e-9:
            pairs += 1
            assert bin(a ^ b).count("1") == 1, (a, b)
    assert pairs == 2 * 16 * 15  # a 16 x 16 grid's horizontal and vertical neighbours


@pytest.mark.parametrize("snr", POINTS)
def test_plain_kmeans_is_the_references_at_256_points(snr):
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
def test_plain_demap_is_the_references_at_256_points(snr):
    """The port's plain soft demapper (the CPU path and K4's plain version)
    on a launch's received rows and true gains, in float32, against the
    reference's demap in float64 on the same rows: P(bit = 0) and the LLRs
    to float32 rounding, and the same decisions wherever the float64 |LLR|
    exceeds 1e-3."""
    _, chain_spec, link, g = _setup()
    _, yr, yi, hr, hi, var = ref.channel(link, g, SEED, snr, 3, 0)
    rows = [t.float() for t in (yr, yi, hr, hi)]
    tables = ModemTables.from_constellation(chain_spec.constellation, "cpu")
    p0, llr = make_plain_soft_demapper(tables)(*rows, torch.tensor(var, dtype=torch.float32))
    r_p0, r_llr = ref.demap(*(t.double() for t in rows), var, link.const)
    assert p0.shape == llr.shape == (BATCH, NSYM * 8)
    torch.testing.assert_close(p0.double(), r_p0, rtol=0, atol=1e-5)
    torch.testing.assert_close(llr.double(), r_llr, rtol=1e-4, atol=1e-4)
    sure = r_llr.abs() > 1e-3
    assert torch.equal((p0 > 0.5)[sure], (r_p0 > 0.5)[sure])


@functools.lru_cache(maxsize=None)
def _judged_pair(snr: float):
    """(kept outputs, drawn bits, reference rows) of the launch at ``snr``:
    every codeword of it, as ``judge.compare`` takes a sampled launch."""
    cell, chain_spec, link, g = _setup()
    run = make_chunk_runner(chain_spec, BATCH, cell.subs, "cpu", seed=SEED)
    res = run(snr, 1, 10.0 ** (-0.1 * snr))
    kept = judge.Kept(res.err_bit, res.err_blk, torch.tensor(res.tot_blk), res.raw.uu_hat,
                      res.metrics, res.raw.uu_hat, res.raw.converged, res.raw.iters,
                      res.raw.soft_syndrome)
    rows = torch.arange(BATCH)
    return kept, ref.launch_bits(link, SEED, snr, 1), ref.run_rows(link, g, SEED, snr, 1, rows)


@pytest.mark.parametrize("snr", POINTS)
def test_launch_is_judged_correct(snr):
    """Every codeword of a launch at the cell's grid point, judged by
    ``judge.compare`` against the float64 reference: counters exact, no
    outcome apart, and every compared number but ``soft_gap`` within the
    cell's ``[check]``.  ``soft_gap`` is a 90th percentile over the words
    both sides decode alike, which a run takes over its 8 sampled launches
    (4,096 words); over one launch of 8 it is their largest, so the next
    test takes it over the grid's launches together."""
    cell = spec.load_cell(CELL)
    numbers, bad = judge.compare([_judged_pair(snr)], blind=True)
    assert bad == 0 and numbers["sampled_words"] == BATCH
    assert numbers["counter_gap"] == 0 and numbers["decode_gap"] == 0
    assert set(cell.limits) == {"counter_gap", "iters_gap", "decode_gap", "soft_gap",
                                "select_gap", "metric_gap"}
    for k, limit in cell.limits.items():
        if k != "soft_gap":
            assert numbers[k] <= limit, (k, numbers)


def test_grid_launches_are_judged_correct():
    """The launches at the cell's five grid points judged together, as a
    run judges its sampled launches, which fall on points in a seeded
    order: ``correct`` by the cell's ``[check]``, every number included."""
    cell = spec.load_cell(CELL)
    numbers, bad = judge.compare([_judged_pair(snr) for snr in POINTS], blind=True)
    assert bad == 0 and numbers["sampled_words"] == BATCH * len(POINTS)
    correct, checks = judge.verdict(cell, numbers)
    assert correct, checks


@pytest.mark.parametrize("known_h", [False, True], ids=["blind", "known-h"])
def test_point_counters_count_what_a_launch_evaluates(known_h):
    """``kmeans.point_evals`` adds rows x Nsym x 256 x 20 passes a blind
    launch, and nothing with known h; ``demap.point_evals`` adds rows x
    Nsym x 256 under the label the demap runs in: 4B rows blind, in the
    metric stage, and B with known h, in the demap."""
    cell, chain_spec, _, _ = _setup(known_h)
    run = make_chunk_runner(chain_spec, BATCH, cell.subs, "cpu", seed=SEED)
    trace.reset()
    try:
        run(32.5, 0, 10.0 ** -3.25)
        counts = trace.snapshot()
    finally:
        trace.reset()
    per_row = NSYM * 256
    if known_h:
        assert counts.get("kmeans.point_evals", 0) == 0
        assert counts["demap.demap.point_evals"] == BATCH * per_row
        assert "metric.demap.point_evals" not in counts
    else:
        assert counts["kmeans.point_evals"] == BATCH * per_row * chain_spec.kmeans_iters == (
            BATCH * per_row * 20)
        assert counts["metric.demap.point_evals"] == 4 * BATCH * per_row
        assert "demap.demap.point_evals" not in counts


def _square_table(points: int) -> ModemTables:
    """A points-point table whose point k carries label k."""
    m = points.bit_length() - 1
    k = np.arange(points)
    bits = (k[:, None] >> np.arange(m - 1, -1, -1)) & 1
    pts = np.exp(2j * np.pi * k / points) * (1 + (k % 2))
    return ModemTables(m, torch.tensor(pts.real, dtype=torch.float32),
                       torch.tensor(pts.imag, dtype=torch.float32),
                       torch.tensor(bits == 0, dtype=torch.float32),
                       torch.tensor(2.0 ** np.arange(m - 1, -1, -1), dtype=torch.float32))


@pytest.mark.parametrize("points", [256, 128])
def test_kernels_take_256_points_and_refuse_128(monkeypatch, points):
    """K4's table check and K1's argument check take a 256-point table and
    refuse a 128-point one, naming the sizes they are built for; neither
    loads the library to refuse."""
    class Loaded(Exception):
        pass

    def no_load():
        raise Loaded

    monkeypatch.setattr(demap_cuda, "load_library", no_load)
    monkeypatch.setattr(kmeans_cuda, "load_library", no_load)
    tables = (ModemTables.from_constellation(parse_constellation(str(TABLE)))
              if points == 256 else _square_table(points))
    table = demap_cuda.K4Table.read(tables.points_re, tables.points_im, tables.bit0_mask)
    pts = tables.points_re.numpy(), tables.points_im.numpy()
    y = torch.zeros((2, 8))
    if points == 256:
        assert table.refusal is None
        with pytest.raises(Loaded):
            kmeans_cuda.launch_k1(y, y, *pts, 20, 0, False)
        return
    assert "4, 16, 64, 256-point" in table.refusal and "128-point" in table.refusal
    with pytest.raises(ValueError, match=r"\(4, 16, 64, 256\)"):
        kmeans_cuda.launch_k1(y, y, *pts, 20, 0, False)


@pytest.mark.parametrize("rows_a_block,stage", [(4, "metric"), (2, "metric"), (1, "demap")],
                         ids=["blind", "pruned", "known-h"])
def test_demap_roofline_reads_the_rows_k4_demapped(rows_a_block, stage):
    """``demap_roofline``'s least time counts the rows under
    ``*demap.fused_rows`` a consumed launch, times the traced launches: one
    exponential a point a row a symbol, and the traced codewords' symbols
    read once with both outputs written once a row.  Without the counters
    it gives no reading."""
    _, _, link, _ = _setup()
    b, launches, traced, kernel_s, ops_per_s = 4096, 10, 3, 2e-3, 5e13
    summary = SimpleNamespace(blocks=traced * b, launches=[(22.5, j) for j in range(traced)],
                              kernel_s=lambda f: kernel_s if f == "demap_kernel" else 0.0)
    ctx = {"link": link, "ops_per_s": ops_per_s}
    trace.reset()
    try:
        assert demap_roofline.read(summary, ctx) is None
        trace.count("demap.fused_rows", launches * rows_a_block * b, stage=stage)
        trace.count("launches", launches, stage="harness")
        got = demap_roofline.read(summary, ctx)
    finally:
        trace.reset()
    rows = traced * rows_a_block * b
    exp_s = rows * NSYM * 256 / (ops_per_s * 16 / 128)
    bytes_s = (traced * b * 8 * NSYM + rows * NSYM * 8 * 8) / HBM_BYTES_PER_S
    assert exp_s > bytes_s
    assert got == pytest.approx(100 * exp_s / kernel_s, rel=1e-12)
