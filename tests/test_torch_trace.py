"""The port's spans and counters (``kmldpc_torch/utils/trace.py``): spans on
the profiler's timeline only while a profiler records, counters of
codeword-iterations and host syncs against a count by hand, and the
``Simulator``'s per-point counter line."""

import dataclasses
import glob
import re
from collections import Counter

import pytest
import torch

from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.decoder import DecoderTables, flooding_decode_em, two_phase_generic
from kmldpc_torch.sim import Simulator
from kmldpc_torch.utils import SimLogger, trace

ITERS, PHASE1, TILE = 12, 3, 8
CHECKS = len(range(4, ITERS, 4))  # exit checks of a loop that runs to ITERS


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["PEG2304regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"],
                ids=["slot-major", "degree-class"])
def tables(request, assets):
    return DecoderTables.from_code(load_code(str(assets / request.param)), "cpu")


def _llr(t: DecoderTables, easy: int, hard: int) -> torch.Tensor:
    """``easy`` rows of the all-zero codeword at LLR +10, which converge in
    the first iterations, interleaved with ``hard`` rows of strong random
    signs, which never converge."""
    n = t.num_col - t.punct
    g = torch.Generator().manual_seed(5)
    rows = 20.0 * (1 - 2 * torch.randint(0, 2, (hard, n), generator=g)).float()
    for j in range(easy):
        at = j * (hard + easy) // easy
        rows = torch.cat([rows[:at], torch.full((1, n), 10.0), rows[at:]])
    return rows


def _decode(t, llr, tile):
    with trace.label("decode"):
        return two_phase_generic(lambda x, it: flooding_decode_em(t, x, it), llr, ITERS,
                                 PHASE1, tile)


def _counted(t, llr, tile):
    trace.reset()
    res = _decode(t, llr, tile)
    return res, trace.snapshot()


def test_spans_nest_under_decode(tables):
    """Under torch.profiler a two-phase decode with tile < B records phase
    1, the sort, one span a phase-2 tile and one a exit check, each nested
    under the chain's decode label."""
    llr = _llr(tables, easy=4, hard=20)
    with torch.profiler.profile() as prof:
        _decode(tables, llr, TILE)
    events = [e for e in prof.events() if e.name.startswith(("decode", "exit_check"))]
    names = Counter(e.name for e in events)
    tiles = -(-20 // TILE)
    assert names == {"decode": 1, "decode.phase1": 1, "decode.sort": 1, "decode.tile": tiles,
                     "exit_check": tiles * CHECKS}

    def parents(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            yield e.name

    for e in events:
        up = list(parents(e))
        if e.name == "exit_check":
            assert up[0] == "decode.tile"
        if e.name != "decode":
            assert "decode" in up


def test_spans_are_operators_and_labels_annotations(tables):
    """The profiler copies user annotations onto the device's timeline; the
    program's spans are recorded with an operator's scope, so it copies
    none of them, and the chain's labels stay user annotations."""
    with torch.profiler.profile() as prof:
        _decode(tables, _llr(tables, easy=4, hard=20), TILE)
    kinds = {e.name(): e.activity_type() for e in prof.profiler.kineto_results.events()}
    assert kinds["decode"] == "user_annotation"
    for name in ("decode.phase1", "decode.sort", "decode.tile", "exit_check"):
        assert kinds[name] == "cpu_op"


def test_counters_of_a_never_converging_batch(tables):
    """Rows that never converge run every loop to the budget: with tile >= B
    one loop of B rows, so the run equals the needed exactly."""
    llr = _llr(tables, easy=0, hard=16)
    res, counts = _counted(tables, llr, 16)
    assert res.iters.tolist() == [ITERS] * 16
    assert counts == {"decode.cw_iters_run": 16 * ITERS, "decode.syncs": CHECKS}
    assert int(res.iters.sum()) / counts["decode.cw_iters_run"] == 1.0


def test_counters_of_a_mixed_batch(tables):
    """4 easy rows among 20 that never converge, tiles of 8: phase 1 runs 3
    iterations on all 24 rows; the sort is one sync; each of the 3 tiles
    holds a row that never converges, so runs all 8 rows to the budget."""
    llr = _llr(tables, easy=4, hard=20)
    res, counts = _counted(tables, llr, TILE)
    assert (res.iters == ITERS).sum() == 20 and (res.iters < PHASE1).sum() == 4
    tiles = 3
    assert counts == {"decode.cw_iters_run": 24 * PHASE1 + tiles * TILE * ITERS,
                      "decode.syncs": 1 + tiles * CHECKS}


def test_counters_go_under_the_label_the_host_is_in(tables):
    trace.reset()
    llr = _llr(tables, easy=0, hard=8)
    with trace.label("metric"):
        flooding_decode_em(tables, llr, 5)
    flooding_decode_em(tables, llr, 5)  # outside every label
    trace.count("cw_iters_needed", 3, stage="decode")
    assert trace.snapshot() == {"metric.cw_iters_run": 40, "metric.syncs": 1,
                                "cw_iters_run": 40, "syncs": 1, "decode.cw_iters_needed": 3}


def test_outputs_and_counters_equal_with_the_profiler_on_and_off(tables):
    llr = _llr(tables, easy=4, hard=20)
    off, counts_off = _counted(tables, llr, TILE)
    with torch.profiler.profile():
        on, counts_on = _counted(tables, llr, TILE)
    assert counts_on == counts_off
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _cfg(assets, **over):
    cfg = load_config(str(assets / "config.toml"))
    for section, kv in over.items():
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section), **kv)})
    return cfg


def _sweep_cfg(assets, tmp_path, snr_fold=0):
    """Two points of 8 blocks, launches of 4, the soft metric (decodes in the
    metric stage), a checkpoint."""
    return _cfg(assets, range=dict(minimum_snr=10.0, maximum_snr=15.0, maximum_block_number=8,
                                   maximum_error_number=10**9),
                xcodec=dict(metric_type=True),
                tpu=dict(batch=4, chunks_per_launch=1, snr_fold=snr_fold,
                         checkpoint_path=str(tmp_path / "ckpt.json")))


def test_no_profiler_enters_no_record_function(assets, tmp_path, monkeypatch):
    """Without a profiler neither the decode nor the harness constructs a
    record function, a chain label's or a span's; with one both do."""
    made = []
    init = torch.autograd.profiler.record_function.__init__
    fast = trace._RecordFunctionFast

    def counting(self, name, args=None):
        made.append(name)
        init(self, name, args)

    def counting_fast(name):
        made.append(name)
        return fast(name)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", counting)
    monkeypatch.setattr(trace, "_RecordFunctionFast", counting_fast)
    cfg = _sweep_cfg(assets, tmp_path)
    Simulator(cfg, SimLogger(log_dir=None, stdout=False), device="cpu").simulate()
    t = DecoderTables.from_code(load_code(cfg.matrix_path()), "cpu")
    _decode(t, _llr(t, easy=4, hard=20), TILE)
    assert made == []
    (tmp_path / "ckpt.json").unlink()
    with torch.profiler.profile():
        Simulator(cfg, SimLogger(log_dir=None, stdout=False), device="cpu").simulate()
    assert {"harness.build", "harness.consume", "harness.checkpoint", "frontend", "metric",
            "decode", "exit_check"} <= set(made)


def _lines(text):
    """Lines without their time stamp and wall-clock numbers."""
    text = re.sub(r"^\[[^]]*\]", "", text, flags=re.M)
    return re.sub(r"in [0-9.]+ s .*", "", text).splitlines()


@pytest.mark.parametrize("snr_fold", [0, 2], ids=["sequential", "folded"])
def test_simulator_logs_counters_to_the_file_only(assets, tmp_path, capsys, monkeypatch,
                                                  snr_fold):
    """One counter line a point (a folded sweep: one for the sweep) in the
    log file, none on stdout; stdout as without the line.  The needed
    iterations come from the mean the harness reads, the run from the
    decoders' counters."""
    cfg = _sweep_cfg(assets, tmp_path, snr_fold)
    trace.reset()
    Simulator(cfg, SimLogger(log_dir=str(tmp_path / "logs")), device="cpu").simulate()
    out = capsys.readouterr().out
    counts = trace.snapshot()
    log = open(glob.glob(str(tmp_path / "logs" / "*"))[0]).read()
    assert "cw_iters" not in out
    found = re.findall(r"\] (.*) counters: decode cw_iters_run = (\d+) cw_iters_needed = (\d+) "
                       r"needed/run = ([0-9.]+) syncs = (\d+) fused_rows = (\d+); "
                       r"metric cw_iters_run = (\d+) syncs = (\d+)", log)
    whats = [f[0] for f in found]
    assert whats == (["SNR = 10.000", "SNR = 15.000"] if not snr_fold
                     else ["SNR-fold sweep of 2 points"])
    means = [float(m) for m in re.findall(r"mean BP iters = ([0-9.]+)", log)]
    assert len(means) == 4
    run = sum(int(f[1]) for f in found)
    needed = sum(int(f[2]) for f in found)
    assert (run, needed) == (counts["decode.cw_iters_run"], counts["decode.cw_iters_needed"])
    assert counts["harness.launches"] == 4
    assert needed == pytest.approx(4 * sum(means), abs=0.02 * 4 * len(means))
    assert 0 < needed <= run and all(int(f[4]) > 0 for f in found)
    # 4 launches of 4 blocks, 4 candidates each: at least 4 metric iterations a row
    assert all(int(f[5]) == 0 for f in found)  # K2 decodes no row on the CPU
    metric_run = sum(int(f[6]) for f in found)
    assert 4 * 16 * 4 <= metric_run <= 4 * 16 * 5
    (tmp_path / "ckpt.json").unlink()
    monkeypatch.setattr(Simulator, "_log_counters", lambda *a: None)
    Simulator(cfg, SimLogger(log_dir=None), device="cpu").simulate()
    assert _lines(capsys.readouterr().out) == _lines(out)
