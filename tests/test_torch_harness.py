"""kmldpc_torch's Monte-Carlo harness: SNR folding, checkpoint and resume,
histogram mode, k-means dumps, debug lines and profile_dir, on the CPU.

The properties mirror those tests/test_sim.py pins for the JAX package;
the writers (histogram rows, debug lines, k-means records) are held against
the JAX package's on identical arrays.  No test here constructs the JAX
package's Simulator.
"""

import dataclasses
import io
import json
import os
import re
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmldpc_tpu.detect.kmeans import add_diagnostics as jax_add_diagnostics
from kmldpc_tpu.detect.kmeans import make_blind_estimator as jax_make_blind_estimator
from kmldpc_tpu.ops import ModemTables as JaxModemTables
from kmldpc_tpu.sim.montecarlo import Simulator as JaxSimulator
from kmldpc_tpu.utils.records import dump_kmeans as jax_dump_kmeans
from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.detect import add_diagnostics, make_blind_estimator
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.ops import ModemTables
from kmldpc_torch.sim import ChainSpec, Simulator, make_chunk_runner, make_multi_point_runner
from kmldpc_torch.utils import SimLogger
from kmldpc_torch.utils.records import dump_kmeans


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(assets, **over):
    cfg = load_config(str(assets / "config.toml"))
    for section, kv in over.items():
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(getattr(cfg, section), **kv)}
        )
    return cfg


def _quiet():
    return SimLogger(log_dir=None, stdout=False)


def _sim(cfg, log=None, **kw):
    return Simulator(cfg, log or _quiet(), device="cpu", **kw)


def _counts(results):
    return [(r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit, r.err_bit_sq) for r in results]


def _same(x, y) -> bool:
    if torch.is_tensor(x):
        return torch.equal(x, y)
    if isinstance(x, tuple):
        return len(x) == len(y) and all(_same(a, b) for a, b in zip(x, y))
    return x == y


def _slot(x, j):
    """Slot j of a multi-point result, field by field."""
    if torch.is_tensor(x):
        return x[j]
    if isinstance(x, tuple):
        vals = [_slot(v, j) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x


# three known-h points at low SNR: errors in every launch, PEG2304 + the
# assets' 16QAM table
KNOWN3 = dict(range=dict(minimum_snr=2.0, maximum_snr=6.0, step_snr=2.0,
                         maximum_block_number=48, maximum_error_number=10**9),
              decoder=dict(true_h_arg=True))


@pytest.mark.parametrize("known_h", [True, False], ids=["known-h", "blind-debug"])
def test_multi_point_slots_equal_sequential_launches(assets, known_h):
    """Slot j of the multi-point runner is bitwise the sequential runner's
    launch with the same (snr, launch, var): every field, the per-codeword
    decode results and the debug surface included."""
    code = load_code(str(assets / "PEG2304regular0.5.txt"))
    const = parse_constellation(str(assets / "2bits_QPSK.txt"))
    spec = ChainSpec(code=code, constellation=const, known_h=known_h, fading=True,
                     metric_type=False, metric_iter=5, max_iter=30, encoder_active=True,
                     debug_blocks=0 if known_h else 2)
    seq = make_chunk_runner(spec, 8, 2, "cpu", seed=4)
    multi = make_multi_point_runner(spec, 8, 2, 3, "cpu", seed=4)
    assert (multi.num_slots, multi.blocks_per_launch) == (3, 16)
    points = [(3.0, 0), (3.0, 1), (8.0, 5)]
    vars_ = [10 ** (-0.1 * snr) for snr, _ in points]
    res = multi(points, vars_)
    assert res.err_bit.shape == (3,) and res.metrics.shape == (3, 16, 4)
    for j, ((snr, launch), var) in enumerate(zip(points, vars_)):
        one = seq(snr, launch, var)
        slot = _slot(res, j)
        assert (int(slot.tot_blk), int(slot.tot_bit)) == (one.tot_blk, one.tot_bit)
        for field in ("err_bit", "err_blk", "err_bit_sq", "metrics", "iters", "raw", "debug"):
            assert _same(getattr(slot, field), getattr(one, field)), field
    with pytest.raises(ValueError, match="3 slots"):
        multi(points[:2], vars_[:2])


def test_snr_fold_bit_identical_sweep(assets):
    """A block-capped folded sweep gives bitwise the sequential per-point
    counters (chunks_per_launch 2, three points, fold 3)."""
    r_seq = _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=2), **KNOWN3)).simulate()
    sim = _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=2, snr_fold=3), **KNOWN3))
    assert sim.snr_fold == 3
    r_fold = sim.simulate()
    assert len(r_seq) == 3 and _counts(r_seq) == _counts(r_fold)
    assert all(r.err_blk > 0 for r in r_fold)


def test_snr_fold_caps_slots_at_points(assets):
    """snr_fold larger than the sweep takes one slot a point, and logs it."""
    log = types.SimpleNamespace(lines=[])
    log.info = lambda msg, to_stdout=True: log.lines.append(msg)
    sim = Simulator(_cfg(assets, tpu=dict(batch=8, snr_fold=8), **KNOWN3), log, device="cpu")
    assert sim.snr_fold == 3 and sim.runner.num_slots == 3
    assert "SNR-fold: 3 launch slots per dispatch" in log.lines


def test_snr_fold_non_divisible_padding_terminates(assets):
    """3 points x 3 launches with fold 2 forces dead padding slots; they
    must not touch the in-flight accounting, so the sweep ends at the cap
    with the sequential counters."""
    common = dict(KNOWN3, range=dict(KNOWN3["range"], maximum_block_number=24))
    r_seq = _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=1), **common)).simulate()
    r_fold = _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=1, snr_fold=2),
                       **common)).simulate()
    assert [r.tot_blk for r in r_fold] == [24, 24, 24]
    assert _counts(r_seq) == _counts(r_fold)


def test_snr_fold_rejects_kmeans_dump(assets, tmp_path):
    """As the JAX package: snr_fold with a k-means dump raises its
    ValueError; model_parallel raises before that, naming the open
    multi-device item."""
    cfg = _cfg(assets, decoder=dict(true_h_arg=False),
               tpu=dict(snr_fold=2, kmeans_dump_dir=str(tmp_path / "km")))
    with pytest.raises(ValueError) as e:
        _sim(cfg)
    assert str(e.value) == ("[tpu].snr_fold is incompatible with kmeans_dump_dir and "
                            "model_parallel (use the sequential path for those)")
    with pytest.raises(NotImplementedError, match="multi-device"):
        _sim(_cfg(assets, tpu=dict(snr_fold=2, model_parallel=2)))


def test_snr_fold_histogram_byte_identical(assets, tmp_path, monkeypatch):
    """Folded histogram sweeps demux per-point files from the slot axis,
    byte-identical to the sequential files; the per-point wall is
    attributed, so blocks_per_s * wall_s gives each point's blocks."""
    common = dict(range=dict(minimum_snr=16.0, maximum_snr=24.0, step_snr=4.0,
                             maximum_block_number=24, maximum_error_number=10**9),
                  decoder=dict(true_h_arg=False), histogram=dict(enable=True))
    for name, fold in (("seq", 0), ("fold", 3)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        rs = _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=1, snr_fold=fold),
                       **common)).simulate()
    files = sorted(os.listdir(tmp_path / "seq"))
    assert files == sorted(os.listdir(tmp_path / "fold")) and len(files) == 3
    for f in files:
        text = (tmp_path / "seq" / f).read_bytes()
        assert text == (tmp_path / "fold" / f).read_bytes(), f
        assert len(text.splitlines()) == 24
    for r in rs:
        assert r.wall_s > 0
        assert abs(r.blocks_per_s * r.wall_s - r.tot_blk) < 1e-6


def _debug_lines(log_path):
    pat = re.compile(r"(Generated H = .*|Current Block Number = .*|Hhat = .*|hatIndex = .*)$")
    return [m.group(1) for m in map(pat.search, open(log_path).read().splitlines()) if m]


def test_snr_fold_debug_blocks_matches_sequential(assets, tmp_path):
    """The folded per-block debug lines of each point's first launch are the
    sequential path's, line for line."""
    common = dict(range=dict(minimum_snr=20.0, maximum_snr=24.0, step_snr=4.0,
                             maximum_block_number=16, maximum_error_number=10**9),
                  decoder=dict(true_h_arg=False))
    lines = {}
    for fold in (0, 2):
        log = SimLogger(log_dir=str(tmp_path / str(fold)), stdout=False)
        _sim(_cfg(assets, tpu=dict(batch=8, chunks_per_launch=1, debug_blocks=2,
                                   snr_fold=fold), **common), log).simulate()
        log.close()
        lines[fold] = _debug_lines(log._path)
    # 2 points x 2 blocks x (H, block number, 4 candidates, hatIndex)
    assert len(lines[0]) == 2 * 2 * 7 and lines[0] == lines[2]


def test_snr_fold_wall_attribution_sums_to_run_wall(assets):
    """The per-point attributed walls sum to no more than the run's wall,
    and hold the larger part of it."""
    cfg = _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1, snr_fold=3),
               **dict(KNOWN3, range=dict(KNOWN3["range"], maximum_block_number=32)))
    sim = _sim(cfg)
    t0 = time.monotonic()
    rs = sim.simulate()
    elapsed = time.monotonic() - t0
    total = sum(r.wall_s for r in rs)
    assert all(r.wall_s > 0 for r in rs)
    assert 0.2 * elapsed < total <= elapsed
    for r in rs:
        assert abs(r.blocks_per_s * r.wall_s - r.tot_blk) < 1e-6


def test_snr_fold_error_cap_terminates(assets):
    """The error cap ends a folded sweep, overrunning by at most the
    in-flight slots."""
    cfg = _cfg(assets, range=dict(minimum_snr=0.0, maximum_snr=2.0, step_snr=2.0,
                                  maximum_block_number=10**6, maximum_error_number=4),
               decoder=dict(true_h_arg=True),
               tpu=dict(batch=8, chunks_per_launch=1, snr_fold=2))
    for r in _sim(cfg).simulate():
        assert r.err_blk >= 4
        assert r.tot_blk <= 8 * 8


def test_checkpoint_resume(assets, tmp_path):
    """A finished sweep's checkpoint restores every point with no compute."""
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(assets, range=dict(maximum_block_number=20, maximum_error_number=10**9,
                                  minimum_snr=10.0, maximum_snr=15.0, step_snr=5.0),
               decoder=dict(true_h_arg=True), tpu=dict(batch=16, checkpoint_path=ck))
    first = _sim(cfg).simulate()
    state = json.load(open(ck))
    assert state["snr"]["10.000"]["done"] and state["snr"]["15.000"]["done"]
    assert set(state["snr"]["10.000"]) == {"tot_blk", "err_blk", "err_bit", "tot_bit",
                                           "chunks", "done", "err_bit_sq"}
    again = _sim(cfg).simulate()
    assert _counts(again) == _counts(first)
    assert all(r.wall_s == 0.0 for r in again)


class Boom(RuntimeError):
    pass


def _killing_factory(device, seed, kill_at):
    """A runner factory whose runner raises Boom at launch ``kill_at``."""
    calls = {"n": 0}

    def factory(spec, batch):
        real = make_chunk_runner(spec, batch, 1, device, seed)

        def run(snr, launch, var):
            if calls["n"] == kill_at:
                raise Boom()
            calls["n"] += 1
            return real(snr, launch, var)

        run.blocks_per_launch = batch
        return run

    return factory


def test_checkpoint_mid_point_resume(assets, tmp_path):
    """Killed mid-point, a sweep resumes from its last consumed launch and
    gives bitwise the counters of an uninterrupted sweep."""
    def cfg(ck):
        return _cfg(assets, range=dict(maximum_block_number=100, maximum_error_number=10**9,
                                       minimum_snr=2.0, maximum_snr=2.0),
                    decoder=dict(true_h_arg=True),
                    tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck))

    ck = str(tmp_path / "ck.json")
    with pytest.raises(Boom):
        _sim(cfg(ck), runner_factory=_killing_factory("cpu", 0, 5)).simulate()
    part = json.load(open(ck))["snr"]["2.000"]
    assert not part["done"]
    assert part["chunks"] == 4  # 5 launches issued, consumption lags one
    assert part["tot_blk"] == part["chunks"] * 8
    resumed = _sim(cfg(ck)).simulate()
    control = _sim(cfg(str(tmp_path / "ck2.json"))).simulate()
    assert _counts(resumed) == _counts(control)


def test_checkpoint_rejects_topology_change(assets, tmp_path):
    """The fingerprint names the runner topology: a sequential checkpoint is
    not merged into a folded resume, which starts fresh and lands on the
    folded control's counters."""
    ck = str(tmp_path / "ck.json")

    def cfg(**tpu):
        return _cfg(assets, range=dict(maximum_block_number=16, maximum_error_number=10**9,
                                       minimum_snr=4.0, maximum_snr=6.0, step_snr=2.0),
                    decoder=dict(true_h_arg=True),
                    tpu=dict(batch=8, chunks_per_launch=1, **tpu))

    _sim(cfg(checkpoint_path=ck)).simulate()
    fp_seq = json.load(open(ck))["fingerprint"]
    folded = _sim(cfg(checkpoint_path=ck, snr_fold=2))
    assert folded._fingerprint() != fp_seq
    assert _counts(folded.simulate()) == _counts(_sim(cfg(snr_fold=2)).simulate())
    assert json.load(open(ck))["fingerprint"] == folded._fingerprint()


def test_cpu_checkpoint_not_resumed_on_cuda(assets, tmp_path):
    """CPU and CUDA generators draw different streams from one seed, and so
    do the JAX package's keys: the fingerprint names the package and the
    device type, so a checkpoint written on the CPU starts a CUDA run
    fresh, with the JAX package's log line."""
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(assets, range=dict(maximum_block_number=8, minimum_snr=4.0, maximum_snr=4.0),
               decoder=dict(true_h_arg=True), tpu=dict(batch=8, checkpoint_path=ck))
    _sim(cfg).simulate()
    state = json.load(open(ck))
    assert state["snr"]["4.000"]["done"] and "kmldpc_torch|cpu|" in state["fingerprint"]
    log = types.SimpleNamespace(lines=[])
    log.info = lambda msg, to_stdout=True: log.lines.append(msg)
    sim = Simulator(cfg, log, device="cpu")
    sim.device = torch.device("cuda")  # what a CUDA run's fingerprint names
    assert "kmldpc_torch|cuda|" in sim._fingerprint()
    assert sim._load_ckpt() == {"fingerprint": sim._fingerprint(), "snr": {}}
    assert "Checkpoint fingerprint mismatch; starting fresh." in log.lines


def test_snr_fold_checkpoint_mid_sweep_resume(assets, tmp_path):
    """Killed in its third dispatch, a folded sweep resumes from the
    per-point launch cursors and gives bitwise the counters of an
    uninterrupted folded sweep."""
    def cfg(ck):
        return _cfg(assets, tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck,
                                     snr_fold=3),
                    **dict(KNOWN3, range=dict(KNOWN3["range"], maximum_block_number=32)))

    ck = str(tmp_path / "ck.json")
    sim = _sim(cfg(ck))
    real, calls = sim.runner, {"n": 0}

    def killing(points, vars_):
        if calls["n"] == 2:
            raise Boom()
        calls["n"] += 1
        return real(points, vars_)

    killing.blocks_per_launch = real.blocks_per_launch
    sim.runner = killing
    with pytest.raises(Boom):
        sim.simulate()
    state = json.load(open(ck))
    assert any(not v["done"] and v["chunks"] > 0 for v in state["snr"].values())
    resumed = _sim(cfg(ck)).simulate()
    control = _sim(cfg(str(tmp_path / "ck2.json"))).simulate()
    assert _counts(resumed) == _counts(control)


@pytest.mark.parametrize("fold", [0, 2], ids=["sequential", "folded"])
def test_histogram_resume_refused(assets, tmp_path, monkeypatch, fold):
    """A guard the JAX package lacks: histogram mode does not resume a point
    that has consumed launches (its file would lose their rows).  A fresh
    run with both knobs works, and so does a resume of finished points."""
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck.json")
    cfg = _cfg(assets, range=dict(maximum_block_number=24, maximum_error_number=10**9,
                                  minimum_snr=16.0, maximum_snr=20.0, step_snr=4.0),
               decoder=dict(true_h_arg=False), histogram=dict(enable=True),
               tpu=dict(batch=8, chunks_per_launch=1, checkpoint_path=ck, snr_fold=fold))
    sim = _sim(cfg)
    real, calls = sim.runner, {"n": 0}

    def killing(*args):
        if calls["n"] == 2:
            raise Boom()
        calls["n"] += 1
        return real(*args)

    killing.blocks_per_launch = real.blocks_per_launch
    sim.runner = killing
    with pytest.raises(Boom):
        sim.simulate()
    with pytest.raises(ValueError, match=r"\[histogram\] enable.*\[tpu\] checkpoint_path"):
        _sim(cfg).simulate()
    os.remove(ck)
    first = _sim(cfg).simulate()
    assert _counts(_sim(cfg).simulate()) == _counts(first)  # finished points restore
    assert all(len(open(f"histogram_{snr:.6f}.txt").readlines()) == 24
               for snr in (16.0, 20.0))


def test_histogram_mode(assets, tmp_path, monkeypatch):
    """Blind histogram mode: one row a block, four metrics, minimum first;
    the final decode is skipped."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(assets, range=dict(maximum_block_number=8, maximum_error_number=10**9),
               decoder=dict(true_h_arg=False), histogram=dict(enable=True),
               tpu=dict(batch=8))
    sim = _sim(cfg)
    assert sim.spec.histogram
    sim.simulate()
    files = [f for f in os.listdir(".") if f.startswith("histogram_")]
    assert len(files) == 1
    rows = [[float(v) for v in line.split()] for line in open(files[0]) if line.strip()]
    assert len(rows) == 8
    for vals in rows:
        assert len(vals) == 4 and vals[0] == min(vals)


def test_histogram_known_h_single_candidate(assets, tmp_path, monkeypatch):
    """Known-h histogram mode runs the selector on the true h: one-metric
    rows (columns 1-3 are NaN and dropped)."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(assets, range=dict(maximum_block_number=8, maximum_error_number=10**9),
               decoder=dict(true_h_arg=True), histogram=dict(enable=True),
               tpu=dict(batch=8))
    sim = _sim(cfg)
    res = sim.runner(20.0, 0, 10 ** -2.0)
    assert res.raw == () and float(res.iters) == 0.0
    assert bool(torch.isnan(res.metrics[:, 1:]).all()) and bool(torch.isfinite(res.metrics[:, 0]).all())
    sim.simulate()
    files = [f for f in os.listdir(".") if f.startswith("histogram_")]
    rows = [line.split() for line in open(files[0]) if line.strip()]
    assert len(rows) == 8 and all(len(r) == 1 for r in rows)


def test_histogram_refuses_metric_prune_as_jax(assets):
    from kmldpc_tpu.sim import chain as jchain

    cfg = _cfg(assets, modem=dict(modem_file="2bits_QPSK.txt"), histogram=dict(enable=True),
               tpu=dict(metric_prune=True))
    with pytest.raises(ValueError) as ours:
        _sim(cfg)
    spec = _sim(_cfg(assets, modem=dict(modem_file="2bits_QPSK.txt"))).spec
    jspec = jchain.ChainSpec(
        code=spec.code, constellation=spec.constellation, known_h=False, fading=True,
        metric_type=False, metric_iter=5, max_iter=50, encoder_active=True, histogram=True,
        metric_prune=True)
    with pytest.raises(ValueError) as ref:
        jchain.build_chain_fn(jspec, 4)
    assert str(ours.value) == str(ref.value)


def test_kmeans_dump_end_to_end(assets, tmp_path):
    """kmeans_dump_dir writes the first launch's first blocks in
    KMeans::DumpToMat's variables: clusters = constellation x hHats[0],
    idx the nearest-cluster assignment."""
    d = str(tmp_path / "km")
    cfg = _cfg(assets, range=dict(maximum_block_number=16, maximum_error_number=10**9),
               decoder=dict(true_h_arg=False), modem=dict(modem_file="4bit_16QAM_Gray.txt"),
               tpu=dict(batch=8, kmeans_dump_dir=d, kmeans_dump_blocks=4))
    sim = _sim(cfg)
    assert sim.spec.kmeans_dump
    sim.run_snr_point(18.0)
    files = sorted(os.listdir(d))
    assert files == [f"kmeans_snr18.000_blk{j}.mat" for j in range(4)]
    from scipy.io import loadmat

    data = loadmat(os.path.join(d, files[0]))
    y, cl, const, h_hats = (np.asarray(data[k]).ravel()
                            for k in ("data", "cluster", "constellations", "hHats"))
    idx = np.asarray(data["idx"]).ravel().astype(int)
    assert y.shape[0] == sim.code.num_col // 4
    assert cl.shape[0] == 16 and const.shape[0] == 16 and h_hats.shape[0] == 4
    np.testing.assert_allclose(cl, const * h_hats[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx, (np.abs(y[:, None] - cl[None, :]) ** 2).argmin(axis=1))
    assert np.asarray(data["realH"]).shape == (1, 1)


def test_profile_dir_writes_trace(assets, tmp_path):
    """profile_dir wraps the sweep in torch.profiler and writes one trace."""
    d = tmp_path / "prof"
    cfg = _cfg(assets, range=dict(maximum_block_number=4, minimum_snr=15.0, maximum_snr=15.0),
               decoder=dict(true_h_arg=True), tpu=dict(batch=4, profile_dir=str(d)))
    rs = _sim(cfg).simulate()
    assert rs[0].tot_blk == 4
    traces = os.listdir(d)
    assert len(traces) == 1 and traces[0].endswith(".trace.json")
    assert json.load(open(d / traces[0]))["traceEvents"]


def test_write_histogram_equals_jax():
    """The histogram writer against the JAX package's, byte for byte, on
    rows with NaN columns, ties and negative values."""
    metrics = np.array([[3.0, 1.5, 2.0, 1.5], [7.0, np.nan, np.nan, np.nan],
                        [0.125, 9.0, -1e-9, 12345678.0], [np.nan] * 4,
                        [2.5e-7, 2.5e-7, 1e30, 4.0]], dtype=np.float32)
    ours, ref = io.StringIO(), io.StringIO()
    Simulator._write_histogram(ours, metrics)
    JaxSimulator._write_histogram(ref, metrics)
    assert ours.getvalue() == ref.getvalue() and ours.getvalue().count("\n") == 5


@pytest.mark.parametrize("metric_type", [False, True], ids=["hard", "soft"])
@pytest.mark.parametrize("blind", [False, True], ids=["known-h", "blind"])
@pytest.mark.parametrize("slot", [None, 1], ids=["sequential", "slot1"])
def test_log_debug_blocks_equals_jax(slot, blind, metric_type):
    """The per-block debug lines against the JAX package's method (called
    with a stub self) on the same values, line for line."""
    rng = np.random.default_rng(3)
    lead = () if slot is None else (3,)
    b = 5
    fields = [rng.normal(size=lead + (b,)).astype(np.float32) for _ in range(2)]
    if blind:
        fields += [rng.normal(size=lead + (b, 4)).astype(np.float32) for _ in range(2)]
    metrics = np.abs(rng.normal(size=lead + (b, 4))).astype(np.float32) * 100
    tot_blk = np.full(lead, b, np.int64) if slot is not None else b
    lines = {}
    for name, method, conv in (("ours", Simulator._log_debug_blocks, torch.from_numpy),
                               ("ref", JaxSimulator._log_debug_blocks, jnp.asarray)):
        out = []
        stub = types.SimpleNamespace(
            spec=types.SimpleNamespace(debug_blocks=3, metric_type=metric_type),
            log=types.SimpleNamespace(info=lambda msg, to_stdout=True, out=out: out.append(msg)))
        res = types.SimpleNamespace(
            tot_blk=conv(np.asarray(tot_blk)) if slot is not None else tot_blk,
            debug=tuple(conv(f) for f in fields), metrics=conv(metrics))
        method(stub, res, 41, slot=slot)
        lines[name] = out
    assert lines["ours"] == lines["ref"]
    assert len(lines["ours"]) == 3 * (7 if blind else 1)


@pytest.mark.parametrize("table", ["2bits_QPSK.txt", "4bit_16QAM_Gray.txt",
                                   "6bits_64QAM_Gray.txt"])
def test_add_diagnostics_equals_jax(assets, table):
    """add_diagnostics over each package's plain estimator on the same
    rows: the candidates and clusters within rtol 1e-6, the assignments
    exact, and the assignments the nearest clusters."""
    const = parse_constellation(str(assets / table))
    rng = np.random.default_rng(5)
    b, nsym = 6, 2304 // const.bits_per_symbol // 2
    idx = rng.integers(0, const.num_points, size=(b, nsym))
    h = (rng.normal(size=(b, 1)) + 1j * rng.normal(size=(b, 1))) * np.sqrt(0.5)
    y = h * const.points[idx] + (rng.normal(size=(b, nsym)) + 1j * rng.normal(size=(b, nsym))) * 0.05
    yr, yi = y.real.astype(np.float32), y.imag.astype(np.float32)
    tables = ModemTables.from_constellation(const)
    ours = add_diagnostics(make_blind_estimator(tables), tables)(
        torch.from_numpy(yr), torch.from_numpy(yi))
    jt = JaxModemTables.from_constellation(const)
    ref = jax_add_diagnostics(jax_make_blind_estimator(jt), jt)(jnp.asarray(yr), jnp.asarray(yi))
    for k in range(4):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7)
    assert ours[4].dtype == torch.int32
    np.testing.assert_array_equal(ours[4].numpy(), np.asarray(ref[4]))
    cl = ours[2].numpy() + 1j * ours[3].numpy()
    d2 = np.abs(y[:, :, None] - cl[:, None, :]) ** 2
    np.testing.assert_array_equal(ours[4].numpy(), d2.argmin(axis=-1))


def test_dump_kmeans_equals_jax(assets, tmp_path):
    """records.dump_kmeans writes the JAX package's file: the same variables
    with the same values and types."""
    from scipy.io import loadmat

    const = parse_constellation(str(assets / "4bit_16QAM_Gray.txt"))
    rng = np.random.default_rng(6)
    args = (rng.normal(size=8) + 1j * rng.normal(size=8),
            const.points * (0.3 - 0.7j), rng.integers(0, 16, size=8).astype(np.int32),
            const.points, rng.normal(size=4) + 1j * rng.normal(size=4), complex(0.25, -1.5))
    a = loadmat(dump_kmeans(str(tmp_path / "ours"), *args))
    b = loadmat(jax_dump_kmeans(str(tmp_path / "ref"), *args))
    names = ["data", "cluster", "idx", "constellations", "hHats", "realH"]
    assert sorted(k for k in a if not k.startswith("__")) == sorted(names)
    for k in names:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
