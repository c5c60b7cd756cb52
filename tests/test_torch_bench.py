"""kmldpc_torch.bench, the port's benchmark, against the repo's ``bench.py``:
the same slope measurement under one scripted clock, the same row plan, and
the one-line result, at tiny sizes on the CPU.  ``bench.py`` runs
with its clock and its runner replaced, so nothing of it is compiled beyond
``jax.random.fold_in``.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from kmldpc_torch import bench
from tools.rows import bench_rows as jax_bench_rows
from tools.rows import calibration_row as jax_calibration_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = ["row", "blocks_per_s", "info_bits_per_s", "calibrated", "spread_pct", "batch",
            "chunks_per_launch", "snr_db", "schedule"]
LINE_KEYS = ["metric", "value", "unit", "vs_baseline"]


class _Clock:
    """A scripted ``time.perf_counter``: each read costs ``read_cost``, call
    ``i`` costs ``per_call`` plus ``extra[i]``.  Binary-exact costs keep
    every difference exact.  Records the call indices and each run's
    length (the calls between a run's two reads)."""

    def __init__(self, per_call: float, read_cost: float, extra: dict):
        self.now, self.per_call, self.read_cost, self.extra = 0.0, per_call, read_cost, extra
        self.calls, self.runs, self._mark = [], [], None

    def read(self) -> float:
        if self._mark is None:
            self._mark = len(self.calls)
        else:
            self.runs.append(len(self.calls) - self._mark)
            self._mark = None
        self.now += self.read_cost
        return self.now

    def tick(self, i: int) -> None:
        self.calls.append(i)
        self.now += self.per_call + self.extra.get(i, 0.0)


@pytest.fixture(scope="module")
def fold_index():
    """``bench.py`` hands its runner ``fold_in(key(0), i)``: the call index
    each folded key stands for."""
    key = jax.random.key(0)
    data = jax.vmap(lambda j: jax.random.key_data(jax.random.fold_in(key, j)))(
        jnp.arange(6000))
    return {tuple(int(x) for x in row): j for j, row in enumerate(np.asarray(data))}


def _both_measure(monkeypatch, fold_index, extra: dict, passes: int):
    """``measure`` of the port and of ``bench.py``, each on a scripted clock
    of its own: their results, call indices and run lengths."""
    out = []
    for mod in (bench, jax_bench):
        clock = _Clock(0.25, 1.5, extra)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=clock.read))
        if mod is bench:
            def call(i, clock=clock):
                clock.tick(i)
                return torch.zeros(())
            res = bench.measure(call, passes)
        else:
            def runner(k, var, clock=clock):
                clock.tick(fold_index[tuple(int(x) for x in np.asarray(jax.random.key_data(k)))])
                return jnp.zeros(())
            res = jax_bench.measure(runner, jax.random.key(0), np.float32(0.1), passes)
        out.append((res, clock.calls, clock.runs))
    return out


SCRIPTS = {
    # slow first calls in the warm-up, then passes of slopes 0.3125, 0.25, 0.375
    "steady": ({**{i: 5.0 for i in range(4)}, 5000: 0.5, 5200: 1.0}, 3),
    "steady-one-pass": ({i: 5.0 for i in range(4)}, 1),
    # the first short run stalls: its slope is negative, the pass is retried
    "stall": ({1000: 100.0}, 3),
    # every short run stalls: the last long run's time a call, spread 0
    "no-positive-slope": ({1000 + 100 * p: 100.0 for p in range(6)}, 3),
}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_measure_equals_bench_py(monkeypatch, fold_index, script):
    """The same (seconds a call, spread), call indices and run lengths as
    ``bench.py::measure`` on the same script."""
    extra, passes = SCRIPTS[script]
    (ours, calls, runs), (ref, ref_calls, ref_runs) = _both_measure(
        monkeypatch, fold_index, extra, passes)
    assert ours == ref and calls == ref_calls and runs == ref_runs
    want = {
        "steady": ((0.3125, 40.0), 4, [4, 12] * 3),
        "steady-one-pass": ((0.25, 0.0), 4, [4, 12]),
        "stall": ((0.25, 0.0), 3, [4, 12] * 4),
        "no-positive-slope": (((12 * 0.25 + 1.5) / 12, 0.0), 3, [4, 12] * 6),
    }[script]
    (sec, spread), probes, timed = want
    assert ours[0] == sec and ours[1] == pytest.approx(spread)
    # warm-up probes of 3 calls at bases 3i, then the passes' short and long runs
    assert runs == [3] * probes + timed and calls[:3 * probes] == list(range(3 * probes))


@pytest.mark.parametrize("env", [{}, {"KMLDPC_BENCH_BATCH": "256"}, {"KMLDPC_BENCH_CPL": "4"},
                                 {"KMLDPC_BENCH_BATCH": "64", "KMLDPC_BENCH_CPL": "2"}])
def test_row_plan_equals_bench_py(monkeypatch, env):
    """The calibration row, then the ranked rows without it, each with
    bench.py's batch and chunks a launch under the environment's knobs."""
    for k in ("KMLDPC_BENCH_BATCH", "KMLDPC_BENCH_CPL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    batch_env = int(env.get("KMLDPC_BENCH_BATCH", "1024"))
    cpl_env = int(env.get("KMLDPC_BENCH_CPL", "16"))
    cal = jax_calibration_row()
    rows = [cal] + [r for r in jax_bench_rows() if r.name != cal.name]
    want = [(r.name, r.batch or batch_env, r.cpl or cpl_env, r.snr_db, r.schedule)
            for r in rows]
    plan = bench.row_plan()
    assert [(r.name, b, c, r.snr_db, r.schedule) for r, b, c in plan] == want
    assert len(plan) == 8 and plan[1][0].name == "PEG2304+QPSK/blind"
    assert [r.bench_rank for r, _, _ in plan] == [1, 0, 2, 3, 4, 5, 6, 7]
    assert [(b, c) for _, b, c in bench.row_plan(2, 1)] == [(2, 1)] * 8


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_main_prints_the_result_line_and_writes_its_own_rows(monkeypatch, capsys, tmp_path):
    """At budget 0, with ``measure`` stubbed to 0.25 s a call: the two
    mandatory rows, six SKIPPED lines, bench.py's row keys, the four-key
    stdout line computed by hand, and the rows file at ``--rows-out`` with
    ``_calibration``, ``_baseline`` and ``_cut``; the TPU's record is
    untouched."""
    record = os.path.join(REPO, "benchmarks", "bench_rows_latest.json")
    before = _sha(record)
    passes = []
    monkeypatch.setattr(bench, "measure", lambda call, p: passes.append(p) or (0.25, 1.5))
    monkeypatch.setenv("KMLDPC_BENCH_BUDGET_S", "0")
    out = tmp_path / "rows.json"
    assert bench.main(["--device", "cpu", "--batch", "2", "--cpl", "1",
                       "--rows-out", str(out)]) == 0
    cap = capsys.readouterr()
    err = cap.err.splitlines()
    assert err[0].startswith("bench: device=cpu batch=1024 budget=0s cut batch=2 cpl=1")
    plan = bench.row_plan()
    assert [x for x in err if x.startswith("bench: SKIPPED ")] == [
        x for x in err if "SKIPPED" in x]
    assert [x.split()[2] for x in err if "SKIPPED" in x] == [r.name for r, _, _ in plan[2:]]
    rows = [json.loads(x.removeprefix("bench-row ")) for x in err if x.startswith("bench-row ")]
    assert [r["row"] for r in rows] == ["PEG2304+QPSK/known", "PEG2304+QPSK/blind"]
    assert all(list(r) == ROW_KEYS for r in rows) and passes == [3, 3]
    blk_s, factor = 2 / 0.25, 2 / 0.25 / bench.CAL_NOMINAL_BLK_S
    for r in rows:
        assert (r["blocks_per_s"], r["info_bits_per_s"], r["spread_pct"]) == (8.0, 9216.0, 1.5)
        assert r["calibrated"] == round(blk_s / factor, 1)
        assert (r["batch"], r["chunks_per_launch"], r["snr_db"], r["schedule"]) == (
            2, 1, 15.0, "flooding")
    assert any("GCP VM, 2 vCPU" in x and "vs_baseline" in x for x in err)
    lines = cap.out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == LINE_KEYS
    assert line == {"metric": _bench_py_metric(), "value": 9216.0, "unit": "info_bits/s",
                    "vs_baseline": round(9216.0 / 341568.0, 2)}
    written = json.loads(out.read_text())
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        baseline = json.load(f)
    assert list(written) == ["device", "_cut", "_calibration", "PEG2304+QPSK/known",
                             "PEG2304+QPSK/blind", "_baseline"]
    assert written["device"] == "cpu" and written["_cut"] == {"batch": 2, "cpl": 1}
    assert written["_calibration"] == {
        "row": "PEG2304+QPSK/known", "blocks_per_s": 8.0,
        "nominal_blocks_per_s": bench.CAL_NOMINAL_BLK_S, "factor": round(factor, 4)}
    assert written["_baseline"] == {"file": "BASELINE_MEASURED.json",
                                    "machine": baseline["machine"],
                                    "info_bits_per_s": baseline["blind"]["info_bits_per_s"]}
    assert written["PEG2304+QPSK/blind"] == {k: v for k, v in rows[1].items() if k != "row"}
    assert _sha(record) == before


def _bench_py_metric() -> str:
    """The metric string of ``bench.py``'s stdout line, read from its source."""
    with open(jax_bench.__file__) as f:
        tree = ast.parse(f.read())
    return next(v.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
                for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant) and k.value == "metric")


@pytest.mark.parametrize("fail_at", [0, 1])
def test_a_failed_calibration_or_headline_ends_with_no_line(monkeypatch, capsys, tmp_path,
                                                            fail_at):
    """A calibration (row 0) or headline (row 1) that raises ends ``main``
    with the error and nothing on stdout; no rows file is written."""
    seen = []

    def measure(call, passes):
        seen.append(call)
        if len(seen) - 1 == fail_at:
            raise RuntimeError("launch failed")
        return 0.25, 0.0

    monkeypatch.setattr(bench, "measure", measure)
    monkeypatch.setenv("KMLDPC_BENCH_BUDGET_S", "0")
    out = tmp_path / "rows.json"
    with pytest.raises(RuntimeError, match="launch failed"):
        bench.main(["--device", "cpu", "--batch", "2", "--cpl", "1", "--rows-out", str(out)])
    assert capsys.readouterr().out == "" and not out.exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--rows-out", str(tmp_path / "rows.json")])
    assert not (tmp_path / "rows.json").exists()


def test_bench_process_prints_one_line_and_loads_no_jax(tmp_path):
    """``python -m kmldpc_torch.bench --device cpu --batch 2 --cpl 1
    --passes 1`` at budget 0 in a fresh process, killed after 120 s: exit
    0, one JSON line on stdout whose value is the headline row's info
    bits/s, and no jax, kmldpc_tpu or tools module imported."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", KMLDPC_BENCH_BUDGET_S="0")
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "kmldpc_torch.bench", "--device", "cpu",
         "--batch", "2", "--cpl", "1", "--passes", "1", "--rows-out", "rows.json"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == LINE_KEYS and line["value"] > 0 and line["vs_baseline"] >= 0
    err = out.stderr.splitlines()
    rows = {r["row"]: r for r in (json.loads(x.removeprefix("bench-row "))
                                  for x in err if x.startswith("bench-row "))}
    assert list(rows) == ["PEG2304+QPSK/known", "PEG2304+QPSK/blind"]
    assert line["value"] == rows["PEG2304+QPSK/blind"]["info_bits_per_s"]
    assert sum("bench: SKIPPED" in x for x in err) == 6
    imported = {x.split("|")[-1].strip().split(".")[0] for x in err if x.startswith("import time:")}
    assert "kmldpc_torch" in imported
    assert not imported & {"jax", "jaxlib", "kmldpc_tpu", "tools"}
    assert json.loads((tmp_path / "rows.json").read_text())["_cut"] == {
        "batch": 2, "cpl": 1, "passes": 1}
