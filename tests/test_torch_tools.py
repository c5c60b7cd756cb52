"""kmldpc_torch's measurement tools (``kmldpc_torch/tools/``) against the
JAX side's ``tools/microbench.py``, ``snrfold_bench.py``, ``locality.py``
and ``scaling.py``: the same harness, keys, fields and lines, at tiny sizes
on the CPU.  Codes load through ``kmldpc_torch.code`` only; the JAX tools'
row builders run with their timing replaced, so nothing of theirs is
compiled.  Multi-rank cases start gloo ranks on the CPU, each launch killed
after 120 s (``tests/test_torch_parallel.py``'s launcher).
"""

import ast
import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import kmldpc_tpu.code as jax_code
import tools.locality as jax_locality
import tools.microbench as jax_microbench
import tools.snrfold_bench as jax_snrfold
from kmldpc_tpu.code.ldpc import compile_code as jax_compile_code
from kmldpc_tpu.io import parse_hmatrix as jax_parse_hmatrix
from kmldpc_torch.code import load_code
from kmldpc_torch.tools import locality, microbench, snrfold_bench
from tools.rows import pick_n2 as rows_pick_n2

from .test_torch_parallel import _launch_many

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CODES = [("5G-BG2-K960", "5GLDPCBG2a3_R12_K960.txt"), ("PEG2304", "PEG2304regular0.5.txt")]


@pytest.fixture(autouse=True)
def _one_thread():
    # one thread per worker process, restored after the test: other test
    # files share the worker
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """A fake ``time.perf_counter``: each read costs ``read_cost``, each
    call of :meth:`fn` ``per_call`` (plus ``extra[i]`` for call index i).
    Binary-exact costs keep every difference exact."""

    def __init__(self, per_call: float, read_cost: float, extra: dict | None = None):
        self.now, self.per_call, self.read_cost = 0.0, per_call, read_cost
        self.extra, self.calls = extra or {}, []

    def read(self) -> float:
        self.now += self.read_cost
        return self.now

    def fn(self, i: int):
        self.calls.append(i)
        self.now += self.per_call + self.extra.get(i, 0.0)
        return torch.zeros(())


def _both_steady(monkeypatch, clock_args: dict, **kw):
    """``steady`` of the port and of the JAX tool on one fake clock each:
    their results and the call indices each made."""
    out = []
    for mod in (microbench, jax_microbench):
        clock = _Clock(**clock_args)
        monkeypatch.setattr(mod.time, "perf_counter", clock.read)
        fn = clock.fn if mod is microbench else (lambda i, c=clock: c.fn(i).numpy())
        out.append((mod.steady(fn, **kw), clock.calls))
    return out


@pytest.mark.parametrize("passes", [1, 3])
def test_steady_slope_is_exact_and_matches_the_jax_harness(monkeypatch, passes):
    """A fixed 1.5 s a run cancels in the two-point slope, which is the
    0.25 s a call exactly; the first calls' 5 s of warm-up run inside the
    adaptive probes; n2 comes from pick_n2 (18 here); every call gets its
    own index; the JAX tool's steady makes the same calls and returns the
    same numbers."""
    slow = {1000 + k: 5.0 for k in range(4)}
    (ours, calls), (ref, ref_calls) = _both_steady(
        monkeypatch, dict(per_call=0.25, read_cost=1.5, extra=slow), passes=passes)
    assert ours == (0.25, 0.0) == ref
    assert calls == ref_calls and len(set(calls)) == len(calls)
    probes = [i for i in calls if i < 2000]
    assert probes == list(range(1000, 1012))  # 4 probes of 3: the 4th agrees with the 3rd
    assert len(calls) == len(probes) + passes * (6 + 18)


def test_steady_retries_a_stalled_pass(monkeypatch):
    """A stall in the first short run makes its slope negative: the pass is
    discarded and retried; where every pass stalls, steady returns the long
    run's time per call."""
    (ours, calls), (ref, ref_calls) = _both_steady(
        monkeypatch, dict(per_call=0.25, read_cost=1.5, extra={2000: 100.0}), n2=20)
    assert ours == (0.25, 0.0) == ref and calls == ref_calls
    assert [i for i in calls if i >= 2000] == [*range(2000, 2006), *range(3000, 3020),
                                               *range(2200, 2206), *range(3200, 3220)]
    stalls = {2000: 100.0, 2200: 100.0}
    (ours, _), (ref, _) = _both_steady(
        monkeypatch, dict(per_call=0.25, read_cost=1.5, extra=stalls), n2=20)
    assert ours == ref == ((20 * 0.25 + 1.5) / 20, 0.0)


def test_pick_n2_copy_equals_the_rows_module():
    ests = [0.0, -1.0, 1e-7, 1e-5, 3e-4, 1e-3, 4.2e-3, 0.01, 0.02, 0.05, 0.1, 0.35, 0.5, 1.0, 7.0]
    for n1 in (2, 4, 6, 10):
        assert [microbench.pick_n2(e, n1) for e in ests] == [rows_pick_n2(e, n1) for e in ests]


@pytest.fixture
def jax_rows(monkeypatch):
    """The rows the JAX tool builds (``bench_decoders`` and
    ``bench_kmeans``), with its timing replaced by a constant and codes
    loaded through kmldpc_torch.code (the JAX tool's decoder tables take
    them as they are)."""
    monkeypatch.setattr(jax_microbench, "steady", lambda fn, passes=1: (1e-3, 0.0))
    monkeypatch.setattr(jax_code, "load_code", load_code)
    results: dict = {}
    jax_microbench.bench_decoders(results, batch=4, iters=2)
    jax_microbench.bench_kmeans(results, batch=4, nsym=96)
    return results


def _fields(rows: dict) -> dict:
    return {k: sorted(v) for k, v in rows.items()}


def test_decoder_group_rows_equal_the_jax_tools(jax_rows):
    """The decoder group at B = 4, 2 iterations on 5G BG2 K=960 and
    PEG2304: the JAX tool's keys, fields, batch and iterations, and a
    positive, finite time for each row."""
    ours: dict = {}
    microbench.bench_decoders(ours, batch=4, iters=2, device="cpu", codes=SMALL_CODES,
                              n1=2, n2=4)
    names = tuple(f"decoder/{n}/" for n, _ in SMALL_CODES)
    want = {k: v for k, v in jax_rows.items() if k.startswith(names)}
    assert list(ours) == list(want)
    assert {"decoder/5G-BG2-K960/minsum[generic]", "decoder/PEG2304/minsum[generic]"} <= set(ours)
    assert _fields(ours) == _fields(want)
    for k, row in ours.items():
        assert (row["batch"], row["iters"]) == (want[k]["batch"], want[k]["iters"]) == (4, 2)
        assert math.isfinite(row["us_per_iter"]) and row["us_per_iter"] > 0


def test_kmeans_group_rows_equal_the_jax_tools(jax_rows):
    """The k-means group at B = 4 on the CPU: one ``plain`` row a
    constellation where the JAX tool on the CPU builds its ``jax`` row (K1's
    ``cuda`` row, like the JAX tool's ``pallas`` row, needs the card), with
    its fields, batch and symbols."""
    ours: dict = {}
    microbench.bench_kmeans(ours, batch=4, nsym=96, device="cpu", n1=2, n2=4)
    want = {k.replace("/jax", "/plain"): v for k, v in jax_rows.items()
            if k.startswith("kmeans/")}
    assert list(ours) == list(want) == [f"kmeans/{c}/plain" for c in ("QPSK", "16QAM", "64QAM")]
    assert _fields(ours) == _fields(want)
    for k, row in ours.items():
        assert (row["batch"], row["nsym"]) == (want[k]["batch"], want[k]["nsym"])
        assert math.isfinite(row["us_per_call"]) and row["us_per_call"] > 0


def test_diff_against_returns_what_the_jax_tools_does(tmp_path, capsys):
    base = {
        "device": "a",
        "_calibration": {"factor": 1.0},
        "decoder/PEG2304/flooding": {"us_per_iter": 100.0, "spread_pct": 1.0},
        "kmeans/QPSK/plain": {"us_per_call": 80.0, "spread_pct": 0.0},
        "chain/x": {"blocks_per_s": 1000.0, "calibrated": 900.0},
        "chain/y": {"blocks_per_s": 2000.0},
        "gone": {"us_per_iter": 5.0},
        "zero": {"us_per_iter": 0.0},
    }
    new = {
        "device": "b",
        "decoder/PEG2304/flooding": {"us_per_iter": 120.0, "spread_pct": 2.0},
        "kmeans/QPSK/plain": {"us_per_call": 60.0, "spread_pct": 0.0},
        "chain/x": {"blocks_per_s": 1100.0, "calibrated": 850.0},
        "chain/y": {"blocks_per_s": 1500.0},
        "added": {"us_per_call": 3.0},
        "zero": {"us_per_iter": 1.0},
    }
    path = tmp_path / "base.json"
    path.write_text(json.dumps(base))
    ours = microbench.diff_against(new, str(path))
    ours_err = capsys.readouterr().err
    ref = jax_microbench.diff_against(new, str(path))
    assert ours == ref and ours_err == capsys.readouterr().err
    assert {r["row"]: r.get("note") for r in ours if "note" in r} == {
        "added": "NEW", "gone": "MISSING (was in baseline)"}


def test_snrfold_bench_counts_bitwise_with_the_jax_keys():
    """16 blocks a point at B = 8: the JAX tool's config, runs, keys and
    fields; the sequential and folded counters are bitwise equal (the tool
    raises otherwise)."""
    for fold in (0, 7):
        ours, ref = snrfold_bench.build_cfg(fold, 16, 8), jax_snrfold.build_cfg(fold, 16, 8)
        a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
        assert {k: v for k, v in a.items() if k != "asset_dir"} == {
            k: v for k, v in b.items() if k != "asset_dir"}
        assert os.path.samefile(ours.matrix_path(), ref.matrix_path())
    with open(jax_snrfold.__file__) as f:
        consts = {n.value for n in ast.walk(ast.parse(f.read()))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    fields = ["wall_s", "points", "blocks"]
    assert {"sequential", "folded7", "snrfold/speedup", *fields} <= consts
    res = snrfold_bench.run(16, 8, "cpu")
    assert list(res) == ["device", "snrfold/sequential", "snrfold/folded7", "snrfold/speedup"]
    for name in ("sequential", "folded7"):
        assert list(res[f"snrfold/{name}"]) == fields
        assert res[f"snrfold/{name}"]["points"] == 7 and res[f"snrfold/{name}"]["blocks"] == 112
    assert res["snrfold/speedup"] > 0


def test_rcm_relabel_and_band_stats_equal_the_jax_tools(assets):
    """PEG2304: the same RCM labels and edge tables as the JAX tool (its
    code compiled without the disk cache), the same band statistics, and
    the relabelled graph decodes noiseless codewords back to themselves."""
    ours_code = load_code(str(assets / "PEG2304regular0.5.txt"))
    ref_code = jax_compile_code(jax_parse_hmatrix(str(assets / "PEG2304regular0.5.txt")),
                                "PEG2304regular0.5")
    ours, rinv, cinv = locality.rcm_relabel(ours_code)
    ref, ref_rinv, ref_cinv = jax_locality.rcm_relabel(ref_code)
    assert np.array_equal(rinv, ref_rinv) and np.array_equal(cinv, ref_cinv)
    for f in ("edge_col", "edge_row", "col_edge_idx", "col_mask", "row_edge_idx", "row_mask",
              "edge_rowslot", "row_edge_col"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for c, r in ((ours_code, ref_code), (ours, ref)):
        assert locality.band_stats(c) == jax_locality.band_stats(r)
    assert locality.band_stats(ours)["mean_band"] < locality.band_stats(ours_code)["mean_band"]
    locality.check_relabelled(ours_code, ours, cinv, torch.device("cpu"))
    with pytest.raises(ValueError, match="unpunctured"):
        locality.rcm_relabel(load_code(str(assets / "5GLDPCBG2a3_R12_K960.txt")))


def test_locality_rows_carry_the_jax_tools_keys():
    res = locality.run("PEG2304regular0.5.txt", batch=4, iters=2, passes=1, device="cpu",
                       n1=2, n2=4)
    rows = [f"locality/PEG2304regular0/{rule}/{label}"
            for rule in ("minsum", "sumprod") for label in ("orig", "rcm")]
    assert list(res) == ["device", "band/orig", "band/rcm", *rows]
    for k in rows:
        assert list(res[k]) == ["us_per_iter", "spread_pct", "batch", "iters"]
        assert res[k]["us_per_iter"] > 0


def test_scaling_data_and_edge_modes_on_two_ranks():
    """Both modes on 2 gloo CPU ranks: rank 0 prints the JAX tool's lines
    for 1 and 2 ranks (data) and row shards (edge), after the backend and
    the note that shared hardware checks the mechanism; rank 1 prints
    nothing."""
    data, edge = _launch_many([
        (2, ["-m", "kmldpc_torch.tools.scaling", "4", "--device", "cpu"]),
        (2, ["-m", "kmldpc_torch.tools.scaling", "edge", "4", "--device", "cpu"]),
    ])
    for out in (data, edge):
        assert out[1] == ""
        lines = out[0].splitlines()
        assert lines[0] == "devices available: 2 (cpu)"
        assert lines[1].startswith("backend: gloo, 2 CPU ranks;") and "mechanism" in lines[1]
    assert [re.fullmatch(r"mesh=\s+(\d+)  global_batch=\s+(\d+)\s+\d+ blk/s  "
                         r"efficiency\s+[\d.]+%", x).groups()
            for x in data[0].splitlines()[2:]] == [("1", "4"), ("2", "8")]
    assert [re.fullmatch(r"row shards=\s+(\d+)\s+[\d.]+ ms / 20-iter decode \(B=4\)  "
                         r"speedup\s+[\d.]+x", x).group(1)
            for x in edge[0].splitlines()[2:]] == ["1", "2"]


def test_microbench_process_loads_neither_jax_nor_kmldpc_tpu_nor_tools(tmp_path):
    """``python -m kmldpc_torch.tools.microbench decoder --device cpu`` at
    B = 4 and 2 iterations in a fresh process: every decoder row of the
    three codes, and no jax, kmldpc_tpu or tools module loaded."""
    prog = (
        "import runpy, sys\n"
        "sys.argv = ['microbench', 'decoder', '--device', 'cpu', '--batch', '4', "
        "'--iters', '2', '--json', 'mb.json']\n"
        "try:\n"
        "    runpy.run_module('kmldpc_torch.tools.microbench', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'kmldpc_tpu', 'tools'))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "loaded: []"
    rows = json.loads((tmp_path / "mb.json").read_text())
    assert rows["device"] == "cpu" and len(rows) == 1 + 4 + 5 + 4  # PEG8064, 5G, PEG2304
    assert "microbench: device=cpu" in out.stderr
