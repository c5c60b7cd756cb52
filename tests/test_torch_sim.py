"""kmldpc_torch harness, CLI, device rule, ported and refused knobs, every
shipped config, and the no-jax rule."""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from kmldpc_tpu.config import load_config as jax_load_config
from kmldpc_tpu.sim import chain as jchain
from kmldpc_torch.code import load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.io import parse_constellation
from kmldpc_torch.parallel.distributed import data_ranks, layout
from kmldpc_torch.sim.chain import ChainSpec, make_chunk_runner
from kmldpc_torch.utils import SimLogger
from kmldpc_torch import resolve_device
from kmldpc_torch.sim import Simulator

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted([*REPO.glob("configs/*.toml"), *REPO.glob("benchmarks/parity/configs/*.toml")])
# the shipped configs the port still refuses, and the ROADMAP.md Queue 1
# item each names: none since the multi-device runs were ported
REFUSED: dict[str, str] = {}


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


def test_stopping_rule_max_blocks(assets):
    """As tests/test_sim.py: the in-flight launch counts toward the cap."""
    cfg = _cfg(assets, range=dict(maximum_block_number=50, maximum_error_number=10**9),
               decoder=dict(true_h_arg=True), tpu=dict(batch=16))
    sim = Simulator(cfg, _quiet(), device="cpu")
    r = sim.run_snr_point(15.0)
    assert r.tot_blk == 64 and sim.batch == 16
    assert r.tot_bit == 64 * 1152


def test_stopping_rule_max_errors(assets):
    """As tests/test_sim.py: the error cap overruns by the in-flight launch."""
    cfg = _cfg(assets, range=dict(maximum_block_number=10**6, maximum_error_number=5),
               decoder=dict(true_h_arg=True), tpu=dict(batch=32, chunks_per_launch=1))
    r = Simulator(cfg, _quiet(), device="cpu").run_snr_point(-5.0)
    assert r.tot_blk == 64  # stop chunk + one in-flight chunk
    assert r.err_blk >= 5
    assert r.fer == r.err_blk / r.tot_blk


def test_blind_sweep_is_deterministic(assets):
    cfg = _cfg(assets, range=dict(maximum_block_number=16, minimum_snr=12.0,
                                  maximum_snr=14.0, step_snr=2.0),
               tpu=dict(batch=8, snr_fold=8))
    runs = [Simulator(cfg, _quiet(), device="cpu").simulate() for _ in range(2)]
    assert [dataclasses.astuple(r)[:7] for r in runs[0]] == [
        dataclasses.astuple(r)[:7] for r in runs[1]
    ]
    assert [r.tot_blk for r in runs[0]] == [16, 16]


@pytest.mark.parametrize(
    "over",
    [
        dict(xcodec=dict(metric_type=True)),
        dict(tpu=dict(schedule="flooding-minsum")),
        dict(tpu=dict(metric_schedule="match")),
        dict(tpu=dict(metric_schedule="match", schedule="flooding-minsum"),
             xcodec=dict(metric_type=True)),
        dict(tpu=dict(metric_prune=True), modem=dict(modem_file="2bits_QPSK.txt")),
        dict(ldpc=dict(matrix_file="5GLDPCBG2a3_R12_K960.txt")),
        dict(tpu=dict(schedule="layered-minsum"),
             ldpc=dict(matrix_file="5GLDPCBG2a3_R12_K960.txt")),
        dict(tpu=dict(dtype="bfloat16")),
    ],
    ids=["soft-metric", "flooding-minsum", "match", "match-minsum-soft", "metric-prune-qpsk",
         "5g-matrix", "layered-minsum", "bf16"],
)
def test_ported_knobs_run(assets, over):
    """Each knob the port once refused: a Simulator on the CPU runs one
    chunk of 4 blocks at 15 dB (assets/config.toml: blind 16QAM)."""
    cfg = _cfg(assets, **{**over, "range": dict(maximum_block_number=4),
                          "tpu": dict(batch=4, **over.get("tpu", {}))})
    sim = Simulator(cfg, _quiet(), device="cpu")
    r = sim.run_snr_point(15.0)
    assert r.tot_blk == 4 and r.tot_bit == 4 * sim.code.code_dim
    assert sim.code.code_dim == (960 if "ldpc" in over else 1152)


def test_metric_prune_refuses_16qam_as_jax(assets):
    """metric_prune on a table that is not complement-closed: the port
    raises the JAX package's ValueError."""
    cfg = _cfg(assets, tpu=dict(metric_prune=True))
    with pytest.raises(ValueError, match="complement-closed") as ours:
        Simulator(cfg, _quiet(), device="cpu")
    code = load_code(cfg.matrix_path())
    jspec = jchain.ChainSpec.from_config(
        jax_load_config(str(assets / "config.toml")), code,
        parse_constellation(cfg.modem_path()))
    jspec = dataclasses.replace(jspec, metric_prune=True)
    with pytest.raises(ValueError) as ref:
        jchain.build_chain_fn(jspec, 4)
    assert str(ours.value) == str(ref.value)


def test_bad_dtype_raises_as_jax(assets):
    """An unknown [tpu] dtype: the port raises the JAX package's ValueError."""
    cfg = _cfg(assets, tpu=dict(dtype="float16"))
    with pytest.raises(ValueError, match="tpu.dtype") as ours:
        Simulator(cfg, _quiet(), device="cpu")
    code = load_code(cfg.matrix_path())
    jspec = jchain.ChainSpec.from_config(
        jax_load_config(str(assets / "config.toml")), code,
        parse_constellation(cfg.modem_path()))
    jspec = dataclasses.replace(jspec, dtype="float16")
    with pytest.raises(ValueError) as ref:
        jchain.build_chain_fn(jspec, 4)
    assert str(ours.value) == str(ref.value)


def _open_queue1_items() -> list[str]:
    """Titles of the items ROADMAP.md's Queue 1 lists as still lacking."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text[text.index("### Queue 1"):text.index("### Queue 2")]
    lacking = queue[queue.index("**Still lacking"):]
    return re.findall(r"^\d+\. \*\*(.+?)\.\*\*", lacking, re.M)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_config_builds_or_names_an_open_item(path):
    """Every config in configs/ and benchmarks/parity/configs/ gives a
    ChainSpec, or a NotImplementedError naming a Queue 1 item that
    ROADMAP.md still lists as open."""
    cfg = load_config(str(path))
    args = cfg, load_code(cfg.matrix_path()), parse_constellation(cfg.modem_path())
    if path.name not in REFUSED:
        assert ChainSpec.from_config(*args).max_iter == cfg.ldpc.max_iter
        return
    with pytest.raises(NotImplementedError) as e:
        ChainSpec.from_config(*args)
    item = re.search(r"ROADMAP\.md Queue 1, '(.+?)'", str(e.value)).group(1)
    assert item == REFUSED[path.name]
    assert item in _open_queue1_items()


def test_roadmap_lists_multi_device_as_done():
    """ROADMAP.md's Queue 1 still parses, and no longer lists the ported
    multi-device item among the lacking ones."""
    assert "multi-device" not in _open_queue1_items()


@pytest.mark.parametrize(
    "section,kv,grid",
    [
        ("tpu", dict(model_parallel=2), "mesh (1 data x 2 model)"),
    ],
)
def test_unported_knobs_raise(assets, section, kv, grid):
    """The rank layout the port refuses, as JAX's get_mesh_2d does: a
    model-parallel mesh above the ranks raises the JAX package's ValueError
    in a one-rank process, naming the ranks to start."""
    cfg = _cfg(assets, **{section: kv})
    with pytest.raises(ValueError) as e:
        Simulator(cfg, _quiet(), device="cpu")
    assert str(e.value).startswith(f"{grid} needs 2 devices, have 1 ")
    assert "start 2 ranks" in str(e.value)


@pytest.mark.parametrize("ndata,world,ranks", [
    (1, 1, 1), (2, 1, 1), (2, 2, 2), (2, 8, 2), (4, 1, 1), (4, 2, 2), (4, 3, 2), (4, 4, 4),
    (6, 4, 3), (6, 5, 3), (8, 8, 8), (3, 2, 1), (8, 6, 4),
])
def test_data_shards_run_on_the_largest_divisor_the_ranks_hold(ndata, world, ranks):
    """A data-parallel layout of ``ndata`` shards on ``world`` ranks runs
    on the largest divisor of ``ndata`` the ranks hold; the layout itself
    keeps its shards, as the JAX harness keeps ``ndev``."""
    assert data_ranks(ndata, world) == ranks
    assert layout(ndata, 0, world, 1024) == (ndata, 1)


# two blind 16QAM points (assets/config.toml) of three launches, each of two
# sub-chunks of 16 codewords, at SNRs with block errors in most launches
DP_SWEEP = dict(range=dict(minimum_snr=8.0, maximum_snr=10.0, step_snr=2.0,
                           maximum_block_number=96, maximum_error_number=10**9),
                tpu=dict(batch=16, chunks_per_launch=2))
# one rank of a run: the Simulator on the config assets/config.toml with the
# overrides of a JSON file, run in the output directory, which takes its
# histogram files; prints whether the rank is in the layout, then its
# per-point counters as JSON
RANK_SCRIPT = """
import dataclasses, json, os, sys

sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist

from kmldpc_torch.config import load_config
from kmldpc_torch.parallel import maybe_initialize
from kmldpc_torch.sim import Simulator
from kmldpc_torch.utils import SimLogger

torch.set_num_threads(1)
over_path, out = sys.argv[1:]
with open(over_path) as f:
    over = json.load(f)
cfg = load_config(over.pop("config"))
for section, kv in over.items():
    cfg = dataclasses.replace(cfg, **dict([(section, dataclasses.replace(
        getattr(cfg, section), **kv))]))
assert maybe_initialize("cpu")
os.makedirs(out, exist_ok=True)
os.chdir(out)
sim = Simulator(cfg, SimLogger(log_dir=None, stdout=False), device="cpu")
rows = [(r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit, r.err_bit_sq)
        for r in sim.simulate()]
dist.barrier()
sim.close()
dist.destroy_process_group()
print(sim.grid.active)
print(json.dumps(rows))
"""


class _Killed(Exception):
    pass


def _sweep_counters(results) -> list:
    return [[r.snr, r.tot_blk, r.err_blk, r.err_bit, r.tot_bit, r.err_bit_sq] for r in results]


def _histograms(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(pathlib.Path(directory).glob("histogram_*"))}


def _kill_after(sim, launches: int) -> None:
    """Make ``sim``'s runner raise after ``launches`` calls."""
    real, calls = sim.runner, []

    def run(*args):
        if len(calls) == launches:
            raise _Killed()
        calls.append(args)
        return real(*args)

    run.__dict__.update(real.__dict__)
    sim.runner = run


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """One process against ranks for ``data_parallel`` above the ranks:
    sequential and folded histogram sweeps (no final decode) at
    data_parallel = 2, one process and 2 ranks; the decoded sweep at
    data_parallel = 2 in one process, and a checkpoint of it written by a
    killed one-process run, resumed on 2 ranks; data_parallel = 4 on one
    process and on 3 ranks (2 run, rank 2 idle)."""
    from .test_torch_parallel import _launch_many

    # one torch thread, as _one_thread gives each test (it runs after this)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _dp_runs(tmp_path_factory, _launch_many)
    finally:
        torch.set_num_threads(threads)


def _dp_runs(tmp_path_factory, _launch_many):
    assets = REPO / "assets"
    tmp = tmp_path_factory.mktemp("dp")
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    runs = {
        "seq": dict(data_parallel=2),
        "folded": dict(data_parallel=2, snr_fold=2),
        "plain": dict(data_parallel=2),
        "resume": dict(data_parallel=2, checkpoint_path=str(tmp / "ck.json")),
        "dp4": dict(data_parallel=4),
    }
    one = {}
    for name, tpu in runs.items():
        hist = name in ("seq", "folded")
        over = dict(config=str(assets / "config.toml"), range=DP_SWEEP["range"],
                    tpu={**DP_SWEEP["tpu"], **tpu}, histogram=dict(enable=hist))
        (tmp / f"{name}.json").write_text(json.dumps(over))
        cfg = _cfg(assets, range=over["range"], tpu=over["tpu"], histogram=over["histogram"])
        here = tmp / "one" / name
        here.mkdir(parents=True)
        cwd = os.getcwd()
        os.chdir(here)
        try:
            sim = Simulator(cfg, _quiet(), device="cpu")
            if name == "resume":
                _kill_after(sim, 5)  # the first point's 3 launches, two of the second's
                with pytest.raises(_Killed):
                    sim.simulate()
                one[name] = json.loads((tmp / "ck.json").read_text())
            else:
                one[name] = (_sweep_counters(sim.simulate()), _histograms(here), sim)
        finally:
            os.chdir(cwd)
    outs = _launch_many([
        (2, [str(script), str(tmp / "seq.json"), str(tmp / "ranks" / "seq")]),
        (2, [str(script), str(tmp / "folded.json"), str(tmp / "ranks" / "folded")]),
        (2, [str(script), str(tmp / "resume.json"), str(tmp / "ranks" / "resume")]),
        (3, [str(script), str(tmp / "dp4.json"), str(tmp / "ranks" / "dp4")]),
    ])
    ranks = {name: [o.splitlines() for o in out]
             for name, out in zip(("seq", "folded", "resume", "dp4"), outs)}
    return tmp, one, ranks


@pytest.mark.parametrize("name", ["seq", "folded"])
def test_data_parallel_above_the_ranks_is_the_ranked_run(dp_runs, name):
    """data_parallel = 2 in one process (it raised before) runs the two data
    shards in turn: its counters and histogram files (the metric table of
    every block) are bitwise those of the same config on 2 ranks,
    sequential and folded."""
    tmp, one, ranks = dp_runs
    counters, hist, sim = one[name]
    assert (sim.ndata, sim.grid.ndata, sim.batch) == (2, 1, 16)
    assert bool(sim.snr_fold) == (name == "folded")
    assert [r[0] for r in ranks[name]] == ["True", "True"]
    assert json.loads(ranks[name][0][1]) == counters
    assert [c[1] for c in counters] == [96, 96]
    assert len(hist) == 2 and _histograms(tmp / "ranks" / name) == hist
    assert counters == one["seq"][0]


def test_data_parallel_checkpoint_resumes_across_rank_counts(dp_runs):
    """A checkpoint written mid-sweep by one process at data_parallel = 2
    resumes on 2 ranks (the fingerprint names the shards, not the ranks)
    and lands bitwise on the uninterrupted counters."""
    tmp, one, ranks = dp_runs
    saved = one["resume"]["snr"]
    assert saved["8.000"]["done"] and not saved["10.000"]["done"]
    assert saved["10.000"]["chunks"] == 1 and one["resume"]["fingerprint"].endswith("|2|1")
    counters = one["plain"][0]
    assert 0 < counters[0][2] < 96  # decoded: some blocks in error, not all
    assert json.loads(ranks["resume"][0][1]) == counters
    assert json.loads((tmp / "ck.json").read_text())["snr"]["10.000"]["done"]


def test_data_parallel_four_shards_on_one_process_and_on_two_of_three_ranks(dp_runs):
    """data_parallel = 4 in one process draws what make_chunk_runner(spec,
    B/4, 4n) draws; on 3 ranks it runs on ranks 0-1 (two shards each) and
    leaves rank 2 idle, with the one process's counters."""
    tmp, one, ranks = dp_runs
    counters, _, sim = one["dp4"]
    assert (sim.ndata, sim.grid.ndata, sim.batch) == (4, 1, 16)
    n = sim.cfg.tpu.chunks_per_launch
    ref = make_chunk_runner(sim.spec, 4, 4 * n, "cpu", sim.cfg.tpu.seed)
    ours, want = sim.runner(10.0, 1, 0.1), ref(10.0, 1, 0.1)
    for field in ("err_bit", "err_blk", "tot_bit", "tot_blk", "err_bit_sq", "metrics"):
        assert torch.equal(torch.as_tensor(getattr(ours, field)),
                           torch.as_tensor(getattr(want, field))), field
    assert [r[0] for r in ranks["dp4"]] == ["True", "True", "False"]
    assert json.loads(ranks["dp4"][0][1]) == counters
    assert json.loads(ranks["dp4"][2][1]) == []


@pytest.mark.parametrize(
    "section,kv,made",
    [
        ("histogram", dict(enable=True), "histogram_15.000000.txt"),
        ("tpu", dict(kmeans_dump_dir="km"), "km/kmeans_snr15.000_blk0.mat"),
        ("tpu", dict(debug_blocks=2), None),
        ("tpu", dict(checkpoint_path="ck.json"), "ck.json"),
        ("tpu", dict(profile_dir="prof"), "prof"),
    ],
    ids=["histogram", "kmeans-dump", "debug-blocks", "checkpoint", "profile-dir"],
)
def test_harness_knobs_run(assets, tmp_path, monkeypatch, section, kv, made):
    """Each harness knob the port once refused: a Simulator on the CPU runs
    a one-point sweep of 4 blocks at 15 dB (assets/config.toml: blind 16QAM)
    and leaves what the knob asks for in the working directory."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(assets, **{section: kv}, range=dict(maximum_block_number=4, minimum_snr=15.0,
                                                   maximum_snr=15.0))
    cfg = dataclasses.replace(cfg, tpu=dataclasses.replace(cfg.tpu, batch=4))
    r = Simulator(cfg, _quiet(), device="cpu").simulate()
    assert len(r) == 1 and r[0].tot_blk == 4
    assert made is None or os.path.exists(made)


def test_cuda_without_a_card_raises(assets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulator(_cfg(assets), _quiet())  # the default device is cuda
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_smoke_cpu(assets, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "kmldpc_torch", str(assets / "config.toml"),
         "--device", "cpu", "--no-log-file", "--seed", "1", "--batch", "4"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    for line in ("BER Result", "FER Result", "Total time cost:", "counters on cpu"):
        assert line in out.stdout


def test_package_never_imports_jax():
    """Importing every kmldpc_torch module leaves jax and kmldpc_tpu out of
    sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import kmldpc_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(kmldpc_torch.__path__, 'kmldpc_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'kmldpc_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]



def _committed_runs() -> dict:
    """File stem in parity_torch/ -> (chip_smoke.py's run name, its C++ log)."""
    import chip_smoke

    runs = {t.removesuffix(".toml"): (t.removesuffix(".toml"), log) for t, log in chip_smoke.SWEEPS}
    runs.update(blind_QPSK=("blind QPSK", "ref_blind_qpsk.log"),
                known_h_QPSK=("known-h QPSK", "ref_known_qpsk_r5.log"),
                fast_stack=("fast stack", "ref_blind_qpsk.log"))
    return runs


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "parity_torch").glob("*.json")))
def test_committed_port_counts_pass_parity(name):
    """The port's committed per-sweep counters (parity_torch/, written on the
    card by chip_smoke.py --counts-dir) pass tools/parity.py against their
    C++ reference logs with the worst |z| chip_smoke.py holds them to, and
    against the JAX package's records where it names one."""
    import json

    import chip_smoke
    from tools.parity import compare, parse_reference_log

    run, log = _committed_runs()[name]
    ours = json.loads((REPO / "parity_torch" / f"{name}.json").read_text())
    parity = REPO / "benchmarks" / "parity"
    info_bits = ours[0]["tot_bit"] // ours[0]["tot_blk"]
    rows = compare(parse_reference_log(str(parity / log)), ours, info_bits)
    assert len(rows) == len(ours) >= 4
    worst = max(max(abs(r["z_fer"]), abs(r["z_ber"])) for r in rows)
    assert worst < 4.0
    if run in chip_smoke.EXPECTED_WORST_Z:
        assert f"{worst:.3f}" == chip_smoke.EXPECTED_WORST_Z[run]
    if run in chip_smoke.JAX_RECORDS:
        ref = {o["snr"]: o for o in json.loads((parity / chip_smoke.JAX_RECORDS[run]).read_text())}
        jrows = compare(ref, ours, info_bits)
        assert len(jrows) == len(ours)
        assert max(max(abs(r["z_fer"]), abs(r["z_ber"])) for r in jrows) < 4.0
