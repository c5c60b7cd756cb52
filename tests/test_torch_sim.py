"""kmldpc_torch harness, CLI, device rule, ported and refused knobs, every
shipped config, and the no-jax rule."""

import dataclasses
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
from kmldpc_torch.sim.chain import ChainSpec
from kmldpc_torch.utils import SimLogger
from kmldpc_torch import resolve_device
from kmldpc_torch.sim import Simulator

REPO = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = sorted([*REPO.glob("configs/*.toml"), *REPO.glob("benchmarks/parity/configs/*.toml")])
# the shipped configs the port still refuses, and the ROADMAP.md Queue 1
# item each names
REFUSED = {
    "peg8064_model_parallel.toml": "multi-device",
    "peg8064_blind_model_parallel.toml": "multi-device",
}


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


@pytest.mark.parametrize(
    "section,kv,item",
    [
        ("tpu", dict(model_parallel=2), "multi-device"),
        ("tpu", dict(data_parallel=2), "multi-device"),
    ],
)
def test_unported_knobs_raise(assets, section, kv, item):
    cfg = _cfg(assets, **{section: kv})
    with pytest.raises(NotImplementedError, match=item):
        Simulator(cfg, _quiet(), device="cpu")


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
