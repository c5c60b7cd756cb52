"""kmldpc_torch harness, CLI, device rule, refused knobs and the no-jax rule."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from kmldpc_tpu.config import load_config
from kmldpc_tpu.utils.logging import SimLogger
from kmldpc_torch import resolve_device
from kmldpc_torch.sim import Simulator

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


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
    "section,kv,item",
    [
        ("xcodec", dict(metric_type=True), "soft metric"),
        ("tpu", dict(schedule="flooding-minsum"), "min-sum family"),
        ("tpu", dict(metric_schedule="match"), "min-sum family"),
        ("tpu", dict(metric_prune=True), "min-sum family"),
        ("tpu", dict(dtype="bfloat16"), "bf16"),
        ("tpu", dict(model_parallel=2), "multi-device"),
        ("tpu", dict(data_parallel=2), "multi-device"),
        ("histogram", dict(enable=True), "snr_fold, checkpoints, histogram, dumps"),
        ("tpu", dict(kmeans_dump_dir="x"), "snr_fold, checkpoints, histogram, dumps"),
        ("tpu", dict(debug_blocks=2), "snr_fold, checkpoints, histogram, dumps"),
        ("tpu", dict(checkpoint_path="x.json"), "snr_fold, checkpoints, histogram, dumps"),
        ("tpu", dict(profile_dir="x"), "snr_fold, checkpoints, histogram, dumps"),
        ("ldpc", dict(matrix_file="5GLDPCBG2a3_R12_K960.txt"), "degree-class core and 5G"),
    ],
)
def test_unported_knobs_raise(assets, section, kv, item):
    cfg = _cfg(assets, **{section: kv})
    with pytest.raises(NotImplementedError, match=item):
        Simulator(cfg, _quiet(), device="cpu")


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
    """Importing every kmldpc_torch module leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import kmldpc_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(kmldpc_torch.__path__, 'kmldpc_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
