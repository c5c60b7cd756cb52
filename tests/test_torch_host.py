"""kmldpc_torch's own host modules against the kmldpc_tpu originals they copy
(codes, configs, constellations, constants), and the rule that the port
imports nothing of kmldpc_tpu or jax."""

import ast
import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import kmldpc_tpu.constants as jax_constants
from kmldpc_tpu.code.ldpc import compile_code as jax_compile_code
from kmldpc_tpu.config import load_config as jax_load_config
from kmldpc_tpu.io import parse_constellation as jax_parse_constellation
from kmldpc_tpu.io import parse_hmatrix as jax_parse_hmatrix
from kmldpc_torch import constants
from kmldpc_torch.code import compile_code, ldpc, load_code
from kmldpc_torch.config import load_config
from kmldpc_torch.io import parse_constellation, parse_hmatrix
from kmldpc_torch.native import gf2_native

REPO = pathlib.Path(__file__).resolve().parent.parent
CODES = ["PEG2304regular0.5.txt", "PEG8064regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"]
TABLES = ["2bits_4PSK.txt", "2bits_QPSK.txt", "4bit_16QAM_Gray.txt",
          "4bit_16QAM_phi1.txt", "4bit_16QAM_phi2.txt", "6bits_64QAM_Gray.txt"]
CONFIGS = sorted(
    [*REPO.glob("configs/*.toml"), *REPO.glob("benchmarks/parity/configs/*.toml"),
     REPO / "assets" / "config.toml"]
)


def _fields_equal(a, b) -> None:
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("fname", CODES)
def test_ldpc_code_equals_original(assets, fname, route, tmp_path, monkeypatch):
    """Parse, systematise and build tables as kmldpc_tpu does, also after a
    round trip through the port's disk cache, through either route of the
    elimination: the native eliminator, or NumPy's (forced)."""
    if route == "native":
        if shutil.which(gf2_native.CXX) is None:
            pytest.skip(f"no C++ toolchain ({gf2_native.CXX} not on PATH)")
        assert gf2_native.available()
    else:
        monkeypatch.setattr(ldpc, "_native_or_numpy_systematize", ldpc._numpy_systematize)
    path = str(assets / fname)
    _fields_equal(parse_hmatrix(path), jax_parse_hmatrix(path))
    name = pathlib.Path(fname).stem
    ref = jax_compile_code(jax_parse_hmatrix(path), name=name)
    _fields_equal(compile_code(parse_hmatrix(path), name=name), ref)
    monkeypatch.setenv("KMLDPC_TORCH_CACHE", str(tmp_path))
    fresh = str(tmp_path / fname)  # a path the in-memory cache has not seen
    (tmp_path / fname).write_bytes((assets / fname).read_bytes())
    _fields_equal(load_code(fresh), ref)  # compiled, then written
    assert [p.suffix for p in tmp_path.iterdir() if p.name != fname] == [".npz"]
    cached = str(tmp_path / "again" / fname)
    os.makedirs(os.path.dirname(cached))
    (tmp_path / "again" / fname).write_bytes((assets / fname).read_bytes())
    _fields_equal(load_code(cached), ref)  # read back from the cache


def test_load_code_cache_survives_concurrent_writers(assets, tmp_path):
    """Processes that compile the same code into a cold cache at once all
    succeed and leave one cache file (and the native eliminator's library)
    and no temp file behind."""
    prog = (
        "import sys\n"
        "from kmldpc_torch.code import load_code\n"
        "c = load_code(sys.argv[1])\n"
        "print(c.num_col)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), KMLDPC_TORCH_CACHE=str(tmp_path / "cache"))
    path = str(assets / "PEG2304regular0.5.txt")
    procs = [subprocess.Popen([sys.executable, "-c", prog, path], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == "2304"
    # beside the native eliminator's library, which the processes built there
    lib = pathlib.Path(gf2_native.library_path()).name
    assert [p.name.endswith(".npz") for p in (tmp_path / "cache").iterdir()
            if p.name != lib] == [True]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_load_config_equals_original(path):
    ours, ref = load_config(str(path)), jax_load_config(str(path))
    ours_d, ref_d = dataclasses.asdict(ours), dataclasses.asdict(ref)
    # the bundled-assets fallback names the directory from each package's own
    # location: the same directory, spelt through another package
    assert os.path.realpath(ours_d.pop("asset_dir")) == os.path.realpath(ref_d.pop("asset_dir"))
    assert ours_d == ref_d
    assert os.path.realpath(ours.matrix_path()) == os.path.realpath(ref.matrix_path())
    assert os.path.realpath(ours.modem_path()) == os.path.realpath(ref.modem_path())
    assert ours.snr_points() == ref.snr_points()


@pytest.mark.parametrize("fname", TABLES)
def test_constellation_equals_original(assets, fname):
    ours = parse_constellation(str(assets / fname))
    ref = jax_parse_constellation(str(assets / fname))
    _fields_equal(ours, ref)
    assert np.array_equal(ours.bit0_mask(), ref.bit0_mask())


def test_constants_equal_original():
    names = [n for n in dir(jax_constants) if n.isupper()]
    assert names == [n for n in dir(constants) if n.isupper()]
    for n in names:
        assert getattr(constants, n) == getattr(jax_constants, n), n


@pytest.mark.parametrize("scipy_present", [True, False], ids=["mat", "npz-fallback"])
def test_record_writer_equals_original(tmp_path, monkeypatch, scipy_present):
    """utils/records.py writes the original's file: the .mat through scipy,
    or the .npz where scipy is missing, with the same names, types and
    values."""
    from scipy.io import loadmat

    from kmldpc_torch.utils import records
    from kmldpc_tpu.utils import records as jax_records

    if not scipy_present:
        monkeypatch.setitem(sys.modules, "scipy.io", None)  # import raises ImportError
    paths = []
    for mod, name in ((records, "ours"), (jax_records, "ref")):
        w = mod.RecordWriter(str(tmp_path / name))
        w.write_int("n", 7)
        w.write_double("x", 0.1)
        w.write_complex("z", 1 - 2j)
        w.write_vector("v", np.arange(5, dtype=np.int32))
        paths.append(w.close())
    assert [os.path.basename(p) for p in paths] == (
        ["ours.mat", "ref.mat"] if scipy_present else ["ours.npz", "ref.npz"])
    monkeypatch.undo()
    ours, ref = (loadmat(p) if scipy_present else dict(np.load(p)) for p in paths)
    names = {k for k in ref if not k.startswith("__")}
    assert names == {k for k in ours if not k.startswith("__")} == {"n", "x", "z", "v"}
    for k in names:
        assert ours[k].dtype == ref[k].dtype and np.array_equal(ours[k], ref[k]), k


def test_package_exports_cover_the_jax_packages():
    """``kmldpc_torch`` exports every public name ``kmldpc_tpu`` does
    (``Config``, ``load_config``), each the port's own counterpart."""
    import types

    import kmldpc_torch
    import kmldpc_tpu
    from kmldpc_torch import config as torch_config

    def exports(pkg) -> set[str]:
        return {n for n, v in vars(pkg).items()
                if not n.startswith("_") and not isinstance(v, types.ModuleType)}

    assert {"Config", "load_config"} <= exports(kmldpc_tpu) <= exports(kmldpc_torch)
    assert kmldpc_torch.load_config is torch_config.load_config
    assert kmldpc_torch.Config is torch_config.Config
    assert kmldpc_torch.__version__ == kmldpc_tpu.__version__


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
    return mods


def test_no_source_imports_the_jax_package():
    """Neither the port nor chip_smoke.py imports jax or kmldpc_tpu; the
    port imports nothing of ``tools/`` either (``tools/campaign.py`` imports
    kmldpc_tpu), while chip_smoke.py keeps the jax-free ``tools.parity``."""
    package = sorted((REPO / "kmldpc_torch").rglob("*.py"))
    files = [*package, REPO / "chip_smoke.py"]
    assert len(files) > 25 and REPO / "kmldpc_torch" / "campaign.py" in files
    bad = {
        str(f.relative_to(REPO)): sorted(
            m for m in _imported_modules(f)
            if m.split(".")[0] in ("kmldpc_tpu", "jax", "jaxlib")
            or (f in package and m.split(".")[0] == "tools")
        )
        for f in files
    }
    assert {f: m for f, m in bad.items() if m} == {}


def test_campaign_loads_neither_jax_nor_kmldpc_tpu_nor_tools(tmp_path):
    """``kmldpc_torch.campaign`` in a fresh process, one tiny known-h config
    (1 point of 8 blocks) on the CPU: it writes its files and loads no jax,
    kmldpc_tpu or tools."""
    src = REPO / "benchmarks" / "parity" / "configs" / "sweep9_known_qpsk_fminsum.toml"
    text = src.read_text()
    for key, value in (("maximum_snr", 5.0), ("maximum_block_number", 8), ("batch", 8)):
        text = re.sub(rf"(\n\s*){key} = [^\n]*", rf"\g<1>{key} = {value}", text)
    (tmp_path / "tiny.toml").write_text(text)
    prog = (
        "import sys\n"
        "from kmldpc_torch.campaign import run_campaign\n"
        "print(run_campaign('out', ['tiny.toml'], 'cpu'))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'kmldpc_tpu', 'tools'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "[]"
    assert json.loads((tmp_path / "out" / "campaign.json").read_text())[0]["blocks"] == 8
    assert [p["tot_blk"] for p in json.loads((tmp_path / "out" / "tiny.json").read_text())] == [8]


def test_cpu_chunk_loads_neither_jax_nor_kmldpc_tpu(assets, tmp_path):
    """Chunks on the CPU, from config to counters, in a fresh process: the
    blind hard-metric main path, the blind 5G soft metric (sweep 4), blind
    QPSK with flooding min-sum and pruned candidates (sweep 10) and the
    blind 5G soft metric with layered min-sum (sweep 7)."""
    prog = (
        "import sys\n"
        "from kmldpc_torch.code import load_code\n"
        "from kmldpc_torch.config import load_config\n"
        "from kmldpc_torch.io import parse_constellation\n"
        "from kmldpc_torch.sim import ChainSpec, make_chunk_runner\n"
        "for path in sys.argv[1:]:\n"
        "    cfg = load_config(path)\n"
        "    code = load_code(cfg.matrix_path())\n"
        "    spec = ChainSpec.from_config(cfg, code, parse_constellation(cfg.modem_path()))\n"
        "    assert not spec.known_h\n"
        "    r = make_chunk_runner(spec, 4, 1, 'cpu', seed=3)(15.0, 0, 10 ** -1.5)\n"
        "    assert r.tot_blk == 4 and r.metrics.shape == (4, 4)\n"
        "    print(code.name, spec.metric_type, spec.schedule, int(r.err_blk))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'kmldpc_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    sweeps = REPO / "benchmarks" / "parity" / "configs"
    paths = [assets / "config.toml", sweeps / "sweep4_blind_5g_soft.toml",
             sweeps / "sweep10_blind_qpsk_fminsum_prune.toml",
             sweeps / "sweep7_blind_5g_soft_minsum.toml"]
    env = dict(os.environ, PYTHONPATH=str(REPO), KMLDPC_TORCH_CACHE=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", prog, *map(str, paths)],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert [line.rsplit(" ", 1)[0] for line in out.stdout.splitlines()[:4]] == [
        "PEG2304regular0.5 False flooding", "5GLDPCBG2a3_R12_K960 True flooding",
        "PEG2304regular0.5 False flooding-minsum", "5GLDPCBG2a3_R12_K960 True layered-minsum"]
