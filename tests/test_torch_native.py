"""kmldpc_torch's native GF(2) eliminator (``kmldpc_torch/native/``) against
the port's NumPy elimination and the JAX package's native eliminator; its
build under concurrency; and the NumPy fallback where no compiler runs.

Nothing here builds at import or collection time: the library is built in
test bodies (``available()``) or in subprocesses.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from kmldpc_tpu.code import compile_code as jax_compile_code
from kmldpc_tpu.io import parse_hmatrix as jax_parse_hmatrix
from kmldpc_torch.code import compile_code, ldpc
from kmldpc_torch.io import parse_hmatrix
from kmldpc_torch.native import gf2_native

from .test_torch_host import CODES, REPO, _fields_equal

IS_5G = {"PEG2304regular0.5.txt": False, "PEG8064regular0.5.txt": False,
         "5GLDPCBG2a3_R12_K960.txt": True}


@pytest.fixture
def native():
    """The port's native module, built; a machine without g++ skips."""
    if shutil.which(gf2_native.CXX) is None:
        pytest.skip(f"no C++ toolchain ({gf2_native.CXX} not on PATH)")
    assert gf2_native.available()
    return gf2_native


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_equals_numpy_and_jax_native(native, seed, reverse):
    from kmldpc_tpu.native import gf2_native as jax_gf2_native

    rng = np.random.default_rng(seed)
    h = (rng.random((60, 120)) < 0.1).astype(np.uint8)
    enc, perm, rank = native.systematize(h, reverse)
    for ref in (ldpc._numpy_systematize(h, reverse), jax_gf2_native.systematize(h, reverse)):
        assert rank == ref[2]
        assert perm.dtype == ref[1].dtype and np.array_equal(perm, ref[1])
        assert enc.dtype == ref[0].dtype and np.array_equal(enc, ref[0])


@pytest.mark.parametrize("fname", CODES)
def test_asset_code_native_equals_jax(native, assets, fname):
    """On the shipped codes: the eliminator bitwise the JAX package's, and
    ``compile_code`` through it equal to ``kmldpc_tpu.code.compile_code``."""
    from kmldpc_tpu.native import gf2_native as jax_gf2_native

    path = str(assets / fname)
    h = parse_hmatrix(path).to_dense()
    ours = native.systematize(h, IS_5G[fname])
    ref = jax_gf2_native.systematize(h, IS_5G[fname])
    assert ours[2] == ref[2]
    assert np.array_equal(ours[1], ref[1]) and np.array_equal(ours[0], ref[0])
    name = pathlib.Path(fname).stem
    _fields_equal(compile_code(parse_hmatrix(path), name=name),
                  jax_compile_code(jax_parse_hmatrix(path), name=name))


def test_cold_concurrent_builds_all_succeed(tmp_path):
    """Six processes build into one cold cache at once: every one gets the
    native route, and one library and no temp file are left."""
    prog = (
        "import sys, time\n"
        "import numpy as np\n"
        "from kmldpc_torch.native import gf2_native\n"
        "time.sleep(max(0.0, float(sys.argv[1]) - time.time()))\n"
        "ok = gf2_native.available()\n"
        "h = (np.random.default_rng(0).random((60, 120)) < 0.1).astype(np.uint8)\n"
        "print(ok, gf2_native.systematize(h, False)[2] if ok else -1)\n"
    )
    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=str(REPO), KMLDPC_TORCH_CACHE=str(cache))
    start = time.time() + 5.0  # every process past its imports before any builds
    procs = [subprocess.Popen([sys.executable, "-c", prog, repr(start)], env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    rank = ldpc._numpy_systematize(
        (np.random.default_rng(0).random((60, 120)) < 0.1).astype(np.uint8), False)[2]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["True", str(rank)], err[-2000:]
    assert [p.name for p in cache.iterdir()] == [pathlib.Path(gf2_native.library_path()).name]


def test_no_toolchain_falls_back_to_numpy_with_one_warning(assets, tmp_path, monkeypatch):
    """Without g++ on PATH: importing builds nothing, compile_code gives the
    NumPy route's tables, and the reason comes as exactly one warning."""
    prog = (
        "import sys, warnings\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    from kmldpc_torch.code import compile_code, ldpc\n"
        "    from kmldpc_torch.io import parse_hmatrix\n"
        "    from kmldpc_torch.native import gf2_native\n"
        "    ours = lambda: [x for x in w if 'GF(2)' in str(x.message)]\n"
        "    print(len(ours()))\n"
        "    for path, out in zip(sys.argv[1::2], sys.argv[2::2]):\n"
        "        ldpc._to_npz(out, compile_code(parse_hmatrix(path)))\n"
        "    print(gf2_native.available())\n"
        "for x in ours():\n"
        "    print(x.category.__name__, str(x.message).splitlines()[0])\n"
    )
    fnames = ["PEG2304regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt"]
    args = [a for f in fnames for a in (str(assets / f), str(tmp_path / f"{f}.npz"))]
    empty = tmp_path / "bin"
    empty.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=str(empty),
               KMLDPC_TORCH_CACHE=str(tmp_path / "cache"))
    out = subprocess.run([sys.executable, "-c", prog, *args], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[:2] == ["0", "False"], out.stdout
    assert len(lines) == 3 and lines[2].startswith(
        "RuntimeWarning native GF(2) eliminator unavailable"), out.stdout
    assert gf2_native.CXX in lines[2]
    assert not list((tmp_path / "cache").iterdir())  # no library, no temp file
    monkeypatch.setattr(ldpc, "_native_or_numpy_systematize", ldpc._numpy_systematize)
    for f in fnames:
        ref = compile_code(parse_hmatrix(str(assets / f)), name="ldpc")
        _fields_equal(ldpc._from_npz(str(tmp_path / f"{f}.npz"), "ldpc"), ref)
