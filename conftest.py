"""Fill, once and before any pytest-xdist worker starts, the disk caches the
workers would otherwise race to fill on a cold ``.cache/``.

``kmldpc_tpu`` builds its native GF(2) eliminator to one fixed temp name and
writes each compiled code through one fixed ``<file>.tmp``; workers that do
either at once can fail (a skipped ``tests/test_native.py``, failed code
loads).  This hook runs in the process that starts the workers, fills both
caches through the package's own functions, and changes no option,
collection, selection or skip.
"""

import pathlib

ASSET_CODES = ("PEG2304regular0.5.txt", "PEG8064regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller has warmed
        return
    from kmldpc_tpu.code import load_code
    from kmldpc_tpu.native import gf2_native

    try:
        gf2_native._load()
    except RuntimeError:
        pass  # no C++ toolchain: load_code takes NumPy, tests/test_native.py skips
    assets = pathlib.Path(__file__).resolve().parent / "assets"
    for name in ASSET_CODES:
        load_code(str(assets / name))
