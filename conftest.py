"""Prepare the pytest-xdist workers before any test runs.

``pytest_configure`` does two things, and changes no option, collection,
selection or skip:

* In the process that starts the workers, it fills the disk caches the
  workers would otherwise race to fill on a cold ``.cache/``.
  ``kmldpc_tpu`` builds its native GF(2) eliminator to one fixed temp name
  and writes each compiled code through one fixed ``<file>.tmp``; workers
  that do either at once can fail (a skipped ``tests/test_native.py``,
  failed code loads).  The hook fills both caches through the package's own
  functions.
* In each worker, it gives torch the worker's share of the host's CPUs as
  its intra-op threads (at least one), and ``OMP_NUM_THREADS`` the same
  count, so the processes a test starts (gloo ranks, the CLI) inherit it.
  At torch's default every worker takes all of the CPUs, and the workers'
  threads oversubscribe the host many times over.  XLA's threads are left
  as they are.  Run without xdist, torch keeps its default.
"""

import os
import pathlib

ASSET_CODES = ("PEG2304regular0.5.txt", "PEG8064regular0.5.txt", "5GLDPCBG2a3_R12_K960.txt")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller has warmed
        _share_the_cpus(int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
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


def _share_the_cpus(workers: int) -> None:
    """torch's intra-op threads, and the subprocesses' ``OMP_NUM_THREADS``,
    at this worker's share of the CPUs the process may run on."""
    import torch

    threads = max(1, len(os.sched_getaffinity(0)) // workers)
    torch.set_num_threads(threads)
    os.environ["OMP_NUM_THREADS"] = str(threads)
