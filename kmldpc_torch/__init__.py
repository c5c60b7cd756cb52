"""kmldpc_torch — the PyTorch + CUDA port of the kmldpc link-level simulator.

Runs the simulation chain (random bits -> encode -> map -> fading channel
-> blind k-means gain estimate -> 4-candidate ambiguity metric -> soft
demap -> exact two-phase flooding decode -> counters) for the classic PEG
codes and the punctured 5G BG2 code, with the hard or soft metric and the
sum-product or min-sum check rule, on one NVIDIA H100, or on the CPU for
tests.  ``kmldpc_tpu`` (JAX) is the
reference it is held against; this package imports neither jax nor
anything of ``kmldpc_tpu``.  It keeps its own copies of the host modules it
needs (``config``, ``constants``, ``code/``, ``io/``, ``utils/``), laid out
as in ``kmldpc_tpu`` and held equal to them by the tests.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
