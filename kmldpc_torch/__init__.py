"""kmldpc_torch — the PyTorch + CUDA port of the kmldpc link-level simulator.

Runs the blind PEG2304 main path (random bits -> encode -> map -> fading
channel -> blind k-means gain estimate -> 4-candidate hard ambiguity metric
-> soft demap -> exact two-phase flooding sum-product decode -> counters)
on one NVIDIA H100, or on the CPU for tests.  ``kmldpc_tpu`` (JAX) is the
reference it is held against; this package never imports jax.  It reuses
the jax-free host modules of ``kmldpc_tpu`` (config schema, H-matrix
parsing, GF(2) systematisation, constellation tables, logging).
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
