"""Native (C++) helpers, loaded via ctypes with lazy on-demand builds.

The shared library is compiled once with the system g++ into the port's code
cache directory (``.cache/kmldpc_torch/``, or ``KMLDPC_TORCH_CACHE``); if no
toolchain is available every caller falls back to the NumPy implementations
(``code/gf2.py``), with the same results, after one warning.
"""
