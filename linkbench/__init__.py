"""linkbench: the benchmark of ``kmldpc_torch`` on one H100.

``python -m linkbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` (run.py).  The yardstick lives here and
nowhere in the program: the data (spec.py: configs/, traffic/), the window
and its counting (window.py), the trace's reduction (trace.py), the
per-layer readers (metrics/), the roofline counts (roofline.py), and the
plain reference that decides ``correct`` (reference/, judge.py), with the
tool that reads its limits (control.py).
"""
