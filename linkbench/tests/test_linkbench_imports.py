"""What a run loads: neither JAX nor the JAX package nor its tools and
benchmarks, compared by whole top-level names (the port's name begins
with the JAX package's); and the reference imports nothing of the
program."""

import ast
import json
import subprocess
import sys

from linkbench import spec
from linkbench.run import FORBIDDEN

RUN = """
import json, sys
from linkbench.run import run_cell, forbidden_modules
ov = {"range": {"minimum_snr": 15.0, "maximum_snr": 17.5, "maximum_block_number": 4},
      "tpu": {"batch": 4}}
r = run_cell("peg2304-qpsk.blind", 5, 0.0, True, "cpu", ov)
print(json.dumps({"correct": r["correct"], "forbidden": forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""
STDLIB = {"__future__", "dataclasses", "hashlib", "math", "struct", "typing"}


def test_a_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["forbidden"] == []
    assert "kmldpc_torch" in line["tops"]
    assert not set(line["tops"]) & {"jax", "jaxlib", "flax", "kmldpc_tpu", "tools", "benchmarks"}
    assert {"jax", "jaxlib", "flax", "kmldpc_tpu", "tools", "benchmarks"} <= set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in STDLIB | {"numpy", "torch"}, (path.name, n)
    code = ("import sys; import linkbench.reference.chain; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kmldpc_torch', 'kmldpc_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
