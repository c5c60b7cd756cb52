"""The benchmark's data, found by the names that ``BENCHMARK.json`` gives:

* ``configs/<config>.toml``: the link as the port runs it, in the port's
  config tables, with a ``[benchmark]`` table naming its source;
* ``traffic/<cell>.toml``: how the cell's sweeps are launched (detection
  mode, SNR grid, blocks a point, batch, sub-chunks, folding), with a
  ``[check]`` table giving each number ``correct`` compares its limit and
  an optional ``[sample]`` table (``rows``: codewords judged a sampled
  launch);
* ``metrics/<metric>.py``: one reader a per-layer metric.

Nothing here names a cell, a configuration or a metric.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import tomllib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
ASSETS = ROOT / "assets"
BENCH_TABLES = ("benchmark", "check", "sample")  # the benchmark's own tables, not the port's


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s tables merged in, key by key."""
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def derived_seed(seed: int, *tag) -> int:
    """A 62-bit seed for one use of ``--seed`` (a sweep, the warm sweep, the
    sample): any whole number in, the same number out for the same tag."""
    text = ":".join(str(t) for t in (int(seed), *tag)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 2


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    chips: int
    tables: dict  # the port's config tables: the configuration, the traffic merged in
    limits: dict  # compared number -> limit
    end_to_end: tuple  # names of the end-to-end metrics the cell reports
    per_layer: tuple  # names of the per-layer metrics the cell reports
    sample_rows: int = 0  # codewords judged a sampled launch; 0: the judge's default

    @property
    def points(self) -> list[float]:
        r = self.tables["range"]
        n = int((r["maximum_snr"] - r["minimum_snr"]) / r["step_snr"] + 1)
        return [r["minimum_snr"] + r["step_snr"] * i for i in range(n)]

    @property
    def batch(self) -> int:
        return int(self.tables["tpu"]["batch"])

    @property
    def subs(self) -> int:
        return int(self.tables["tpu"]["chunks_per_launch"])

    @property
    def launches_per_point(self) -> int:
        return -(-int(self.tables["range"]["maximum_block_number"]) // (self.batch * self.subs))

    @property
    def blind(self) -> bool:
        return not self.tables.get("decoder", {}).get("true_h_arg", False)

    @property
    def folded(self) -> bool:
        return int(self.tables["tpu"].get("snr_fold", 0)) > 1

    def matrix_path(self) -> str:
        return str(ASSETS / self.tables["ldpc"]["matrix_file"])

    def modem_path(self) -> str:
        return str(ASSETS / self.tables["modem"]["modem_file"])

    def sweep_tables(self, seed: int, checkpoint: str = "") -> dict:
        """The tables of one sweep, drawing from ``[tpu] seed = seed``."""
        return merge(self.tables, {"tpu": {"seed": seed, "checkpoint_path": checkpoint}})


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _toml(path: pathlib.Path) -> dict:
    with open(path, "rb") as f:
        return tomllib.load(f)


def _reported(metrics: list[dict], cell: str) -> tuple:
    return tuple(m["name"] for m in metrics if cell in m.get("workloads", [cell]))


def load_cell(name: str, bench: dict | None = None, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``overrides`` (tests and the
    batch sweep) are merged into its tables after the traffic."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    link = _toml(ROOT / config["file"])
    traffic = _toml(HERE / "traffic" / f"{name}.toml")
    tables = merge(link, traffic)
    limits = dict(tables.get("check", {}))
    sample_rows = int(tables.get("sample", {}).get("rows", 0))
    for key in BENCH_TABLES:
        tables.pop(key, None)
    return Cell(
        name=name, config_name=entry["config"], chips=int(entry["chips"]),
        tables=merge(tables, overrides or {}), limits=limits,
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name), sample_rows=sample_rows,
    )


def metric_reader(name: str):
    """The module ``metrics/<name>.py``; its ``read(trace, ctx)`` gives the
    metric's value, or None where the traced run holds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"linkbench.metrics.{name}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
