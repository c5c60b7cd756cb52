"""The benchmark's data: every name in BENCHMARK.json finds its files, every
file is named there, and a new cell needs new files only."""

import json
import re
import shutil
import tomllib

import pytest

from linkbench import spec
from linkbench.run import run_cell

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
COMPARED = {"counter_gap", "select_gap", "decode_gap", "iters_gap", "soft_gap", "metric_gap"}


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_finds_its_configuration_and_traffic(entry):
    cell = spec.load_cell(entry["name"], BENCH)
    assert cell.config_name == entry["config"]
    assert cell.points and cell.batch > 0 and cell.subs > 0
    assert cell.launches_per_point * cell.batch * cell.subs == cell.tables["range"][
        "maximum_block_number"], "a point ends on a whole launch"
    assert cell.tables["range"]["maximum_error_number"] >= 10**8, "the error cap is disabled"
    assert not set(cell.tables) & set(spec.BENCH_TABLES)
    assert set(cell.limits) <= COMPARED and cell.limits["counter_gap"] == 0
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    assert (spec.HERE / "traffic" / f"{entry['name']}.toml").is_file()


def test_every_file_is_named_and_every_name_valid():
    cells = {w["name"] for w in BENCH["workloads"]}
    assert cells == {p.stem for p in (spec.HERE / "traffic").glob("*.toml")}
    assert {m["name"] for m in BENCH["per_layer"]} == {
        p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    files = {c["file"] for c in BENCH["configs"]}
    assert files == {f"linkbench/configs/{p.name}" for p in (spec.HERE / "configs").glob("*.toml")}
    for c in BENCH["configs"]:
        link = tomllib.loads((spec.ROOT / c["file"]).read_text())
        assert link["benchmark"]["source"] == c["source"] and link["benchmark"]["assumed"]
        assert c["reduced"] == []
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    texts = [c["source"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
    texts += [c["why"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_the_command_stays_inside_paths():
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert BENCH["paths"] == ["linkbench"]


def test_a_new_cell_needs_new_files_only(tmp_path, monkeypatch, tiny_overrides):
    """A configuration, a traffic mix and a per-layer metric, each a file of
    its own plus an entry: no file of the benchmark is edited."""
    here = tmp_path / "linkbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(spec.HERE / sub, here / sub)
    (tmp_path / "assets").symlink_to(spec.ASSETS)
    shutil.copy(spec.HERE / "configs" / "peg2304-qpsk.toml", here / "configs" / "peg-new.toml")
    (here / "traffic" / "peg-new.known.toml").write_text(
        (spec.HERE / "traffic" / "peg2304-qpsk.blind.toml").read_text()
        .replace("true_h_arg = false", "true_h_arg = true")
        .replace("select_gap = 0.01", "").replace("metric_gap = 0.001", ""))
    (here / "metrics" / "blocks_traced.py").write_text(
        "def read(trace, ctx):\n    return float(trace.blocks) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="peg-new",
                                 file="linkbench/configs/peg-new.toml"))
    bench["workloads"].append({"name": "peg-new.known", "config": "peg-new", "traffic": "known",
                               "chips": 1, "why": "a cell added by files alone"})
    bench["per_layer"].append({"name": "blocks_traced", "unit": "blocks", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "blocks_per_s", "workloads": ["peg-new.known"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ASSETS", tmp_path / "assets")
    cell = spec.load_cell("peg-new.known")
    assert not cell.blind and cell.per_layer[-1] == "blocks_traced"
    r = run_cell("peg-new.known", 7, 0.0, False, "cpu", tiny_overrides(12.5, 15.0))
    assert r["correct"] and set(r["metrics"]) == {"blocks_per_s", "setup_s"}
    assert set(r["checks"]) == {"counter_gap", "iters_gap", "decode_gap", "soft_gap"}
    r = run_cell("peg-new.known", 7, 0.0, True, "cpu", tiny_overrides(12.5, 15.0))
    assert r["correct"] and r["metrics"]["blocks_traced"]["value"] == 32
