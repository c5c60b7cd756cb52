"""kmldpc_torch's campaign runner (``python -m kmldpc_torch.campaign``)
against the JAX package's ``tools/campaign.py``, and the rank layout rule
against the JAX package's meshes.

Configs are temp copies of shipped ones, cut in depth (2 points of 64
blocks, B = 32), never in width.  Codes load through ``kmldpc_torch.code``
only; no ``kmldpc_tpu`` Simulator is built.  Multi-rank cases start gloo
ranks on the CPU, one torch thread a rank, each launch killed after 120 s
(``tests/test_torch_parallel.py``'s launcher).
"""

import ast
import json
import os
import re

import jax
import pytest

from kmldpc_tpu.parallel.edge_sharded import get_mesh_2d
from kmldpc_tpu.parallel.sharding import get_mesh
from kmldpc_torch import campaign
from kmldpc_torch.config import load_config
from kmldpc_torch.parallel.distributed import grid_ranks, layout
from kmldpc_torch.sim import Simulator
from kmldpc_torch.utils import SimLogger

from .test_torch_parallel import _launch_many

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLIND = os.path.join(REPO, "configs", "main_path_blind_qpsk.toml")
KNOWN_MINSUM = os.path.join(REPO, "benchmarks", "parity", "configs",
                            "sweep9_known_qpsk_fminsum.toml")
COUNTERS = ("snr", "tot_blk", "err_blk", "err_bit", "tot_bit", "err_bit_sq")


def _cut(src: str, dst, data_parallel: int | None = None) -> str:
    """A copy of config ``src`` cut in depth: 2 points of 64 blocks, B = 32,
    and ``data_parallel`` where given."""
    with open(src) as f:
        text = f.read()
    for key, value in (("minimum_snr", 5.0), ("maximum_snr", 7.5), ("step_snr", 2.5),
                       ("maximum_block_number", 64), ("batch", 32)):
        text, n = re.subn(rf"(\n\s*){key} = [^\n]*", rf"\g<1>{key} = {value}", text)
        assert n == 1, key
    if data_parallel is not None:
        text = text.replace("[tpu]\n", f"[tpu]\n    data_parallel = {data_parallel}\n")
    with open(dst, "w") as f:
        f.write(text)
    return str(dst)


def _counters(rows: list[dict]) -> list[tuple]:
    return [tuple(r[k] for k in COUNTERS) for r in rows]


def _read(out_dir, name: str):
    with open(os.path.join(out_dir, f"{name}.json")) as f:
        return json.load(f)


def _jax_tool_keys() -> tuple[list[str], list[str]]:
    """The keyword names of ``tools/campaign.py``'s per-point ``dict(...)``
    and of its summary ``dict(...)``."""
    with open(os.path.join(REPO, "tools", "campaign.py")) as f:
        tree = ast.parse(f.read())
    dicts = [[k.arg for k in node.keywords] for node in ast.walk(tree)
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dict"]
    point = next(d for d in dicts if "snr" in d)
    summary = next(d for d in dicts if "config" in d)
    return point, summary


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """A single-process CPU campaign over a blind and a known-h min-sum
    config (the latter folded, as its snr_fold asks)."""
    tmp = tmp_path_factory.mktemp("campaign")
    paths = [_cut(BLIND, tmp / "blind.toml"), _cut(KNOWN_MINSUM, tmp / "known_minsum.toml")]
    summary = campaign.run_campaign(str(tmp / "out"), paths, "cpu")
    return tmp, paths, summary


def test_files_carry_the_jax_tools_fields(one_process):
    """(a) Each config's file has exactly the JAX tool's per-point keys, in
    its order; campaign.json its summary keys, one entry a config in the
    order given."""
    tmp, paths, summary = one_process
    point_keys, summary_keys = _jax_tool_keys()
    assert point_keys == list(campaign.POINT_FIELDS)
    for name in ("blind", "known_minsum"):
        rows = _read(tmp / "out", name)
        assert len(rows) == 2 and all(list(r) == point_keys for r in rows)
        assert all(r["tot_blk"] == 64 for r in rows)
    written = _read(tmp / "out", "campaign")
    assert written == summary
    assert [list(s) for s in written] == [summary_keys] * 2
    assert [s["config"] for s in written] == ["blind", "known_minsum"]
    assert [(s["points"], s["blocks"]) for s in written] == [(2, 128), (2, 128)]


def test_directories_expand_to_their_tomls_sorted(tmp_path):
    """(a) A directory gives its ``*.toml`` in sorted order, as the JAX
    tool's ``expand``; files keep the order given."""
    from tools.campaign import expand as jax_expand

    d = tmp_path / "cfgs"
    d.mkdir()
    for name in ("b.toml", "a.toml", "c.txt", "0.toml"):
        (d / name).write_text("")
    args = [str(tmp_path / "z.toml"), str(d), str(tmp_path / "y.toml")]
    assert campaign.expand(args) == jax_expand(args) == [
        args[0], str(d / "0.toml"), str(d / "a.toml"), str(d / "b.toml"), args[2]]


def test_counters_equal_the_simulator_alone(one_process):
    """(b) Each config's counters in the campaign are bitwise those of
    ``Simulator(cfg, device="cpu").simulate()`` run alone."""
    tmp, paths, _ = one_process
    for path, name in zip(paths, ("blind", "known_minsum")):
        sim = Simulator(load_config(path), SimLogger(log_dir=None, stdout=False), device="cpu")
        alone = [{k: getattr(r, k) for k in COUNTERS} for r in sim.simulate()]
        assert _counters(_read(tmp / "out", name)) == _counters(alone)


def _jax_mesh_size(data_parallel: int, model_parallel: int, world: int, batch: int) -> int:
    """The devices the JAX harness lays its mesh over with ``world`` of the
    8 virtual CPU devices visible (kmldpc_tpu/sim/montecarlo.py:144-194):
    1 where it builds no mesh."""
    devices = jax.devices()[:world]
    if model_parallel > 1:
        ndata = data_parallel or max(1, len(devices) // model_parallel)
        mesh = get_mesh_2d(ndata, model_parallel, devices=devices)
    else:
        ndev = data_parallel or len(devices)
        if ndev == 1 or batch < ndev:
            return 1
        mesh = get_mesh(ndev)
    assert list(mesh.devices.flat) == jax.devices()[:mesh.devices.size]  # the first ones
    return mesh.devices.size


@pytest.mark.parametrize("data_parallel,model_parallel,world,batch", [
    (0, 0, 1, 1024), (0, 0, 4, 1024), (1, 0, 4, 1024), (2, 0, 4, 1024), (4, 0, 4, 1024),
    (0, 0, 8, 1024), (2, 0, 8, 1024), (0, 4, 8, 1024), (2, 4, 8, 1024), (0, 4, 6, 1024),
    (1, 4, 8, 1024), (0, 2, 8, 1024), (2, 4, 4, 1024), (0, 4, 3, 1024), (3, 2, 5, 1024),
    (0, 0, 8, 4), (2, 0, 4, 1), (2, 4, 8, 1),
])
def test_layout_takes_the_devices_jax_takes(data_parallel, model_parallel, world, batch):
    """(c) The port's layout takes as many ranks as the JAX harness takes
    devices, the first ones (one where a data-parallel batch is smaller
    than the mesh); where JAX raises, the port raises its words (then the
    ranks to start).  A data_parallel above the ranks runs its shards on
    fewer ranks (tests/test_torch_sim.py), as JAX's get_mesh takes the
    devices there are."""
    try:
        want = _jax_mesh_size(data_parallel, model_parallel, world, batch)
    except ValueError as jax_error:
        with pytest.raises(ValueError) as e:
            layout(data_parallel, model_parallel, world, batch)
        assert str(e.value).startswith(f"{jax_error} (one rank a device: start ")
        return
    ndata, nmodel = layout(data_parallel, model_parallel, world, batch)
    assert ndata * nmodel == want
    rows, _ = grid_ranks(ndata, nmodel)
    assert sorted(r for row in rows for r in row) == list(range(want))


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Five gloo launches at once: a 4-rank campaign over three layouts
    (data_parallel 2, 0 and 1), each of those configs alone on its own
    number of ranks, and the CLI on the data_parallel = 2 config over 4
    ranks.  Each rank of a campaign writes into ``out_<rank>``."""
    tmp = tmp_path_factory.mktemp("ranked")
    dp2 = _cut(BLIND, tmp / "dp2.toml", 2)
    dp0 = _cut(KNOWN_MINSUM, tmp / "dp0.toml", 0)
    dp1 = _cut(BLIND, tmp / "dp1.toml", 1)

    def camp(name, *cfgs):
        return ["-m", "kmldpc_torch.campaign", str(tmp / name / "out_{rank}"), *cfgs,
                "--device", "cpu"]

    outs = _launch_many([
        (4, camp("all", dp2, dp0, dp1)), (2, camp("dp2", dp2)), (4, camp("dp0", dp0)),
        (1, camp("dp1", dp1)),
        (4, ["-m", "kmldpc_torch", dp2, "--device", "cpu", "--no-log-file"]),
    ])
    return tmp, outs


def test_idle_ranks_change_nothing(ranked):
    """(d) In one 4-rank launch, each config's counters are bitwise those
    of the config alone on its own ranks (2, 4 and 1 process); only rank 0
    prints and writes."""
    tmp, outs = ranked
    for r in (1, 2, 3):
        assert not outs[0][r] and not (tmp / "all" / f"out_{r}").exists()
    assert [line for line in outs[0][0].splitlines() if line.startswith("===")] == [
        "=== dp2 ===", "=== dp0 ===", "=== dp1 ==="]
    assert "Mesh: 2 data ranks, data-parallel batch 32" in outs[0][0]
    assert "Mesh: 4 data ranks, data-parallel batch 32; SNR-fold 2" in outs[0][0]
    for name in ("dp2", "dp0", "dp1"):
        alone = _read(tmp / name / "out_0", name)
        assert _counters(_read(tmp / "all" / "out_0", name)) == _counters(alone)
        assert [p["tot_blk"] for p in alone] == [64, 64]
    assert [s["config"] for s in _read(tmp / "all" / "out_0", "campaign")] == [
        "dp2", "dp0", "dp1"]


def test_cli_runs_a_layout_on_the_first_ranks(ranked):
    """(e) ``python -m kmldpc_torch`` with data_parallel = 2 on 4 ranks runs
    on ranks 0-1 (it raised before the layout rule), printed by rank 0
    alone, with the counters of the 2-rank campaign."""
    tmp, outs = ranked
    cli = outs[4]
    assert "Distributed: 4 ranks, backend gloo" in cli[0]
    assert "Mesh: 2 data ranks, data-parallel batch 32" in cli[0]
    assert not any(cli[1:])
    last = {float(m[0]): tuple(int(v) for v in m[1:]) for m in re.findall(
        r"SNR = ([\d.]+) Total blk =\s+(\d+) Error blk =\s+(\d+) Error bit =\s+(\d+)", cli[0])}
    want = {p["snr"]: (p["tot_blk"], p["err_blk"], p["err_bit"])
            for p in _read(tmp / "dp2" / "out_0", "dp2")}
    assert last == want
