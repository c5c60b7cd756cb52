"""The trace's reduction and every per-layer reader on a canned profiler
event list: device time by the host span that launched it, K1's time by
its kernel's name, the idle gaps by what the host was in."""

import pytest

import torch

from linkbench import judge, roofline, spec
from linkbench.reference import chain as ref
from linkbench.trace import Summary, summarize
from linkbench.window import CALL_SPAN, TRACED_SWEEP, Call, Sweep, Window

MS = 1_000_000  # ns


def canned():
    """One traced sweep of 10 ms: a runner call from 1 to 9 ms holding the
    chain's labels; device kernels, each tied by correlation id to the host
    op that launched it."""
    sweep = (0, 10 * MS)
    calls = [(1 * MS, 9 * MS, CALL_SPAN)]
    labels = [(1 * MS, 2 * MS, "frontend"), (2 * MS, 3 * MS, "kmeans"), (3 * MS, 4 * MS, "metric"),
              (4 * MS, 8 * MS, "decode"), (8 * MS, 9 * MS, "counters")]
    host = {1: int(1.5 * MS), 2: int(2.2 * MS), 3: int(2.4 * MS), 4: int(3.5 * MS),
            5: int(4.5 * MS), 6: int(5.0 * MS), 7: int(8.5 * MS)}
    device = [  # (start, end, name, correlation id)
        (int(1.6 * MS), int(1.8 * MS), "randn_kernel", 1),
        (int(2.3 * MS), int(2.5 * MS), "void kmeans_kernel<4, false>(...)", 2),
        (int(2.5 * MS), int(2.6 * MS), "fill_kernel", 3),  # K1's wrapper, not K1
        (int(3.6 * MS), int(3.9 * MS), "demap_kernel", 4),
        (int(4.6 * MS), int(5.6 * MS), "elementwise_kernel", 5),
        (int(5.6 * MS), int(7.6 * MS), "gather_kernel", 6),
        (int(8.6 * MS), int(8.7 * MS), "reduce_kernel", 7),
    ]
    return summarize(sweep, labels, calls, host, device)


def test_device_time_by_label_and_kernel():
    s = canned()
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.0039)
    assert s.by_label == pytest.approx({"frontend": 0.0002, "kmeans": 0.0003, "metric": 0.0003,
                                        "decode": 0.003, "counters": 0.0001})
    assert s.kernel_s("kmeans_kernel") == pytest.approx(0.0002)
    # a gap is named by what the host was in at its middle: 0-1.6 ms and
    # 8.7-10 ms the harness, the others kmeans, metric, decode, counters
    assert s.idle_by_host == pytest.approx({"harness": 0.0016 + 0.0013, "kmeans": 0.0005,
                                            "metric": 0.001, "decode": 0.0007,
                                            "counters": 0.001})


def test_an_activity_outside_the_sweep_is_left_out():
    s = summarize((0, 10 * MS), [], [], {}, [(11 * MS, 12 * MS, "late", 9),
                                            (1 * MS, 2 * MS, "k", 8)])
    assert s.by_kernel == {"k": pytest.approx(0.001)} and s.busy_s == pytest.approx(0.001)
    assert s.by_label == {}
    assert summarize(None, [], [], {}, []).window_s == 0.0


def _ctx(cell_name: str, ops_per_s=None, window=None, batch=16):
    """The context ``run_cell`` hands every reader, for a cell cut to
    ``batch`` codewords a launch."""
    cell = spec.load_cell(cell_name, overrides={"tpu": {"batch": batch}})
    link, g = judge.reference_link(cell, torch.float64, "cpu")
    return {"cell": cell, "seed": 31, "window": window or Window(1.0), "link": link,
            "graph": g, "memory_peak": 0, "ops_per_s": ops_per_s}


def read(metric, trace, ctx):
    return spec.metric_reader(metric).read(trace, ctx)


def test_ms_per_kblk_readers():
    s = canned()
    s.blocks = 2000
    ctx = _ctx("peg2304-qpsk.blind")
    assert read("frontend_ms_per_kblk", s, ctx) == pytest.approx(0.2 / 2)
    assert read("metric_ms_per_kblk", s, ctx) == pytest.approx(0.3 / 2)
    assert read("decode_ms_per_kblk", s, ctx) == pytest.approx(3.0 / 2)
    assert read("demap_ms_per_kblk", s, ctx) is None  # nothing under demap: no reading
    assert read("device_idle_share", s, ctx) == pytest.approx(1 - 0.39)
    empty = Summary(0.0, 0.0, {}, {}, {})
    assert read("device_idle_share", empty, ctx) is None
    assert read("decode_ms_per_kblk", empty, ctx) is None


def test_kmeans_roofline_takes_the_kernel_by_name():
    """The passes each row needs, counted by the reference on the traced
    launches' own draws, over the time of the kernel named kmeans_kernel."""
    s = canned()
    s.launches = [(5.0, 0), (7.5, 0)]
    ctx = _ctx("peg2304-qpsk.blind", ops_per_s=3.3e13)
    seed = judge.sweep_seed(ctx["seed"], TRACED_SWEEP)
    passes = [ref.kmeans_passes(ctx["link"], ctx["graph"], seed, snr, n) for snr, n in s.launches]
    assert all(p.numel() == 16 for p in passes)
    nsym = 1152  # PEG2304 over QPSK
    least = sum(roofline.k1_least_s(16, nsym, 4, float(p.sum()), 3.3e13) for p in passes)
    assert read("kmeans_roofline", s, ctx) == pytest.approx(100 * least / 0.0002)
    assert read("kmeans_roofline", s, _ctx("peg2304-qpsk.blind")) is None  # no peak: no reading
    s.launches = []
    assert read("kmeans_roofline", s, ctx) is None


def test_decode_roofline_counts_needed_iterations():
    s = canned()
    s.blocks, s.iters = 2048, 2048 * 6.5
    ctx = _ctx("nr-bg2-16qam.known", ops_per_s=3.3e13)
    code = ctx["link"].code
    ops_s = 8 * code.num_edges * s.iters / 3.3e13
    bytes_s = 2048 * (4 * code.tx_len + code.info_bits) / 3.35e12
    assert read("decode_roofline", s, ctx) == pytest.approx(100 * max(ops_s, bytes_s) / 0.003)
    s.iters = 0.0
    assert read("decode_roofline", s, ctx) is None


def test_harness_reads_the_host_time_outside_runner_calls():
    """Each sweep's time less its runner calls', per 1000 blocks, over the
    sweeps after the traced one."""
    window = Window(1.0)
    window.sweeps = [Sweep(0.0, 3.0, 1024), Sweep(3.0, 5.0, 2048), Sweep(5.0, 6.5, 2048)]
    window.calls = [Call(0, 0.5, 2.5, []), Call(1, 3.5, 4.5, []), Call(1, 4.6, 4.9, []),
                    Call(2, 5.2, 6.2, [])]
    ctx = _ctx("nr-bg2-16qam.known", window=window)
    outside = (2.0 - 1.3) + (1.5 - 1.0)  # sweep 0, the traced one, left out
    assert read("harness_ms_per_kblk", canned(), ctx) == pytest.approx(outside * 1e3 / 4.096)
    window.sweeps = window.sweeps[:1]
    assert read("harness_ms_per_kblk", canned(), ctx) is None
