"""`common/spans.py` and the four span metrics on the CPU: the attribution
of a hand-made Chrome trace (runtime and driver launches, nested spans, a
second thread, an operation launched under no span, one without its
launch, one outside the window), the readers' values on it and their None
without device time or without the program's spans, the profiler's events
read as the Chrome trace holds them, and a traced small cell."""

import json
import types

import pytest
import torch

from odom_bench import harness
from odom_bench.common import manifest, spans, trace
from odom_bench.tests import cells

READERS = ("preprocess_device_ms", "map_device_ms", "icp_fetch_device_ms",
           "register_self_device_ms")
MAIN, OTHER = 1, 2
RANGES = [  # (name, start, end) on the main thread, in µs
    ("odom_bench.gather", 10, 50),
    ("odom_bench.preprocess", 50, 150), ("preprocess.scan", 55, 145),
    ("odom_bench.register", 150, 900), ("kiss_icp.step", 155, 890),
    ("kiss_icp.deskew", 160, 200), ("voxel_map.downsample", 200, 260),
    ("kiss_icp.source", 260, 300), ("icp.register", 300, 700),
    ("icp.fetch", 310, 350), ("icp.gn", 350, 400), ("icp.fetch", 400, 450),
    ("icp.gn", 450, 500), ("voxel_map.insert", 700, 800), ("voxel_map.evict", 800, 850),
]
OPS = [  # (launch µs or None, launch category, thread, device category, name, device µs)
    (20, "cuda_runtime", MAIN, "kernel", "gather_kernel", 5),
    (60, "cuda_runtime", MAIN, "kernel", "radix_sort", 10),
    (148, "cuda_runtime", MAIN, "gpu_memcpy", "Memcpy HtoD", 1),  # harness range only
    (157, "cuda_runtime", MAIN, "kernel", "pose_math", 2),
    (170, "cuda_runtime", MAIN, "kernel", "deskew", 4),
    (210, "cuda_runtime", MAIN, "kernel", "segmented_sort", 20),
    (270, "cuda_runtime", MAIN, "kernel", "iqr", 6),
    (305, "cuda_runtime", MAIN, "kernel", "anchor", 3),
    (320, "cuda_runtime", MAIN, "kernel", "gather_planes", 7),
    (360, "cuda_driver", MAIN, "kernel", "gn_cluster_kernel", 9),
    (410, "cuda_runtime", MAIN, "kernel", "gather_planes", 7),
    (460, "cuda_runtime", MAIN, "kernel", "gn_cluster_kernel", 9),
    (600, "cuda_runtime", OTHER, "kernel", "other_thread", 3),
    (710, "cuda_runtime", MAIN, "gpu_memset", "Memset", 2),
    (810, "cuda_runtime", MAIN, "kernel", "masked_fill", 5),
    (950, "cuda_runtime", MAIN, "kernel", "after_the_step", 4),  # under no span
    (None, None, MAIN, "kernel", "launch_not_traced", 1),
    (1100, "cuda_runtime", MAIN, "kernel", "after_the_window", 50),
]


def hand_made_trace() -> list:
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "pid": 7,
           "tid": MAIN, "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "other.range", "pid": 7,
           "tid": OTHER, "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 7, "tid": MAIN,
           "ts": 61.0, "dur": 5.0},
          {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 61.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 7, "tid": MAIN,
            "ts": float(s), "dur": float(e - s)} for n, s, e in RANGES]
    for corr, (t, lcat, tid, dcat, name, dur) in enumerate(OPS, start=100):
        if t is not None:
            launch = "cuLaunchKernelEx" if lcat == "cuda_driver" else "cudaLaunchKernel"
            ev.append({"ph": "X", "cat": lcat, "name": launch, "pid": 7, "tid": tid,
                       "ts": float(t), "dur": 2.0, "args": {"correlation": corr}})
        start = (t if t is not None else 900) + 5.0
        ev.append({"ph": "X", "cat": dcat, "name": name, "pid": 0, "tid": "stream 7",
                   "ts": start, "dur": float(dur), "args": {"correlation": corr}})
    return ev


def test_attribute_hand_made_trace():
    sp = spans.attribute(hand_made_trace())
    us = {k: round(v * 1e6, 6) for k, v in sp.self.items()}
    assert us == {"odom_bench.gather": 5, "preprocess.scan": 10, "odom_bench.preprocess": 1,
                  "kiss_icp.step": 2, "kiss_icp.deskew": 4, "voxel_map.downsample": 20,
                  "kiss_icp.source": 6, "icp.register": 3, "icp.fetch": 14, "icp.gn": 18,
                  "other.range": 3, "voxel_map.insert": 2, "voxel_map.evict": 5,
                  spans.NO_SPAN: 4, spans.NO_LAUNCH: 1}
    total = {k: round(v * 1e6, 6) for k, v in sp.total.items()}
    assert total["kiss_icp.step"] == 2 + 4 + 20 + 6 + 3 + 14 + 18 + 2 + 5
    assert total["icp.register"] == 3 + 14 + 18
    assert total["odom_bench.register"] == total["kiss_icp.step"]
    assert total["odom_bench.preprocess"] == 11 and total["other.range"] == 3
    assert round(sp.device_s * 1e6, 6) == sum(us.values()) == 98  # not the op after the window
    assert sp.ops[("icp.gn", "gn_cluster_kernel")] == [pytest.approx(18e-6), 2]
    assert sp.opened["icp.fetch"] == 2 and sp.opened["kiss_icp.step"] == 1
    assert sp.parents["icp.gn"] == {"icp.register"}
    assert sp.parents["preprocess.scan"] == {"odom_bench.preprocess"}
    assert sp.parents["odom_bench.gather"] == {None}
    # host self: the step's 735 µs less its nested spans' 40 + 60 + 40 + 400 + 100 + 50
    assert sp.host_self["kiss_icp.step"] == pytest.approx(45e-6)
    assert sp.host_self["icp.register"] == pytest.approx(210e-6)


def _read(name, ctx):
    return harness._load_metric(name, manifest.BENCH_DIR).read(ctx)


def test_readers_on_the_hand_made_trace():
    ctx = types.SimpleNamespace(trace=object(), profiled_steps=2,
                                spans=spans.attribute(hand_made_trace()))
    got = {name: _read(name, ctx) for name in READERS}
    want_us = {"preprocess_device_ms": 10 + 4, "map_device_ms": 20 + 6 + 2 + 5,
               "icp_fetch_device_ms": 14, "register_self_device_ms": 2 + 3}
    assert got == {k: pytest.approx(v * 1e-3 / 2) for k, v in want_us.items()}


def _without(names) -> list:
    return [e for e in hand_made_trace()
            if not (e.get("cat") == "user_annotation" and e["name"] in names)]


@pytest.mark.parametrize("case", ["no_trace", "no_device_time", "no_program_spans"])
def test_readers_return_none(case):
    ctx = types.SimpleNamespace(trace=None, profiled_steps=2)
    if case == "no_device_time":  # a CPU run: the spans open, nothing runs on a device
        ctx.trace = object()
        ctx.spans = spans.attribute([e for e in hand_made_trace()
                                     if e.get("cat") not in trace.DEVICE_CATS])
    elif case == "no_program_spans":  # a program without the spans: the harness's alone
        ctx.trace = object()
        ctx.spans = spans.attribute(_without({n for n, _, _ in RANGES
                                              if not n.startswith("odom_bench.")}))
    assert {name: _read(name, ctx) for name in READERS} == dict.fromkeys(READERS)


def test_events_of_reads_the_chrome_traces_ranges(tmp_path):
    from lidar_imu_slam_tpu_torch.utils import profiling

    @profiling.annotate("test.inner")
    def inner(x):
        return (x @ x).sum()

    x = torch.randn(32, 32)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function(trace.WINDOW_RANGE):
        for _ in range(3):
            with profiling.annotate("test.outer"):
                inner(x)
    prof.stop()
    from_events = spans.attribute(spans.events_of(prof))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    from_file = spans.load(str(tmp_path / "trace.json"))
    assert from_events.opened == from_file.opened == {"test.outer": 3, "test.inner": 3}
    assert from_events.parents == from_file.parents == {"test.outer": {None},
                                                        "test.inner": {"test.outer"}}
    for name in from_file.host_self:
        assert from_events.host_self[name] == pytest.approx(from_file.host_self[name],
                                                            abs=2e-6)


def test_traced_small_cell_opens_the_span_tree(tmp_path, monkeypatch):
    kept = []
    of = spans.of

    def keep(ctx):
        kept.append(of(ctx))
        return kept[-1]

    monkeypatch.setattr(spans, "of", keep)
    name = cells.build(str(tmp_path), "kitti_64beam", streams=2, compare=1)
    res = harness.run_cell(str(tmp_path), name, 2**31 + 77, 0.0, True, device="cpu",
                           bench_dir=str(tmp_path), log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert kept and all(sp is kept[0] for sp in kept)  # one attribution, kept on ctx
    sp = kept[0]
    with open(tmp_path / "mixes" / "s2.json") as f:
        steps = json.load(f)["profile_steps"]
    step = "kiss_icp.step"
    assert sp.opened == {"odom_bench.gather": steps, "odom_bench.preprocess": steps,
                         "odom_bench.register": steps, "preprocess.scan": steps,
                         step: steps, "kiss_icp.deskew": steps,
                         "voxel_map.downsample": steps, "kiss_icp.source": steps,
                         "icp.register": steps, "icp.fetch": 2 * steps, "icp.gn": 2 * steps,
                         "voxel_map.insert": steps, "voxel_map.evict": steps}
    assert sp.parents["icp.gn"] == {"icp.register"} and sp.parents[step] == {
        "odom_bench.register"}
    assert sp.device_s == 0.0
    assert not set(READERS) & set(res["metrics"])  # no device time on the CPU
