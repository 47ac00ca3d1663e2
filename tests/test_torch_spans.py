"""The port's spans (`utils/profiling.annotate` at the layers of a step),
on the CPU with the kernels' plain versions:

* `annotate` works as a `with` block and as a decorator, and opens no
  `record_function` while no profiler records;
* a step of the batched path (at odom_bench/tests/cells.py's scale), of
  the single-stream fast path and of the classic f64 path dispatches no
  `profiler.*` op with the profiler off, and under `torch.profiler` its
  trace holds every span of the tree, each directly inside its parent;
* the spans change nothing the step computes.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lidar_imu_slam_tpu_torch import config as C
from lidar_imu_slam_tpu_torch.host import synthetic as syn
from lidar_imu_slam_tpu_torch.models import kiss_icp
from lidar_imu_slam_tpu_torch.ops import preprocess as pre
from lidar_imu_slam_tpu_torch.parallel import streams
from lidar_imu_slam_tpu_torch.utils import profiling

torch.set_num_threads(1)

S = 2
POINTS = 4096
STEP = "kiss_icp.step"
# span -> the span it opens directly inside (None: outside every span)
TREE = {
    "preprocess.scan": None,
    STEP: None,
    "kiss_icp.deskew": STEP,
    "voxel_map.downsample": STEP,
    "kiss_icp.source": STEP,
    "icp.register": STEP,
    "icp.fetch": "icp.register",
    "icp.gn": "icp.register",
    "voxel_map.insert": STEP,
    "voxel_map.evict": STEP,
}


def _cfg(path: str):
    """odom_bench/tests/cells.py's small kitti_64beam, per path."""
    cfg = C.kitti_64beam()
    cfg = cfg.replace(
        lidar=dataclasses.replace(cfg.lidar, max_points=POINTS),
        map=dataclasses.replace(cfg.map, capacity=16384),
        icp=dataclasses.replace(cfg.icp, max_map_points=2048, max_source_points=512,
                                gn_backend="xla" if path == "classic" else "pallas"))
    return streams.batch_config(cfg, 2, 4) if path == "batched" else cfg


@pytest.fixture(scope="module")
def raws():
    world = syn.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = syn.make_trajectory(n_poses=6, speed=2.0, yaw_rate=0.03, dt=0.1)
    out = []
    for i in range(5):
        pts, rel = syn.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 3000, 0.5, 30.0,
                                           noise=0.01, seed=i)
        out.append(pre.pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                     max_points=POINTS, device="cpu"))
    return out


class Driver:
    """Steps of one path from a fresh state: scan k is stream s's scan k + s."""

    def __init__(self, path, raws):
        self.path, self.raws, self.cfg, self.k = path, raws, _cfg(path), 0
        self.state = (streams.init_batched_state(self.cfg, S, "cpu") if path == "batched"
                      else kiss_icp.init_state(self.cfg, "cpu"))

    def step(self):
        if self.path == "batched":
            raw = pre.stack_raw_scans([self.raws[self.k + s] for s in range(S)])
            scan = pre.preprocess_scan(raw, self.cfg.lidar)
            self.state, out = streams.batched_register_frame_step(self.state, scan, self.cfg)
        else:
            scan = pre.preprocess_scan(self.raws[self.k], self.cfg.lidar)
            self.state, out = kiss_icp.register_frame_step(self.state, scan, self.cfg)
        self.k += 1
        return out


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _spans(tmp_path, fn) -> list:
    """(name, parent span) of every span the profiled call opened."""
    with profiling.device_trace(str(tmp_path)):
        fn()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                    key=lambda r: (r[0], -r[1]))
    out, stack = [], []
    for s, e, name in ranges:
        while stack and stack[-1][0] <= s:
            stack.pop()
        out.append((name, stack[-1][1] if stack else None))
        stack.append((e, name))
    return out


def test_annotate_is_a_block_and_a_decorator(tmp_path):
    @profiling.annotate("test.inner")
    def inner(x):
        """Doubles x."""
        return 2 * x

    def run():
        with profiling.annotate("test.outer"):
            assert inner(torch.ones(3)).sum() == 6
        with pytest.raises(ValueError), profiling.annotate("test.raises"):
            raise ValueError("passes through")

    assert inner.__name__ == "inner" and inner.__doc__ == "Doubles x."
    assert _spans(tmp_path, run) == [("test.outer", None), ("test.inner", "test.outer"),
                                     ("test.raises", None)]


def test_annotate_opens_nothing_when_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling._profiler_enabled()

    @profiling.annotate("test.decorated")
    def f():
        with profiling.annotate("test.block"):
            return 1

    assert f() == 1


@pytest.mark.parametrize("path", ["batched", "fast", "classic"])
def test_step_dispatches_no_profiler_op_when_off(raws, path):
    d = Driver(path, raws)
    d.step()
    d.step()
    mode = _OpNames()
    with mode:
        d.step()
    assert len(mode.names) > 100
    assert not [n for n in mode.names if "profiler" in n]


@pytest.mark.parametrize("path", ["batched", "fast", "classic"])
def test_span_tree_under_profiler(tmp_path, raws, path):
    d = Driver(path, raws)
    d.step()
    d.step()
    got = _spans(tmp_path, d.step)
    want = dict(TREE)
    if path == "classic":
        del want["icp.gn"]  # the f64 loops launch no GN kernel
    counts = {name: sum(n == name for n, _ in got) for name in want}
    assert set(n for n, _ in got) == set(want), got
    assert all(want[n] == p for n, p in got), got
    assert counts[STEP] == 1 and counts["icp.fetch"] >= 1
    if path == "batched":  # the fixed 2 x 4 unroll: two fetches, two K5 calls
        assert counts["icp.fetch"] == counts["icp.gn"] == 2
        assert len(got) == 12
    if path == "fast":  # one fetch and one K1 call a round
        assert counts["icp.fetch"] == counts["icp.gn"]


def test_spans_change_nothing_computed(tmp_path, raws):
    a, b = Driver("batched", raws), Driver("batched", raws)
    for _ in range(3):
        out_a = a.step()
        with profiling.device_trace(str(tmp_path)):
            out_b = b.step()
        np.testing.assert_array_equal(out_a.pose.numpy(), out_b.pose.numpy())
        np.testing.assert_array_equal(out_a.sigma.numpy(), out_b.sigma.numpy())
    for x, y in zip(a.state.map, b.state.map):
        assert torch.equal(x, y)
