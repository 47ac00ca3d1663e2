"""The spans of the port's LiDAR-inertial step (`models/lio.py`), on the CPU
with the kernels' plain versions, on a batched step of two streams
(`parallel.streams.batched_lio_step`) in both its forms and on the
single-stream step:

* under `torch.profiler` the trace holds `lio.step` and, each directly
  inside it, `imu.init` (while a stream initializes), `kiss_icp.deskew`
  (the constant-velocity deskew while initializing), `ekf.predict`,
  `ekf.deskew`, `ekf.update` and the registration's spans
  (`voxel_map.downsample`, `kiss_icp.source`, `icp.register` holding
  `icp.fetch` / `icp.gn`, `voxel_map.insert`, `voxel_map.evict`);
* with the profiler off a step dispatches no `profiler.*` op;
* tracing changes nothing the step computes.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lidar_imu_slam_tpu_torch import config as C
from lidar_imu_slam_tpu_torch.host import synthetic as syn
from lidar_imu_slam_tpu_torch.models import lio
from lidar_imu_slam_tpu_torch.ops import preprocess as pre
from lidar_imu_slam_tpu_torch.parallel import streams
from lidar_imu_slam_tpu_torch.utils import profiling

torch.set_num_threads(1)

S = 2
CAP = 16
STEPS = 4
REGISTRATION = {
    "voxel_map.downsample": "lio.step",
    "kiss_icp.source": "lio.step",
    "icp.register": "lio.step",
    "icp.fetch": "icp.register",
    "icp.gn": "icp.register",
    "voxel_map.insert": "lio.step",
    "voxel_map.evict": "lio.step",
}
FILTER = {"lio.step": None, "ekf.predict": "lio.step", "ekf.deskew": "lio.step",
          "ekf.update": "lio.step"}
INITIALIZING = {"imu.init": "lio.step", "kiss_icp.deskew": "lio.step"}


def _cfg():
    cfg = C.PipelineConfig(
        lidar=C.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=C.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                        store_points=False, neighborhood=8),
        icp=C.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend="pallas", deskew=True),
        ekf=C.EkfConfig(lidar_pose_trail=4),
        imu=C.ImuConfig(max_init_count=20, max_samples_per_scan=CAP),
    )
    return streams.batch_config(cfg)


@pytest.fixture(scope="module")
def inputs():
    """Per step: the stacked scans and packets of S streams (the second
    stream's scans shifted one scan along the drive)."""
    cfg = _cfg()
    world = syn.make_world(seed=3, n_points=20000, extent=(30.0, 10.0, 4.0))
    gt = syn.make_trajectory(n_poses=STEPS + 2, speed=2.0, yaw_rate=0.03, dt=0.1)
    t, g, a = syn.make_imu_stream(gt, 0.1, imu_rate=100.0)
    cut = np.searchsorted(t, 0.1 * np.arange(STEPS + 1) + 1e-9)
    out = []
    for i in range(STEPS):
        raws = []
        for s in range(S):
            pts, rel = syn.render_scan_rolling(world, gt[i + s], gt[i + s + 1], 0.1, 1500, 0.5,
                                               30.0, noise=0.01, seed=10 * i + s)
            raws.append(pre.pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                          max_points=2048, device="cpu"))
        lo, hi = cut[i], cut[i + 1]
        pk = lio.pack_imu_packet(t[lo:hi], g[lo:hi], a[lo:hi], CAP, device="cpu")
        packets = type(pk)(*(torch.stack([f] * S) for f in pk))
        out.append((pre.preprocess_scan(pre.stack_raw_scans(raws), cfg.lidar), packets))
    return cfg, out


def _drive(cfg, inputs, upto):
    """The state before step `upto` and the host's sample count."""
    state = streams.init_batched_lio_state(cfg, S, "cpu")
    seen = 0
    for scans, packets in inputs[:upto]:
        state, _ = streams.batched_lio_step(state, scans, packets, cfg, init_samples=seen)
        seen += int(packets.mask[0].sum())
    return state, seen


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


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("form", ["two_branch", "imu_only"])
def test_batched_span_tree(tmp_path, inputs, form):
    cfg, steps = inputs
    k = 1 if form == "two_branch" else 3  # stream 0 is initialized after step 1
    state, seen = _drive(cfg, steps, k)
    scans, packets = steps[k]
    got = _spans(tmp_path, lambda: streams.batched_lio_step(state, scans, packets, cfg,
                                                            init_samples=seen))
    want = {**FILTER, **REGISTRATION, **(INITIALIZING if form == "two_branch" else {})}
    assert set(n for n, _ in got) == set(want), got
    assert all(want[n] == p for n, p in got), got
    counts = {name: sum(n == name for n, _ in got) for name in want}
    assert counts["lio.step"] == 1 and counts["icp.fetch"] == counts["icp.gn"] == 2
    # the two-branch form opens `ekf.update` for the IMU update and the seed
    assert counts["ekf.update"] == (2 if form == "two_branch" else 1)


def test_single_stream_span_tree(tmp_path, inputs):
    cfg, steps = inputs
    state = lio.init_state(cfg, "cpu")
    for scans, packets in steps[:3]:
        state, _ = lio.step(state, type(scans)(*(f[0] for f in scans)),
                            type(packets)(*(f[0] for f in packets)), cfg)
    scans, packets = steps[3]
    one = (type(scans)(*(f[0] for f in scans)), type(packets)(*(f[0] for f in packets)))
    got = _spans(tmp_path, lambda: lio.step(state, *one, cfg))
    want = {**FILTER, **REGISTRATION}
    assert set(n for n, _ in got) == set(want), got
    assert all(want[n] == p for n, p in got), got


@pytest.mark.parametrize("k", [1, 3])
def test_step_dispatches_no_profiler_op_when_off(inputs, k):
    cfg, steps = inputs
    state, seen = _drive(cfg, steps, k)
    mode = _OpNames()
    with mode:
        streams.batched_lio_step(state, *steps[k], cfg, init_samples=seen)
    assert len(mode.names) > 300
    assert not [n for n in mode.names if "profiler" in n]


def test_tracing_changes_nothing_computed(tmp_path, inputs):
    cfg, steps = inputs
    a, seen = _drive(cfg, steps, 0)
    b, _ = _drive(cfg, steps, 0)
    for scans, packets in steps:
        a, out_a = streams.batched_lio_step(a, scans, packets, cfg, init_samples=seen)
        with profiling.device_trace(str(tmp_path)):
            b, out_b = streams.batched_lio_step(b, scans, packets, cfg, init_samples=seen)
        seen += int(packets.mask[0].sum())
        for x, y in zip(torch.utils._pytree.tree_leaves(out_a),
                        torch.utils._pytree.tree_leaves(out_b)):
            assert torch.equal(x, y)
    for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
        assert torch.equal(x, y)
