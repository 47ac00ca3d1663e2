"""The port's LIO step over a leading stream axis (`models/lio.step_streams`,
`parallel/streams.batched_lio_step`) on the CPU, at the tiny sizes of
tests/test_torch_lio.py (`__graft_entry__._tiny_cfg` with a 4-pose trail)
under `streams.batch_config` (the classic registration with the fixed 2 x 4
ICP unroll; kernel K5's plain version here).

Four streams drive the same rolling-shutter scans with IMUs of 100, 70, 50
and 100 Hz (10, 7, 5 and 10 samples a scan, the last at the scan's end),
so their static initializations (20 samples) complete at scans 1, 2, 3
and 1, and the fourth stream's point noise differs. Compared:

* each stream of the batched step against the port's single-stream
  `lio.step` on that stream's inputs, from the same start: poses 1e-9 m /
  1e-9 rad, the filter mean 1e-9 and its covariance 1e-9 relative to its
  largest entry, the branch flags equal (the batched step folds a packet's
  covariance transitions in sample order where the single one scans them
  in log depth, and multiplies in batches: rounding at ~1e-15 that the
  registration carries over; measured up to 4e-13);
* each stream against the JAX package's `lio.step` on the same inputs, at
  test_torch_lio.py's free-drive bars: poses within 5e-3 m, the branch
  flags equal;
* the IMU-only form against the two-branch form, once every stream is
  initialized: bit for bit;
* `perturb_imu`: noise on the valid samples only, the same draw from the
  same generator state;
* no host read: no `aten::_local_scalar_dense` / `item` dispatched by a
  batched step in either form;
* the port against the plain reference `odom_bench/reference/lio.py`
  (its filter on the port's poses, its registration from the port's
  guesses: the tolerances in the test), with the reference's filter in f32
  failing that comparison.

Also: the step written into its own state tensors (`streams.
_write_leaves`, the body of `streams.LioStepGraph`) bit for bit the step.

`cuda`-marked: the batched step under `torch.cuda.set_sync_debug_mode
("error")`, and the card against the CPU; the step as a CUDA graph
(`streams.LioStepGraph`) against the eager step on the card, a state
tensor replaced between two replays included.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lidar_imu_slam_tpu_torch import config as tcfg
from lidar_imu_slam_tpu_torch.host import synthetic as tsyn
from lidar_imu_slam_tpu_torch.models import lio as tlio
from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan as tpack
from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan as tpre
from lidar_imu_slam_tpu_torch.ops.preprocess import stack_raw_scans
from lidar_imu_slam_tpu_torch.parallel import streams
from odom_bench import check
from odom_bench.reference import lio as ref_lio

torch.set_num_threads(1)

N_SCANS = 8
CAP = 16
MAX_POINTS = 2048
SAMPLES = (10, 7, 5, 10)  # IMU samples a scan (x 10 Hz: the IMU's rate), per stream
S = len(SAMPLES)
# the reference's voxel box (0.5 m voxels) around the drive, in a stream's frame
GRID = {"x": [-64, 72], "y": [-26, 26], "z": [-8, 14]}


def _cfg(c):
    """test_torch_lio.py's packed-map configuration as `streams.batch_config`
    makes it, with the 2 x 2 x 2 candidate block the reference fetches, in
    the package `c`."""
    return c.PipelineConfig(
        lidar=c.LidarConfig(max_range=30.0, min_range=0.5, max_points=MAX_POINTS),
        map=c.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                        store_points=False, auto_rebuild=False, neighborhood=8),
        icp=c.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                        gn_backend="pallas", deskew=True, batch_unroll_outer=2,
                        batch_unroll_inner=4),
        ekf=c.EkfConfig(lidar_pose_trail=4),
        imu=c.ImuConfig(max_init_count=20, max_samples_per_scan=CAP),
    )


@pytest.fixture(scope="module")
def drive():
    """Per stream and scan: (points, times, stamp, imu triple)."""
    world = tsyn.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = tsyn.make_trajectory(n_poses=N_SCANS + 1, speed=3.0, yaw_rate=0.02, dt=0.1)
    out = []
    for s, k in enumerate(SAMPLES):
        t, g, a = tsyn.make_imu_stream(gt, 0.1, imu_rate=10.0 * k)
        # scan i's packet: the samples in (0.1 i, 0.1 (i + 1)]
        cut = np.searchsorted(t, 0.1 * np.arange(N_SCANS + 1) + 1e-9)
        packets = [(t[lo:hi], g[lo:hi], a[lo:hi]) for lo, hi in zip(cut[:-1], cut[1:])]
        assert all(len(p[0]) == k for p in packets)
        steps = []
        for i in range(N_SCANS):
            pts, rel = tsyn.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5, 30.0,
                                                noise=0.01, seed=i + 100 * (s == 3))
            steps.append((pts, i * 0.1 + rel, i * 0.1, packets[i]))
        out.append(steps)
    return gt, out


def _inputs(drive, cfg, i, device="cpu"):
    """Step i's scans (S, ...) and packets (S, CAP, ...) and the per-stream
    singles."""
    _, per = drive
    raws = [tpack(p, time=t, stamp=st, max_points=MAX_POINTS, device=device)
            for p, t, st, _ in (per[s][i] for s in range(S))]
    packets = [tlio.pack_imu_packet(*per[s][i][3], CAP, device=device) for s in range(S)]
    scans = tpre(stack_raw_scans(raws), cfg.lidar)
    batched = type(packets[0])(*(torch.stack(f) for f in zip(*packets)))
    return scans, batched, [tpre(r, cfg.lidar) for r in raws], packets


def _run_batched(drive, cfg, device="cpu", hook=None):
    """The batched drive as a caller runs it: the host counts the packets'
    valid samples and tells the step once every stream is initialized."""
    state = streams.init_batched_lio_state(cfg, S, device)
    seen, outs = 0, []
    for i in range(N_SCANS):
        scans, packets, _, _ = _inputs(drive, cfg, i, device)
        if hook is not None:
            hook(i, state, scans, packets, seen)
        state, out = streams.batched_lio_step(state, scans, packets, cfg, init_samples=seen)
        seen += min(SAMPLES)
        # the caller's invariant: its count is a lower bound of what every
        # stream's initialization has consumed (up to the count it needs)
        assert bool((state.imu_init.count >= min(seen, cfg.imu.max_init_count)).all())
        outs.append(out)
    return state, outs


@pytest.fixture(scope="module")
def batched(drive):
    cfg = _cfg(tcfg)
    states = []
    state, outs = _run_batched(drive, cfg, hook=lambda i, st, *a: states.append(
        torch.utils._pytree.tree_map(torch.clone, st)))
    return cfg, states, state, outs


def _close_pose(a, b, tol):
    np.testing.assert_allclose(a[..., :3, 3], b[..., :3, 3], rtol=0, atol=tol)
    np.testing.assert_allclose(a[..., :3, :3], b[..., :3, :3], rtol=0, atol=tol)


def test_batched_matches_single_per_stream(drive, batched):
    cfg, _, state, outs = batched
    for s in range(S):
        single = tlio.init_state(cfg, "cpu")
        for i in range(N_SCANS):
            _, _, scans, packets = _inputs(drive, cfg, i)
            single, o = tlio.step(single, scans[s], packets[s], cfg)
            _close_pose(outs[i].pose[s].numpy(), o.pose.numpy(), 1e-9)
            assert bool(outs[i].used_imu[s]) == bool(o.used_imu)
            assert bool(outs[i].imu_initialized[s]) == bool(o.imu_initialized)
            np.testing.assert_allclose(outs[i].sigma[s].numpy(), o.sigma.numpy(), rtol=1e-9)
        np.testing.assert_allclose(state.ekf.m[s].numpy(), single.ekf.m.numpy(), rtol=0,
                                   atol=1e-9)
        P, Ps = state.ekf.P[s].numpy(), single.ekf.P.numpy()
        np.testing.assert_allclose(P / np.abs(Ps).max(), Ps / np.abs(Ps).max(), rtol=0,
                                   atol=1e-9)
        for f in ("last_imu", "vel_ring", "vel_ring_n", "init_v0", "init_t0", "scan_count"):
            np.testing.assert_allclose(getattr(state, f)[s].numpy(), getattr(single, f).numpy(),
                                       rtol=0, atol=1e-9, err_msg=f)
        for x, y in zip(state.odo.map, single.odo.map):
            assert torch.equal(x[s], y)


def test_initializations_complete_at_different_steps(batched):
    _, _, _, outs = batched
    done = np.stack([o.imu_initialized.numpy() for o in outs])
    used = np.stack([o.used_imu.numpy() for o in outs])
    first = [int(np.argmax(done[:, s])) for s in range(S)]
    assert first == [1, 2, 3, 1]  # 20 samples: 10 + 11, 7 + 8 + 8, 5 + 6 + 6 + 6
    assert (used[1:] == done[:-1]).all() and not used[0].any()
    assert [int(o.streams_initialized) for o in outs] == list(done.sum(1))
    assert [int(o.streams_imu) for o in outs] == list(used.sum(1))
    assert outs[0].pose.shape == (S, 4, 4) and outs[0].streams_imu.shape == ()


def test_imu_only_form_bit_equal_to_both_branches(drive, batched):
    cfg, states, _, _ = batched
    k = 4  # every stream initialized before step 4
    assert bool(states[k].imu_init.done.all())
    scans, packets, _, _ = _inputs(drive, cfg, k)
    a_state, a = tlio.step_streams(states[k], scans, packets, cfg, imu_ready=True)
    b_state, b = tlio.step_streams(states[k], scans, packets, cfg, imu_ready=False)
    for x, y in zip(torch.utils._pytree.tree_leaves((a_state, a)),
                    torch.utils._pytree.tree_leaves((b_state, b))):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_streams_match_jax(drive, batched):
    jax = pytest.importorskip("jax")
    from lidar_imu_slam_tpu import config as jcfg
    from lidar_imu_slam_tpu.models import lio as jlio
    from lidar_imu_slam_tpu.ops.preprocess import pack_raw_scan as jpack
    from lidar_imu_slam_tpu.ops.preprocess import preprocess_scan as jpre

    _, _, _, outs = batched
    cfg = _cfg(jcfg)
    step = jax.jit(jlio.step, static_argnames=("cfg",))
    for s in (0, 2):
        state = jlio.init_state(cfg)
        for i in range(N_SCANS):
            pts, t, st, imu = drive[1][s][i]
            scan = jpre(jpack(pts, time=t, stamp=st, max_points=MAX_POINTS), cfg.lidar)
            state, out = step(state, scan, jlio.pack_imu_packet(*imu, CAP), cfg=cfg)
            assert bool(out.used_imu) == bool(outs[i].used_imu[s])
            assert bool(out.imu_initialized) == bool(outs[i].imu_initialized[s])
            np.testing.assert_allclose(outs[i].pose[s, :3, 3].numpy(),
                                       np.asarray(out.pose)[:3, 3], rtol=0, atol=5e-3)


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_perturb_imu_valid_samples_only(seed):
    t = torch.arange(CAP, dtype=torch.float64) * 0.002 + 1.0
    g = torch.randn(CAP, 3, dtype=torch.float64)
    a = torch.randn(CAP, 3, dtype=torch.float64)
    mask = torch.arange(CAP) < 11
    packet = tlio.pack_imu_packet(t[:11].numpy(), g[:11].numpy(), a[:11].numpy(), CAP,
                                  device="cpu")
    gen = torch.Generator().manual_seed(seed)
    p1 = streams.perturb_imu(packet, gen, 5, 1e-3, 2e-2)
    gen.manual_seed(seed)
    p2 = streams.perturb_imu(packet, gen, 5, 1e-3, 2e-2)
    for x, y in zip(p1, p2):
        assert torch.equal(x, y)
    assert p1.gyro.shape == (5, CAP, 3) and torch.equal(p1.mask[3], mask)
    assert torch.equal(p1.time[2], packet.time)
    assert torch.equal(p1.gyro[:, 11:], packet.gyro[None, 11:].expand(5, -1, -1))
    assert torch.equal(p1.acc[:, 11:], torch.zeros(5, CAP - 11, 3, dtype=torch.float64))
    dg, da = p1.gyro[:, :11] - packet.gyro[:11], p1.acc[:, :11] - packet.acc[:11]
    assert (dg != 0).all() and (da != 0).all()
    assert 0.5e-3 < float(dg.std()) < 2e-3 and 1e-2 < float(da.std()) < 4e-2
    assert not torch.equal(p1.gyro[0], p1.gyro[1])


class _OpNames(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("step_index", [1, 5])  # two-branch form, IMU-only form
def test_batched_step_reads_nothing_from_the_device(drive, batched, step_index):
    cfg, states, _, _ = batched
    scans, packets, _, _ = _inputs(drive, cfg, step_index)
    seen = step_index * min(SAMPLES)
    mode = _OpNames()
    with mode:
        streams.batched_lio_step(torch.utils._pytree.tree_map(torch.clone, states[step_index]),
                                 scans, packets, cfg, init_samples=seen)
    assert len(mode.names) > 300
    reads = [n for n in mode.names if "_local_scalar_dense" in n or n.endswith(".item")
             or "aten.item" in n or "is_nonzero" in n]
    assert not reads, reads


def _follow(drive, cfg, states, state, outs, filter_dtype):
    """The reference over every step of the four streams, on the port's
    preprocessed scans and packets, from the port's guesses and poses: the
    largest pose, filter-mean and deskew gaps, and the covariance gap at the
    end relative to its largest entry."""
    ref = ref_lio.RefLio(dataclasses.asdict(cfg), S, GRID, "cpu", filter_dtype=filter_dtype)
    gaps = dict.fromkeys(("pose_gap_m", "pose_gap_rad", "mean_gap", "deskew_gap_m"), 0.0)
    for i in range(N_SCANS):
        sc, pk, _, _ = _inputs(drive, cfg, i)
        own, _, desk, _ = ref.step(sc.xyz, sc.tau, sc.rel_t, sc.mask, sc.t_begin, sc.t_end,
                                   pk.time, pk.gyro, pk.acc, pk.mask, outs[i].guess,
                                   outs[i].pose)
        gm, gr = check.pose_gaps(own, outs[i].pose)
        after = states[i + 1] if i + 1 < N_SCANS else state
        gaps["pose_gap_m"] = max(gaps["pose_gap_m"], gm)
        gaps["pose_gap_rad"] = max(gaps["pose_gap_rad"], gr)
        gaps["mean_gap"] = max(gaps["mean_gap"], float(torch.amax(torch.abs(
            ref.m[:, :16].double() - after.ekf.m[:, :16]))))
        gaps["deskew_gap_m"] = max(gaps["deskew_gap_m"], float(torch.amax(torch.abs(
            desk - outs[i].scan_deskewed)[sc.mask])))
    P = state.ekf.P
    gaps["cov_gap_rel"] = float(torch.amax(torch.abs(ref.P.double() - P)) / torch.amax(P.abs()))
    return gaps


def test_port_follows_the_plain_reference(drive, batched):
    """The plain reference (`odom_bench/reference/lio.py`: the predict walked
    sample by sample, the trail pair by pair, the undistortion in f64) on
    the port's poses and guesses: the filter mean 1e-9 and its covariance
    1e-12 relative (measured 1.8e-15 / 2.1e-15), the deskewed points 2e-5 m
    (f32 against f64: 5.7e-6), and the registrations of those points 1e-4
    m / 1e-4 rad (1.5e-5 m); the reference's filter in f32 parts from the
    port's mean by more than 1e-7."""
    cfg, states, state, outs = batched
    near = _follow(drive, cfg, states, state, outs, torch.float64)
    far = _follow(drive, cfg, states, state, outs, torch.float32)
    assert near["pose_gap_m"] < 1e-4 and near["pose_gap_rad"] < 1e-4, near
    assert near["mean_gap"] < 1e-9 and near["cov_gap_rel"] < 1e-12, near
    assert near["deskew_gap_m"] < 2e-5, near
    assert far["mean_gap"] > 1e-7, far


@pytest.mark.cuda
def test_batched_step_on_the_card_syncs_nothing_and_matches_the_cpu(drive, batched):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no interpret mode")
    cfg, _, _, outs = batched
    dev = torch.device("cuda", 0)
    state = streams.init_batched_lio_state(cfg, S, dev)
    seen, card = 0, []
    for i in range(N_SCANS):
        scans, packets, _, _ = _inputs(drive, cfg, i, dev)
        # from step 2 on (the first steps build the constants on the card):
        # the two-branch form at steps 2 and 3, the IMU branch alone after
        torch.cuda.set_sync_debug_mode("error" if i >= 2 else "default")
        try:
            state, out = streams.batched_lio_step(state, scans, packets, cfg, init_samples=seen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        seen += min(SAMPLES)
        card.append(out.pose.cpu())
    for i in range(N_SCANS):
        _close_pose(card[i].numpy(), outs[i].pose.numpy(), 1e-4)


def test_step_written_into_its_state_is_the_step(drive, batched):
    """`LioStepGraph`'s body on the CPU: the IMU-only step on a state, then
    its result written into that state's own tensors, gives the step's
    state bit for bit (the map tables it updated in place skipped)."""
    cfg, states, _, _ = batched
    k = 5
    scans, packets, _, _ = _inputs(drive, cfg, k)
    want, _ = streams.batched_lio_step(torch.utils._pytree.tree_map(torch.clone, states[k]),
                                       scans, packets, cfg, init_samples=k * min(SAMPLES))
    own = torch.utils._pytree.tree_map(torch.clone, states[k])
    ptrs = [x.data_ptr() for x in torch.utils._pytree.tree_leaves(own)]
    new, _ = tlio.step_streams(own, scans, packets, cfg, imu_ready=True, inplace=True)
    streams._write_leaves(own, new)
    assert [x.data_ptr() for x in torch.utils._pytree.tree_leaves(own)] == ptrs
    for x, y in zip(torch.utils._pytree.tree_leaves(own), torch.utils._pytree.tree_leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_write_leaves_reads_an_aliased_source_first():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    streams._write_leaves((a, b), (b, a))  # a swap: each source is the other's target
    assert a.tolist() == [10.0, 11.0, 12.0, 13.0] and b.tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        streams._write_leaves((a,), (torch.zeros(3),))


def test_step_graph_needs_a_card(batched):
    cfg, states, _, _ = batched
    with pytest.raises(ValueError):
        streams.LioStepGraph(states[5], None, None, cfg)


@pytest.mark.cuda
def test_graphed_step_on_the_card_matches_the_eager_step(drive, batched):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels")
    cfg = batched[0]
    dev = torch.device("cuda", 0)

    def run(graphed):
        state = streams.init_batched_lio_state(cfg, S, dev)
        seen, graph, outs = 0, None, []
        for i in range(N_SCANS):
            scans, packets, _, _ = _inputs(drive, cfg, i, dev)
            if graphed and graph is None and i >= 5:  # after an eager IMU-only step
                assert seen >= cfg.imu.max_init_count
                graph = streams.LioStepGraph(state, scans, packets, cfg)
            if graph is not None:
                state, out = graph(state, scans, packets)
            else:
                state, out = streams.batched_lio_step(state, scans, packets, cfg,
                                                      init_samples=seen)
            if i == 6:  # a caller that replaces a state tensor between two steps
                m = state.ekf.m.clone()
                m[1, 0] += 0.05
                state = state._replace(ekf=state.ekf._replace(m=m))
            seen += min(SAMPLES)
            outs.append(torch.utils._pytree.tree_map(torch.clone, out))
        return state, outs

    eager_state, eager = run(False)
    graph_state, graphed = run(True)
    for i in range(N_SCANS):
        _close_pose(graphed[i].pose.cpu().numpy(), eager[i].pose.cpu().numpy(), 1e-9)
        assert torch.equal(graphed[i].used_imu, eager[i].used_imu)
    for x, y in zip(torch.utils._pytree.tree_leaves(graph_state.ekf),
                    torch.utils._pytree.tree_leaves(eager_state.ekf)):
        np.testing.assert_allclose(x.cpu().double().numpy(), y.cpu().double().numpy(),
                                   rtol=0, atol=1e-9)
    for x, y in zip(graph_state.odo.map, eager_state.odo.map):
        assert torch.equal(x, y)
