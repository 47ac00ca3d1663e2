"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite).

Tolerances: K2 / K3 1e-9 on every f64 output, row and epilogue (both
sides f64, different operation order), the i32 outputs equal, K3's f32 map
delta bit-equal to the kernel's own f64 delta rounded to f32, and a
repeated launch bit-equal; K1,
K4 and K5 R 1e-5 and t 1e-4 m, iterations and flags equal, n_corr within
1 (the f32 per-query work may contract into FMAs in the kernel), and a
repeated launch bit-equal (the cluster's fixed-order reduction; K1 / K4
over G > 1 clusters at 16,384 and 9,000 queries, the clusters' sums added
in cluster order), and a shape of more clusters than the card holds at
once raising before it launches; K6
indices equal and d^2 bit-equal (its exact re-check rounds every f32 step
as the plain version does; its filter only decides which entries are
re-checked), on random pools and on every case of tools/nn_cases.py; card against CPU poses 1e-4 over a short drive,
single-stream or batched, fast or classic; the probe gathers `take_rows`
and `take_lanes` bit-equal in every launch variant; `gn_proto` R and t within 1e-5 (the kernel and
the plain version differ only by the order of the f32 block sums) and
`conv` equal, at every cluster size, and a repeated launch bit-equal; a short LIO drive, card against CPU, 1e-4 on both branches.
The ICP candidate fetch kernel writes the plain version's planes bit for
bit (+inf positions included) on every case of tools/fetch_cases.py, and
a 16-step batched drive of each batched preset gives bit-equal poses and
maps with the kernel and with the plain fetch on the card. The IMU deskew
kernel writes the plain per-point pass's points bit for bit on every case
of tools/deskew_cases.py (64 streams x 16,384 points of the LIO ensemble's
drive, no stream axis, masked NaN points, times on an offset, times past
the last one, a three-sample packet, the small-angle branch, the LIO
slice's 131,072 points and 17-entry trail without a stream axis), and one
IMU-branch batched LIO step launches it once and gives the poses, outputs
and state of the same step with the plain pass, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu_torch import config as cfgmod
from lidar_imu_slam_tpu_torch.host import synthetic
from lidar_imu_slam_tpu_torch.models import kiss_icp
from lidar_imu_slam_tpu_torch.ops import lie, voxel_map
from lidar_imu_slam_tpu_torch.ops.kernels import (_common, icp_gn, nn_bruteforce, pose_chain,
                                                  probes)
from lidar_imu_slam_tpu_torch.ops.preprocess import (pack_raw_scan, preprocess_scan,
                                                     stack_raw_scans)
from lidar_imu_slam_tpu_torch.parallel import streams
from lidar_imu_slam_tpu_torch.tools import deskew_cases, fetch_cases, nn_cases
from lidar_imu_slam_tpu_torch.tools import pose_chain_cases as pose_cases
from lidar_imu_slam_tpu_torch.tools import probes as probe_tool

pytestmark = pytest.mark.cuda

KW = dict(min_motion_th=0.1, initial_threshold=2.0, max_range=30.0)
F64 = torch.float64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


def _pose(rng, scale_t, scale_r):
    xi = np.concatenate([rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
    return lie.se3_exp(torch.from_numpy(xi))


def _same_twice(fn, *args, **kw):
    """A kernel launched twice on the same inputs: every output equal bit
    for bit."""
    out, again = fn(*args, **kw), fn(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    return out


@pytest.mark.parametrize("num_poses", [0, 1, 2, 5])
@pytest.mark.parametrize("deskew_on", [True, False])
def test_pose_pre_kernel_matches_plain(dev, num_poses, deskew_on):
    rng = np.random.default_rng(num_poses)
    prev = _pose(rng, 300.0, 0.5)
    args = (prev @ _pose(rng, 0.5, 0.02), prev, _pose(rng, 300.0, 0.5),
            torch.tensor(1.234, dtype=F64), _pose(rng, 0.05, 0.01),
            torch.tensor(num_poses, dtype=torch.int32), torch.tensor(7, dtype=torch.int32))
    args = tuple(a.to(dev) for a in args)
    before = _common.LAUNCHES["pose_pre"]
    pre = _same_twice(pose_chain.pose_pre, *args, deskew_on=deskew_on, **KW)
    assert _common.LAUNCHES["pose_pre"] == before + 2
    ref = pose_chain.pose_pre_ref(*args, deskew_on=deskew_on, **KW)
    assert pose_cases.max_err(pre, ref) <= 1e-9
    assert pre.model_error_sq.shape == () and pre.num_samples.dtype == torch.int32


@pytest.mark.parametrize("diverge", [False, True])
def test_pose_post_kernel_matches_plain(dev, diverge):
    rng = np.random.default_rng(10 + diverge)
    corr = _pose(rng, 20.0 if diverge else 0.05, 0.001)
    guess = _pose(rng, 500.0, 0.5)
    c = torch.cat([corr[:3, :3].reshape(9), corr[:3, 3]]).to(dev)
    g = torch.cat([guess[:3, :3].reshape(9), guess[:3, 3]]).to(dev)
    state = (_pose(rng, 500.0, 0.5).to(dev), _pose(rng, 500.0, 0.5).to(dev),
             torch.tensor(3, dtype=torch.int32, device=dev))
    post = _same_twice(pose_chain.pose_post, c, g, *state, max_model_deviation=10.0)
    ref = pose_chain.pose_post_ref(c, g, *state, max_model_deviation=10.0)
    assert pose_cases.max_err(post, ref) <= 1e-9
    assert pose_cases.delta_is_own_rounding(post)
    assert float(post.row[12]) == float(diverge)
    assert torch.equal(post.pose_prev, state[0]) and torch.equal(post.first_pose, state[1])
    for t in (post.pose, post.pose_prev, post.first_pose, post.model_deviation):
        assert t.shape == (4, 4) and t.is_contiguous() and t.data_ptr() % 16 == 0


@pytest.mark.parametrize("case", pose_cases.CASES)
def test_pose_chain_branch_cases_match_plain(dev, case):
    """K2 then K3 on each branch case: every output (row and epilogue)
    within 1e-9 of the plain version on the same inputs (K3's plain version
    on the kernel's row), the i32 outputs equal, the f32 map delta the
    kernel's own f64 delta rounded, a repeated launch bit-equal."""
    args, kw, corr = pose_cases.case(case, dev)
    before = dict(_common.LAUNCHES)
    pre = _same_twice(pose_chain.pose_pre, *args, **kw)
    assert pose_cases.max_err(pre, pose_chain.pose_pre_ref(*args, **kw)) <= 1e-9
    post_args = pose_cases.post_args(args, corr, pre.row)
    mmd = pose_cases.MAX_MODEL_DEVIATION
    post = _same_twice(pose_chain.pose_post, *post_args, max_model_deviation=mmd)
    assert pose_cases.max_err(post, pose_chain.pose_post_ref(
        *post_args, max_model_deviation=mmd)) <= 1e-9
    assert pose_cases.delta_is_own_rounding(post)
    assert _common.LAUNCHES["pose_pre"] == before["pose_pre"] + 2
    assert _common.LAUNCHES["pose_post"] == before["pose_post"] + 2


def test_pose_chain_unaligned_inputs_match_plain(dev):
    """Every matrix and row input of K2 and K3 8 bytes off the 16-byte
    alignment (the kernels' 8-byte loads) against the plain version, and
    bit-equal to the launch on the same inputs aligned (16-byte loads)."""
    args, kw, corr = pose_cases.case("np5", "cpu")
    shifted = tuple(_on_card(a.numpy(), dev, 1) if a.dim() == 2 else a.to(dev) for a in args)
    aligned = tuple(a.to(dev) for a in args)
    assert all(a.data_ptr() % 16 == 8 for a in shifted if a.dim() == 2)
    pre = pose_chain.pose_pre(*shifted, **kw)
    assert pose_cases.max_err(pre, pose_chain.pose_pre_ref(*shifted, **kw)) <= 1e-9
    assert all(torch.equal(a, b) for a, b in zip(pre, pose_chain.pose_pre(*aligned, **kw)))
    row = _on_card(pre.row.cpu().numpy(), dev, 1)
    post_args = pose_cases.post_args(shifted, _on_card(corr.numpy(), dev, 1), row)
    mmd = pose_cases.MAX_MODEL_DEVIATION
    post = pose_chain.pose_post(*post_args, max_model_deviation=mmd)
    assert pose_cases.max_err(post, pose_chain.pose_post_ref(
        *post_args, max_model_deviation=mmd)) <= 1e-9
    again = pose_chain.pose_post(*pose_cases.post_args(aligned, corr.to(dev), pre.row),
                                 max_model_deviation=mmd)
    assert all(torch.equal(a, b) for a, b in zip(post, again))


def _twice(fn, *args):
    """Launch a GN kernel twice on the same inputs: the rows must be equal
    bit for bit (the cluster adds its CTA sums in rank order)."""
    row = fn(*args)
    again = fn(*args)
    assert torch.equal(row, again)
    return row


def _k1_inputs(dev, n, offset):
    """A map of max(4096, n) uniform points, its first n points shifted by
    (0.25, -0.15, 0.1) as the source, centred on their mean."""
    n_world = max(4096, n)
    cfg = cfgmod.MapConfig(voxel_size=1.0, max_range=40.0,
                           capacity=1 << (13 if n_world == 4096 else 15), neighborhood=8)
    rng = np.random.default_rng(0)
    world = torch.from_numpy(rng.uniform(-18, 18, (n_world, 3)).astype(np.float32) + offset)
    world = world.to(dev)
    g = voxel_map.fused_downsample(world, torch.ones(n_world, dtype=torch.bool, device=dev),
                                   cfg.voxel_size, n_world)
    m = voxel_map.insert_grouped(voxel_map.create(cfg, dev), g, cfg)
    src = world[:n] - torch.tensor([0.25, -0.15, 0.1], device=dev)
    anchor = src.mean(0)
    q = (src - anchor).T.contiguous()
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    cand = voxel_map.gather_candidate_planes_packed(m, src, mask, cfg, anchor).contiguous()
    scal = torch.tensor([0.5, 2.25, 1e-5, 20.0, 2.0, 0.25, 0.0, 0.0], dtype=F64, device=dev)
    carry = torch.cat([torch.eye(3, dtype=F64, device=dev).reshape(9),
                       torch.zeros(3, dtype=F64, device=dev), anchor.double()])
    return q, mask.float(), cand, scal, carry


# N: the test's 1024, one CTA (128), a ragged last CTA (1000), the main
# path; the dense path's 16,384 and a ragged 9,000, both over G > 1
# clusters (the spread kernel)
@pytest.mark.parametrize("n", [1024, 128, 1000, 4096, 16384, 9000])
@pytest.mark.parametrize("offset", [0.0, 300.0])
@pytest.mark.parametrize("n_inner", [1, 6])
def test_fused_gn_carry_kernel_matches_plain(dev, offset, n_inner, n):
    q, qm, cand, scal, carry = _k1_inputs(dev, n, offset)
    spread = n > 4096
    assert (icp_gn.device_shape(n, cand.shape[1], dev)[0] > 1) == spread
    before = dict(_common.LAUNCHES)
    row = _twice(icp_gn.fused_gn_carry, q, qm, cand, scal, carry, n_inner).cpu().numpy()
    assert _common.LAUNCHES["fused_gn_carry"] == before["fused_gn_carry"] + 2
    assert _common.LAUNCHES["gn_spread"] == before["gn_spread"] + 2 * spread
    ref = icp_gn.fused_gn_carry_ref(q, qm, cand, scal, carry, n_inner).cpu().numpy()
    np.testing.assert_allclose(row[:9], ref[:9], atol=1e-5)
    np.testing.assert_allclose(row[9:12], ref[9:12], atol=1e-4)
    assert row[14] == ref[14] and row[15] == ref[15]
    assert abs(row[12] - ref[12]) <= 1
    if n_inner == 6:  # converged onto the true offset
        np.testing.assert_allclose(row[9:12], [0.25, -0.15, 0.1], atol=0.02)


def _gn_streams(dev, n_streams, n, seed=0):
    """Per-stream maps, shifted sources and kernel scalars (stream s
    shifted and weighted differently, so the streams stop at different
    iteration counts)."""
    cfg = cfgmod.MapConfig(voxel_size=1.0, max_range=40.0,
                           capacity=1 << (13 if n <= 4096 else 16), neighborhood=8)
    rng = np.random.default_rng(seed)
    world = torch.from_numpy(rng.uniform(-18, 18, (n_streams, 4 * n, 3)).astype(np.float32))
    world = world.to(dev)
    ones = torch.ones(n_streams, 4 * n, dtype=torch.bool, device=dev)
    g = voxel_map.fused_downsample(world, ones, cfg.voxel_size, 4 * n)
    m = voxel_map.insert_grouped(voxel_map.create(cfg, dev, streams=n_streams), g, cfg)
    scale = np.linspace(0.02, 0.45, n_streams)[:, None, None]
    shift = torch.from_numpy((rng.uniform(-1, 1, (n_streams, 1, 3)) * scale).astype(np.float32))
    src = world[:, :n] - shift.to(dev)
    anchor = src.mean(1)
    q = (src - anchor[:, None]).transpose(1, 2).contiguous()
    mask = torch.ones(n_streams, n, dtype=torch.bool, device=dev)
    cand = voxel_map.gather_candidate_planes_packed(m, src, mask, cfg, anchor).contiguous()
    kth = torch.from_numpy(rng.uniform(0.2, 0.8, n_streams)).to(dev)
    scal = torch.stack([kth, torch.full_like(kth, 2.25)] + [
        torch.full_like(kth, v) for v in (1e-5, 20.0, 2.0, 0.25, 0.0, 0.0)], dim=-1)
    return q, mask.float(), cand, scal.contiguous()


def _check_rows(rows, ref):
    rows, ref = rows.cpu().numpy().reshape(-1, 16), ref.cpu().numpy().reshape(-1, 16)
    np.testing.assert_allclose(rows[:, :9], ref[:, :9], atol=1e-5)
    np.testing.assert_allclose(rows[:, 9:12], ref[:, 9:12], atol=1e-4)
    np.testing.assert_array_equal(rows[:, 14:16], ref[:, 14:16])
    assert np.abs(rows[:, 12] - ref[:, 12]).max() <= 1


@pytest.mark.parametrize("n", [1024, 128, 1000, 4096, 16384])
@pytest.mark.parametrize("n_inner", [1, 4])
def test_fused_gn_kernel_matches_plain(dev, n_inner, n):
    q, qm, cand, scal = (t[0].contiguous() for t in _gn_streams(dev, 1, n))
    before = dict(_common.LAUNCHES)
    row = _twice(icp_gn.fused_gn, q, qm, cand, scal, n_inner)
    assert _common.LAUNCHES["fused_gn"] == before["fused_gn"] + 2
    assert _common.LAUNCHES["gn_spread"] == before["gn_spread"] + 2 * (n > 4096)
    _check_rows(row, icp_gn.fused_gn_ref(q, qm, cand, scal, n_inner))


@pytest.mark.parametrize("n_streams,n", [(8, 1024), (64, 256), (8, 4096), (16, 1000),
                                         (256, 512)])
def test_fused_gn_batched_kernel_matches_plain(dev, n_streams, n):
    q, qm, cand, scal = _gn_streams(dev, n_streams, n, seed=n_streams)
    before = _common.LAUNCHES["fused_gn_batched"]
    rows = _twice(icp_gn.fused_gn_batched, q, qm, cand, scal, 4)
    assert _common.LAUNCHES["fused_gn_batched"] == before + 2
    ref = icp_gn.fused_gn_batched_ref(q, qm, cand, scal, 4)
    _check_rows(rows, ref)
    assert len(set(ref[:, 14].tolist())) > 1  # streams stopped at different counts


def _second_cta(n, nc, dev, streams):
    """The queries of CTA 1 of a stream's launch (its shape from the
    launch rule)."""
    g, c, per, _ = (icp_gn.device_shape(n, nc, dev) if streams == 1
                    else (1, *icp_gn.launch_shape(n, nc), False))
    if g == 1:
        return per, 2 * per
    warps, ctas = -(-n // 32), g * c
    return warps // ctas * 32, 2 * warps // ctas * 32


@pytest.mark.parametrize("case", ["cta_masked", "all_masked", "stale"])
@pytest.mark.parametrize("kernel,n", [("fused_gn_carry", 4096), ("fused_gn", 4096),
                                      ("fused_gn_batched", 4096), ("fused_gn_carry", 16384),
                                      ("fused_gn", 16384)])
def test_gn_kernel_edge_cases_match_plain(dev, kernel, n, case):
    """At N = 4096 (16 CTAs a stream) and, one stream over G > 1 clusters,
    at 16,384 (every cluster must leave the loop in the same iteration):
    the second CTA's whole slice masked out; every query masked (frozen
    after one iteration at the identity); a stale bound below the first
    step's drift (frozen stale)."""
    if kernel == "fused_gn_carry":
        q, qm, cand, scal, carry = _k1_inputs(dev, n, 0.0)
        args = (q, qm, cand, scal, carry, 6)
        fn, ref_fn = icp_gn.fused_gn_carry, icp_gn.fused_gn_carry_ref
    else:
        q, qm, cand, scal = _gn_streams(dev, 4, n, seed=5)
        if kernel == "fused_gn":
            q, qm, cand, scal = (t[0].contiguous() for t in (q, qm, cand, scal))
            fn, ref_fn = icp_gn.fused_gn, icp_gn.fused_gn_ref
        else:
            fn, ref_fn = icp_gn.fused_gn_batched, icp_gn.fused_gn_batched_ref
        args = (q, qm, cand, scal, 4)
    streams = q.shape[0] if q.dim() == 3 else 1
    shape = icp_gn.device_shape(n, cand.shape[-2], dev)
    assert shape[0] > 1 if n > 4096 else icp_gn.launch_shape(n, cand.shape[-2])[0] >= 8
    lo, hi = _second_cta(n, cand.shape[-2], dev, streams)
    if case == "cta_masked":
        qm[..., lo:hi] = 0.0
    elif case == "all_masked":
        qm.zero_()
    else:
        scal[..., 5] = 1e-6
    row = _twice(fn, *args)
    ref = ref_fn(*args)
    _check_rows(row, ref)
    flat = ref.cpu().numpy().reshape(-1, 16)
    if case == "all_masked":
        assert (flat[:, 14] == 1).all() and (flat[:, 15] == 1).all()  # one frozen iteration
        assert (flat[:, 12] == 0).all()
        eye = np.eye(3).reshape(9)
        np.testing.assert_array_equal(row.cpu().numpy().reshape(-1, 16)[:, :9],
                                      np.broadcast_to(eye, (flat.shape[0], 9)))
        np.testing.assert_array_equal(row.cpu().numpy().reshape(-1, 16)[:, 9:12], 0.0)
    elif case == "stale":
        assert (flat[:, 15] == 2).all()


@pytest.mark.parametrize("resident", [True, False])
def test_gn_spread_raises_beyond_co_residency(dev, resident):
    """A forced shape of more clusters than the card holds at once raises
    before it launches (its barrier would never complete)."""
    q, qm, cand, scal, carry = _k1_inputs(dev, 16384, 0.0)
    nc = cand.shape[1]
    budget = icp_gn.spread_limits(dev, 16)[1]
    g = icp_gn.spread_limits(dev, 16)[0] if resident else 1
    for _ in range(3):  # G such that the shape's own cap is below it
        shape = icp_gn.spread_split(16384, nc, g + 1, 16, budget)[:3] + (resident,)
        g = icp_gn.spread_limits(dev, 16, nc, shape[2], resident)[0]
        if g < shape[0]:
            break
    assert g < shape[0]
    before = dict(_common.LAUNCHES)
    with pytest.raises(RuntimeError, match="cannot all be resident"):
        icp_gn._launch("fused_gn_carry", q, qm, cand, scal, carry, 6, 1, (16,), shape=shape)
    torch.cuda.synchronize()
    assert _common.LAUNCHES == before


def test_batched_drive_card_matches_cpu(dev):
    cfg = streams.batch_config(cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=False, max_insert_voxels=700),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             gn_backend="pallas", deskew=True),
    ))
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=7, speed=2.0, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(6):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5,
                                                 30.0, noise=0.01, seed=i)
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                  device="cpu"))
    states = {d: streams.init_batched_state(cfg, 3, d) for d in (dev, "cpu")}
    _common.reset_launches()
    for i in range(4):
        poses = []
        for d in (dev, "cpu"):
            batch = stack_raw_scans([raws[i + s] for s in range(3)])
            scans = preprocess_scan(type(batch)(*(t.to(d) for t in batch)), cfg.lidar)
            states[d], out = streams.batched_register_frame_step(states[d], scans, cfg)
            poses.append(out.pose.cpu())
        torch.testing.assert_close(poses[0], poses[1], rtol=0, atol=1e-4)
    assert _common.LAUNCHES["fused_gn_batched"] == 4 * cfg.icp.batch_unroll_outer
    assert _common.LAUNCHES["fused_gn_carry"] == _common.LAUNCHES["pose_pre"] == 0


def test_kernel_rejects_wrong_dtype_on_card(dev):
    eye = torch.eye(4, dtype=F64, device=dev)
    with pytest.raises(TypeError):
        pose_chain.pose_post(torch.zeros(12, device=dev), torch.zeros(12, dtype=F64, device=dev),
                             eye, eye, torch.zeros((), dtype=torch.int32, device=dev),
                             max_model_deviation=1.0)


def test_drive_card_matches_cpu(dev):
    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=False),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend="pallas", deskew=True),
    )
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=4, speed=2.0, yaw_rate=0.03, dt=0.1)
    states = {d: kiss_icp.init_state(cfg, d) for d in (dev, "cpu")}
    _common.reset_launches()
    for i in range(4):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, 3)], 0.1,
                                                 1500, 0.5, 30.0, noise=0.01, seed=i)
        poses = []
        for d in (dev, "cpu"):
            raw = pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                device=d)
            states[d], out = kiss_icp.register_frame_step(states[d], preprocess_scan(
                raw, cfg.lidar), cfg)
            poses.append(out.pose.cpu())
        torch.testing.assert_close(poses[0], poses[1], rtol=0, atol=1e-4)
    assert _common.LAUNCHES["pose_pre"] == _common.LAUNCHES["pose_post"] == 4
    assert _common.LAUNCHES["fused_gn_carry"] >= 4


@pytest.mark.parametrize("n,m", [(1000, 50_000), (4096, 300_001)])
def test_nn_bruteforce_kernel_matches_plain(dev, n, m):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    pts[rng.uniform(size=m) < 0.3] = np.inf
    dup = rng.choice(m // 2, 64, replace=False)
    tie = rng.uniform(-30, 30, (64, 3)).astype(np.float32)
    pts[dup] = tie
    pts[dup + m // 2] = tie  # the same point at a later index
    qs = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    qs[:64] = tie
    pool = torch.from_numpy(np.ascontiguousarray(pts.T)).to(dev)
    q = torch.from_numpy(qs).to(dev)
    before = _common.LAUNCHES["nn_bruteforce"]
    d2, idx = nn_bruteforce.nn_bruteforce(q, pool)
    assert _common.LAUNCHES["nn_bruteforce"] == before + 1
    d2_p, idx_p = nn_bruteforce.nn_bruteforce_plain(q, pool)
    assert torch.equal(idx, idx_p)
    assert torch.equal(d2.view(torch.int32), d2_p.view(torch.int32))
    np.testing.assert_array_equal(idx[:64].cpu().numpy(), dup)


@pytest.mark.parametrize("slice_len", [1024, nn_bruteforce.SLICE])
@pytest.mark.parametrize("case", nn_cases.CASES)
def test_nn_bruteforce_adversarial_cases_bit_equal(dev, case, slice_len):
    # N not a multiple of the 512-query tile, M not a multiple of the slice
    qs, pts = nn_cases.make(case, 1000, 50_001, seed=3)
    q, pool = torch.from_numpy(qs).to(dev), torch.from_numpy(pts).to(dev)
    before = _common.LAUNCHES["nn_bruteforce"]
    d2, idx = nn_bruteforce._launch(q, pool, slice_len)
    again = nn_bruteforce._launch(q, pool, slice_len)
    assert _common.LAUNCHES["nn_bruteforce"] == before + 2
    d2_p, idx_p = nn_bruteforce.nn_bruteforce_plain(q, pool)
    assert torch.equal(idx, idx_p) and torch.equal(again[1], idx_p)
    assert torch.equal(d2.view(torch.int32), d2_p.view(torch.int32))
    assert torch.equal(again[0].view(torch.int32), d2_p.view(torch.int32))


def test_classic_drive_card_matches_cpu(dev):
    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20),
    )
    assert cfg.icp.gn_backend == "xla"
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=4, speed=1.2, yaw_rate=0.03, dt=0.1)
    states = {d: kiss_icp.init_state(cfg, d) for d in (dev, "cpu")}
    _common.reset_launches()
    for i in range(4):
        pts = synthetic.render_scan(world, gt[i], 1500, 0.5, 30.0, noise=0.01, seed=i)
        poses = []
        for d in (dev, "cpu"):
            raw = pack_raw_scan(pts, stamp=i * 0.1, max_points=2048, device=d)
            states[d], out = kiss_icp.register_frame_step(states[d], preprocess_scan(
                raw, cfg.lidar), cfg)
            poses.append(out.pose.cpu())
        torch.testing.assert_close(poses[0], poses[1], rtol=0, atol=1e-4)
    assert not any(_common.LAUNCHES.values())
    pool = nn_bruteforce.pool_from_map(states[dev].map, cfg.map)
    cpu_pool = nn_bruteforce.pool_from_map(states["cpu"].map, cfg.map)
    assert pool.shape == cpu_pool.shape


# take_rows: (table rows C, width W, index columns "w" or 1, rows N, dtype,
# table offset, index offset, index range); take_lanes: (R, C, N, index
# offset, index range). An offset of 1 element puts a contiguous tensor off
# the 16-byte alignment the vector variants need. Every launch variant runs:
# 16-byte and scalar (W % 4, alignment), broadcast and (N, W) index, N = 0,
# N off the rows a block takes, rows past one wave (the row-group loop),
# indices out of range (clamped).
ROW_CASES = {
    "f32_w128": (8192, 128, "w", 2048, np.float32, 0, 0, None),
    "f32_w512": (8192, 512, "w", 2048, np.float32, 0, 0, None),
    "i32_broadcast": (8192, 128, 1, 2048, np.int32, 0, 0, None),
    "f32_broadcast_w128": (8192, 128, 1, 2048, np.float32, 0, 0, None),
    "f32_broadcast_w512": (8192, 512, 1, 2048, np.float32, 0, 0, None),
    "i32_w128": (8192, 128, "w", 2048, np.int32, 0, 0, None),
    "f32_w30": (8192, 30, "w", 1000, np.float32, 0, 0, None),
    "f32_w30_broadcast": (8192, 30, 1, 1000, np.float32, 0, 0, None),
    "table_unaligned_broadcast": (8192, 128, 1, 2048, np.float32, 1, 0, None),
    "table_unaligned": (8192, 128, "w", 2048, np.float32, 1, 0, None),
    "idx_unaligned": (8192, 128, "w", 2048, np.float32, 0, 1, None),
    "n0_broadcast": (8192, 128, 1, 0, np.float32, 0, 0, None),
    "n0": (8192, 128, "w", 0, np.float32, 0, 0, None),
    "n_ragged_broadcast": (8192, 128, 1, 2047, np.float32, 0, 0, None),
    "n_ragged": (8192, 128, "w", 13, np.int32, 0, 0, None),
    "rows_past_a_wave_broadcast": (512, 8, 1, 200_000, np.float32, 0, 0, None),
    "rows_past_a_wave": (512, 8, "w", 200_000, np.float32, 0, 0, None),
    "clamp_broadcast": (8192, 128, 1, 2048, np.float32, 0, 0, (-50, 8242)),
    "clamp": (8192, 128, "w", 2048, np.float32, 0, 0, (-50, 8242)),
}
LANE_CASES = {
    "lanes": (8, 8192, 2048, 0, None),
    "lanes_n30": (8, 8192, 30, 0, None),
    "lanes_idx_unaligned": (8, 8192, 2048, 1, None),
    "lanes_n0": (8, 8192, 0, 0, None),
    "lanes_rows_past_grid_y": (70_000, 16, 8, 0, None),
    "lanes_clamp": (8, 8192, 2048, 0, (-50, 8242)),
}


def _on_card(a: np.ndarray, dev, offset: int) -> torch.Tensor:
    """`a` on the card, contiguous, `offset` elements past the start of its
    buffer (the caching allocator's buffers are 512-byte aligned)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and (out.data_ptr() % 16 == 0) == (offset == 0)
    return out


@pytest.mark.parametrize("case", [*ROW_CASES, *LANE_CASES])
def test_probe_gathers_match_plain(dev, case):
    rng = np.random.default_rng(7)
    if case in LANE_CASES:
        r, c, n, ioff, lim = LANE_CASES[case]
        table = _on_card(rng.normal(size=(r, c)).astype(np.float32), dev, 0)
        idx = rng.integers(*(lim or (0, c)), (r, n)).astype(np.int32)
        idx = _on_card(idx, dev, ioff)
        fn, plain, name = probes.take_lanes, probes.take_lanes_plain, "take_lanes"
    else:
        c, w, cols, n, dtype, toff, ioff, lim = ROW_CASES[case]
        if dtype == np.int32:
            table = rng.integers(0, 1 << 30, (c, w)).astype(np.int32)
        else:
            table = rng.normal(size=(c, w)).astype(np.float32)
        idx = rng.integers(*(lim or (0, c)), (n, w if cols == "w" else 1)).astype(np.int32)
        table, idx = _on_card(table, dev, toff), _on_card(idx, dev, ioff)
        fn, plain, name = probes.take_rows, probes.take_rows_plain, "take_rows"
    before = _common.LAUNCHES[name]
    out = fn(table, idx)
    torch.cuda.synchronize()
    assert _common.LAUNCHES[name] == before + 1
    ref = plain(table, idx)
    assert out.dtype == ref.dtype and out.shape == ref.shape and torch.equal(out, ref)


@pytest.mark.parametrize("nq,nc,n_inner", [(4096, 80, 8), (1000, 16, 3), (2048, 80, 8)])
def test_gn_proto_kernel_matches_plain(dev, nq, nc, n_inner):
    x = probe_tool.gn_inputs(dev, nq=nq, nc=nc)
    args = (x["q"], x["qmask"], x["cand"], x["scal"], n_inner)
    clusters = icp_gn.launch_shape(nq, nc)[0]
    assert clusters == {4096: 16, 1000: 1, 2048: 8}[nq]  # K1's rule; C < 16 below 4096 x 80
    before = _common.LAUNCHES["gn_proto"]
    out = _same_twice(lambda: (probes.gn_proto(*args),))[0].cpu().numpy()
    assert _common.LAUNCHES["gn_proto"] == before + 2
    ref = probes.gn_proto_plain(*args).cpu().numpy()
    np.testing.assert_allclose(out[:12], ref[:12], rtol=0, atol=1e-5)
    assert out[12] == ref[12]


@pytest.mark.parametrize("clusters", [1, 4, 8, 16])
def test_gn_proto_any_cluster_size_matches_plain(dev, clusters):
    x = probe_tool.gn_inputs(dev)
    args = (x["q"], x["qmask"], x["cand"], x["scal"], probe_tool.N_INNER)
    out = probes._launch(*args, icp_gn.cluster_shape(probe_tool.NQ, clusters)).cpu().numpy()
    ref = probes.gn_proto_plain(*args).cpu().numpy()
    np.testing.assert_allclose(out[:12], ref[:12], rtol=0, atol=1e-5)
    assert out[12] == ref[12]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_lio_drive_card_matches_cpu(dev, backend):
    from lidar_imu_slam_tpu_torch.models import lio

    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             store_points=backend == "xla"),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                             gn_backend=backend),
        ekf=cfgmod.EkfConfig(lidar_pose_trail=4),
        imu=cfgmod.ImuConfig(max_init_count=20, max_samples_per_scan=16),
    )
    n = 5
    world = synthetic.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=n, speed=3.0, yaw_rate=0.02, dt=0.1)
    packets = synthetic.imu_packets(*synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0), n)
    states = {d: lio.init_state(cfg, d) for d in (dev, "cpu")}
    _common.reset_launches()
    for i in range(n):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, n - 1)], 0.1,
                                                 1500, 0.5, 30.0, noise=0.01, seed=i)
        poses = []
        for d in (dev, "cpu"):
            raw = pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                device=d)
            pkt = lio.pack_imu_packet(*packets[i], 16, device=d)
            states[d], out = lio.step(states[d], preprocess_scan(raw, cfg.lidar), pkt, cfg)
            poses.append(out.pose.cpu())
        torch.testing.assert_close(poses[0], poses[1], rtol=0, atol=1e-4)
    assert bool(out.used_imu)
    assert _common.LAUNCHES["pose_pre"] == (n if backend == "pallas" else 0)


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("case", fetch_cases.CASES)
def test_candidate_fetch_kernel_bit_equal_to_plain(dev, case):
    m, q, qm, cfg, anchor = fetch_cases.case(case, dev)
    before = _common.LAUNCHES["candidate_fetch"]
    out = voxel_map.gather_candidate_planes_packed(m, q, qm, cfg, anchor)
    assert _common.LAUNCHES["candidate_fetch"] == before + 1
    again = voxel_map.gather_candidate_planes_packed(m, q, qm, cfg, anchor)
    assert _common.LAUNCHES["candidate_fetch"] == before + 2
    ref = voxel_map.gather_candidate_planes_packed_plain(m, q, qm, cfg, anchor)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(_bits(out), _bits(ref)) and torch.equal(_bits(again), _bits(out))


# odom_bench/tests/cells.py's small cells: each batched preset cut to 4096
# points, a 16,384-slot map and 512 source points, under the 2 x 4 unroll
DRIVE_SMALL = {"lidar": {"max_points": 4096}, "map": {"capacity": 16384},
               "icp": {"max_map_points": 2048, "max_source_points": 512}}


@pytest.mark.parametrize("preset", ["kitti_64beam", "livox_dense"])
def test_batched_drive_bit_equal_with_plain_fetch(dev, preset, monkeypatch):
    cfg = getattr(cfgmod, preset)()
    for group, fields in DRIVE_SMALL.items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    cfg = streams.batch_config(cfg, 2, 4)
    lc = cfg.lidar
    n_streams, n_steps = 4, 16
    world = synthetic.make_world(seed=1, n_points=40000, extent=(40.0, 16.0, 6.0))
    gt = synthetic.make_trajectory(n_poses=n_steps + n_streams, speed=2.0, yaw_rate=0.03,
                                   dt=0.1)
    raws = []
    for i in range(n_steps + n_streams - 1):
        if preset == "kitti_64beam":  # rolling shutter, per-point time
            pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 3500,
                                                     lc.min_range, lc.max_range, noise=0.01,
                                                     seed=i)
            raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                      max_points=lc.max_points, device=dev))
        else:
            pts = synthetic.render_scan(world, gt[i], 3500, lc.min_range, lc.max_range,
                                        noise=0.01, seed=i)
            raws.append(pack_raw_scan(pts, stamp=i * 0.1, max_points=lc.max_points, device=dev))

    def drive():
        states = streams.init_batched_state(cfg, n_streams, dev)
        poses = []
        for i in range(n_steps):
            scans = preprocess_scan(stack_raw_scans(raws[i:i + n_streams]), lc)
            states, out = streams.batched_register_frame_step(states, scans, cfg)
            poses.append(out.pose)
        return torch.stack(poses), states.map

    before = _common.LAUNCHES["candidate_fetch"]
    poses, m = drive()
    fetches = n_steps * cfg.icp.batch_unroll_outer
    assert _common.LAUNCHES["candidate_fetch"] == before + fetches
    monkeypatch.setattr(voxel_map, "gather_candidate_planes_packed",
                        voxel_map.gather_candidate_planes_packed_plain)
    poses_plain, m_plain = drive()
    assert _common.LAUNCHES["candidate_fetch"] == before + fetches
    assert bool(torch.isfinite(poses).all())
    assert torch.equal(poses, poses_plain)
    assert all(torch.equal(a, b) for a, b in zip(m, m_plain))


@pytest.mark.parametrize("case", deskew_cases.CASES)
def test_imu_deskew_kernel_bit_equal_to_plain(dev, case):
    from lidar_imu_slam_tpu_torch.models import ekf

    args = deskew_cases.case(case, dev)
    before = _common.LAUNCHES["imu_deskew"]
    out = ekf.deskew_points(*args)
    assert _common.LAUNCHES["imu_deskew"] == before + 1
    again = ekf.deskew_points(*args)
    assert _common.LAUNCHES["imu_deskew"] == before + 2
    ref = ekf.deskew_points_plain(*args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32 and out.is_contiguous()
    assert torch.equal(_bits(again), _bits(out))
    assert torch.equal(_bits(out), _bits(ref)), int((_bits(out) != _bits(ref)).sum())


def test_batched_lio_step_launches_the_deskew_kernel_once(dev, monkeypatch):
    from lidar_imu_slam_tpu_torch.models import ekf, lio

    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                             store_points=False, auto_rebuild=False, neighborhood=8),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                             gn_backend="pallas", deskew=True, batch_unroll_outer=2,
                             batch_unroll_inner=4),
        ekf=cfgmod.EkfConfig(lidar_pose_trail=4),
        imu=cfgmod.ImuConfig(max_init_count=20, max_samples_per_scan=16),
    )
    n_streams, n_steps, cap = 4, 4, 16
    world = synthetic.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=n_steps + 1, speed=3.0, yaw_rate=0.02, dt=0.1)
    t, g, a = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)
    cut = np.searchsorted(t, 0.1 * np.arange(n_steps + 1) + 1e-9)

    def inputs(i):
        raws = []
        for s in range(n_streams):
            pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5,
                                                     30.0, noise=0.01, seed=100 * s + i)
            raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                      max_points=2048, device=dev))
        lo, hi = cut[i], cut[i + 1]
        pk = lio.pack_imu_packet(t[lo:hi], g[lo:hi], a[lo:hi], cap, device=dev)
        packets = type(pk)(*(f.expand((n_streams,) + f.shape).contiguous() for f in pk))
        return preprocess_scan(stack_raw_scans(raws), cfg.lidar), packets

    state = streams.init_batched_lio_state(cfg, n_streams, dev)
    seen = 0
    for i in range(n_steps - 1):
        scans, packets = inputs(i)
        state, _ = streams.batched_lio_step(state, scans, packets, cfg, init_samples=seen)
        seen += int(cut[i + 1] - cut[i])
    assert seen >= cfg.imu.max_init_count  # the next step runs the IMU branch alone
    scans, packets = inputs(n_steps - 1)

    def clone(x):
        return torch.utils._pytree.tree_map(torch.clone, x)

    before = _common.LAUNCHES["imu_deskew"]
    st_k, out_k = streams.batched_lio_step(clone(state), scans, packets, cfg, init_samples=seen)
    assert _common.LAUNCHES["imu_deskew"] == before + 1
    assert bool(out_k.used_imu.all())
    monkeypatch.setattr(ekf, "deskew_points", ekf.deskew_points_plain)
    st_p, out_p = streams.batched_lio_step(clone(state), scans, packets, cfg, init_samples=seen)
    torch.cuda.synchronize()
    assert _common.LAUNCHES["imu_deskew"] == before + 1
    assert torch.equal(_bits(out_k.scan_deskewed), _bits(out_p.scan_deskewed))
    assert bool(torch.isfinite(out_k.pose).all()) and torch.equal(out_k.pose, out_p.pose)
    for x, y in zip(torch.utils._pytree.tree_leaves((st_k, out_k)),
                    torch.utils._pytree.tree_leaves((st_p, out_p))):
        if x.is_floating_point():  # bit for bit, a NaN included
            x, y = (v.view(torch.int64 if v.element_size() == 8 else torch.int32) for v in (x, y))
        assert torch.equal(x, y)
