"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this checkout (it drives
`lidar_imu_slam_tpu_torch`, never JAX). Phases, each fatal on failure:

1. the card: name and power limit (nvidia-smi);
2. build: every kernel compiled by nvcc from `lidar_imu_slam_tpu_torch/csrc`;
3. kernels: K1 `fused_gn_carry`, K2 `pose_pre` and K3 `pose_post` held
   against their plain PyTorch versions on the card at main-path shapes
   (K1: N = 4096 queries x NC = 80 candidate slots from seeded synthetic
   geometry), each timed beside its plain version with CUDA events;
4. small drive: 5 scans of a small configuration on the card (kernels) and
   on the CPU (plain versions) — poses must agree;
5. slice: the HDL-64E-scale deployment (131,072-point rolling-shutter
   scans at 8 m/s, 1 m voxels, a 2^17-slot packed map, 8-voxel
   neighbourhood, CV deskew, fused ICP), 120 scans through
   `register_frame_step` with eviction / conditional compaction every 10
   scans. Launch counters are zeroed just before it and read just after:
   every kernel must have run, K2 and K3 once per scan. Poses must be
   finite and the ATE (mid-scan convention) at most 0.12 m;
6. batched kernels: K4 `fused_gn` (one stream, 4096 x 80) and K5
   `fused_gn_batched` at both batched deployments' shapes (8 streams x
   4096 queries x 80 slots; 256 x 512 x 16), held against their plain
   versions per stream and timed beside them;
7. small batched drive: 3 streams x 5 small scans under `batch_config` on
   the card and on the CPU, and 5 scans of one stream through
   `register_frame` under `batch_config` (kernel K4, counted) — poses must
   agree;
8. multi-stream: the deployment of bench.py:_bench_batched_chained — the
   HDL-64E config under `batch_config` (2 x 4 unroll), 8 streams x 60
   scans of the slice's drive, stream s at step i on scan min(i + s, 59).
   Every pose finite, stream 0's ATE at most 0.12 m, K5 launched exactly
   2 x 60 times and K1-K3 never;
9. Monte-Carlo: the deployment of bench.py:_bench_monte_carlo — 256
   perturbed VLP-16 streams (sigma 0.01 m), 2 warm + 20 timed steps;
   every stream must end within 0.5 m of the ground truth
   (tracking_frac 1.0).
One step of each batched drive runs under
`torch.cuda.set_sync_debug_mode("error")`: the batched step never waits
for the device.

Prints one JSON line with the kernels' numbers, then, as the very last
line, {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA card or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# the JAX package this port replaces (the port's name without "_torch")
REFERENCE_PKG = "lidar_imu_slam_tpu_torch".removesuffix("_torch")
N_SCANS = 120
POINTS_PER_SCAN = 131072
BLOCK = 10
ATE_LIMIT_M = 0.12
STREAMS = 8  # bench.py:_bench_batched_chained
STREAM_SCANS = 60
MC_STREAMS = 256  # bench.py:_bench_monte_carlo
MC_STEPS = 20


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_cfg(cfgmod, points_per_scan: int):
    """The HDL-64E-scale fast-path deployment (bench.py:_make_cfg with
    gn_backend="pallas")."""
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=64, max_points=points_per_scan, min_range=2.5,
            max_range=80.0, sort_by_time=False, time_source="per_point",
        ),
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=80.0, capacity=1 << 17, neighborhood=8,
            store_points=False, max_insert_voxels=20480,
        ),
        icp=cfgmod.IcpConfig(
            max_map_points=32768, max_source_points=4096,
            estimation_threshold=5e-4, gn_backend="pallas", deskew=True,
        ),
    )


def _se3(rng, scale_t, scale_r):
    import torch

    from lidar_imu_slam_tpu_torch.ops import lie

    xi = np.concatenate([rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
    return lie.se3_exp(torch.from_numpy(xi))


def kernel_phase(dev, cfg):
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn, pose_chain

    results = []
    rng = np.random.default_rng(0)

    # K1: a map of synthetic structure, a shifted 4096-point source
    mcfg = cfg.map
    n_world = 131072
    pts = np.stack([rng.uniform(-60, 60, n_world), rng.uniform(-60, 60, n_world),
                    rng.uniform(-2, 10, n_world)], axis=1).astype(np.float32)
    world = torch.from_numpy(pts).to(dev)
    g = voxel_map.fused_downsample(world, torch.ones(n_world, dtype=torch.bool, device=dev),
                                   mcfg.voxel_size, cfg.icp.max_map_points)
    m = voxel_map.insert_grouped(voxel_map.create(mcfg, dev), g, mcfg)
    n = cfg.icp.max_source_points
    src = g.points[:n] - torch.tensor([0.25, -0.15, 0.1], device=dev)
    mask = g.mask[:n]
    nq = torch.clamp(mask.sum(), min=1).float()
    anchor = torch.where(mask[:, None], src, torch.zeros_like(src)).sum(0) / nq
    q = (src - anchor).T.contiguous()
    cand = voxel_map.gather_candidate_planes_packed(m, src, mask, mcfg, anchor).contiguous()
    _require(tuple(cand.shape) == (3, 80, n), f"K1 candidates {tuple(cand.shape)}")
    qmask = mask.float().contiguous()
    scal = torch.tensor([0.5, 1.5**2, cfg.icp.estimation_threshold, 20.0, 2.0,
                         (0.5 * mcfg.voxel_size) ** 2, 0.0, 0.0],
                        dtype=torch.float64, device=dev)
    carry = torch.cat([torch.eye(3, dtype=torch.float64, device=dev).reshape(9),
                       torch.zeros(3, dtype=torch.float64, device=dev),
                       anchor.double()])
    inner = cfg.icp.fused_inner
    k1 = icp_gn.fused_gn_carry(q, qmask, cand, scal, carry, inner)
    k1_ref = icp_gn.fused_gn_carry_ref(q, qmask, cand, scal, carry, inner)
    torch.cuda.synchronize()
    a, b = k1.cpu().numpy(), k1_ref.cpu().numpy()
    err_R = float(np.abs(a[:9] - b[:9]).max())
    err_t = float(np.abs(a[9:12] - b[9:12]).max())
    print(f"K1 fused_gn_carry: row {np.round(a, 6).tolist()}")
    print(f"K1 max|dR| {err_R:.3e} (tol 1e-5)  max|dt| {err_t:.3e} m (tol 1e-4)  "
          f"iters {a[14]:.0f}/{b[14]:.0f}  flags {a[15]:.0f}/{b[15]:.0f}  "
          f"n_corr {a[12]:.0f}/{b[12]:.0f} (tol 1)")
    _require(err_R <= 1e-5 and err_t <= 1e-4, "K1 pose disagrees with its plain version")
    _require(a[14] == b[14] and a[15] == b[15], "K1 iterations/flags disagree")
    _require(abs(a[12] - b[12]) <= 1, "K1 n_corr disagrees")
    ms = _cuda_ms(lambda: icp_gn.fused_gn_carry(q, qmask, cand, scal, carry, inner), 50)
    plain_ms = _cuda_ms(lambda: icp_gn.fused_gn_carry_ref(q, qmask, cand, scal, carry, inner), 5)
    print(f"K1 {ms:.4f} ms/launch  plain {plain_ms:.4f} ms/call")
    results.append(dict(name="fused_gn_carry", route="cuda",
                        source="lidar_imu_slam_tpu_torch/csrc/icp_gn.cu",
                        replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:383",
                        max_abs_err=max(err_R, err_t), ms=ms, plain_ms=plain_ms))

    # K2: seeded f64 pose state (5 poses: every branch live)
    f64 = dict(dtype=torch.float64, device=dev)
    prev = _se3(rng, 30.0, 0.5)
    pose = prev @ _se3(rng, 0.8, 0.02)
    first = _se3(rng, 30.0, 0.5)
    md = _se3(rng, 0.05, 0.005)
    pre_args = (pose.to(dev), prev.to(dev), first.to(dev),
                torch.tensor(1.234, **f64), md.to(dev),
                torch.tensor(5, dtype=torch.int32, device=dev),
                torch.tensor(7, dtype=torch.int32, device=dev))
    kw = dict(min_motion_th=cfg.icp.min_motion_th,
              initial_threshold=cfg.icp.initial_threshold,
              max_range=cfg.map.max_range, deskew_on=True)
    row = pose_chain.pose_pre(*pre_args, **kw)
    row_ref = pose_chain.pose_pre_ref(*pre_args, **kw)
    err = float((row - row_ref).abs().max())
    print(f"K2 pose_pre max|d| {err:.3e} (tol 1e-9)")
    _require(err <= 1e-9, "K2 disagrees with its plain version")
    ms = _cuda_ms(lambda: pose_chain.pose_pre(*pre_args, **kw), 200)
    plain_ms = _cuda_ms(lambda: pose_chain.pose_pre_ref(*pre_args, **kw), 20)
    print(f"K2 {ms:.4f} ms/launch  plain {plain_ms:.4f} ms/call")
    results.append(dict(name="pose_pre", route="cuda",
                        source="lidar_imu_slam_tpu_torch/csrc/pose_chain.cu",
                        replaces=f"{REFERENCE_PKG}/ops/pallas/pose_chain.py:244",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))

    # K3: the K1 result as the correction, the K2 row as the guess
    mmd = cfg.icp.max_model_deviation
    post = pose_chain.pose_post(k1, row, max_model_deviation=mmd)
    post_ref = pose_chain.pose_post_ref(k1, row, max_model_deviation=mmd)
    err = float((post - post_ref).abs().max())
    print(f"K3 pose_post max|d| {err:.3e} (tol 1e-9)")
    _require(err <= 1e-9, "K3 disagrees with its plain version")
    ms = _cuda_ms(lambda: pose_chain.pose_post(k1, row, max_model_deviation=mmd), 200)
    plain_ms = _cuda_ms(lambda: pose_chain.pose_post_ref(k1, row, max_model_deviation=mmd), 20)
    print(f"K3 {ms:.4f} ms/launch  plain {plain_ms:.4f} ms/call")
    results.append(dict(name="pose_post", route="cuda",
                        source="lidar_imu_slam_tpu_torch/csrc/pose_chain.cu",
                        replaces=f"{REFERENCE_PKG}/ops/pallas/pose_chain.py:346",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms))
    return results


def small_drive_phase(dev):
    """5 small scans through register_frame on the card and on the CPU."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=False),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend="pallas", deskew=True),
    )
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=5, speed=2.0, yaw_rate=0.03, dt=0.1)
    states = {d: kiss_icp.init_state(cfg, d) for d in (dev, "cpu")}
    worst = 0.0
    for i in range(5):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, 4)], 0.1,
                                                 1500, 0.5, 30.0, noise=0.01, seed=i)
        poses = {}
        for d in (dev, "cpu"):
            raw = pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                max_points=2048, device=d)
            states[d], out = kiss_icp.register_frame(states[d], preprocess_scan(raw, cfg.lidar), cfg)
            poses[d] = out.pose.cpu().numpy()
        worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
    print(f"small drive: card (kernels) vs CPU (plain) max|d pose| {worst:.3e} (tol 1e-4)")
    _require(worst <= 1e-4, "small drive: card and CPU poses disagree")


def _ate(poses, gt, shift=0.5):
    """bench.py:_ate: translation RMS ATE against ground truth interpolated
    at `shift` scan periods, displacements from the first pose."""
    n = poses.shape[0]
    pos = gt[:, :3, 3]
    t = np.minimum(np.arange(n, dtype=np.float64) + shift, len(gt) - 1.0)
    k = np.minimum(t.astype(int), len(gt) - 2)
    a = (t - k)[:, None]
    target = (1.0 - a) * pos[k] + a * pos[k + 1]
    target_rel = (target - target[0]) @ gt[0, :3, :3]
    d = (poses[:, :3, 3] - poses[0, :3, 3]) - target_rel
    return float(np.sqrt(np.mean(np.sum(d**2, axis=-1))))


def render_hdl_drive(dev):
    """The HDL-64E rolling-shutter drive (bench.py:_make_raws), uploaded."""
    import torch

    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan

    t0 = time.perf_counter()
    world = synthetic.make_world(seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=8.0, yaw_rate=0.01, dt=0.1)
    raws = []
    for i in range(N_SCANS):
        pts, rel = synthetic.render_scan_rolling(
            world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1, POINTS_PER_SCAN,
            2.5, 80.0, noise=0.02, seed=i)
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                  max_points=POINTS_PER_SCAN, device=dev))
    torch.cuda.synchronize()
    print(f"slice: rendered and uploaded {N_SCANS} scans in {time.perf_counter() - t0:.1f} s")
    return raws, gt


def slice_phase(dev, cfg, raws, gt):
    """The 120-scan HDL-64E-scale drive on the card."""
    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    # eviction and compaction at block boundaries (bench.py:_bench_chained)
    body = cfg.replace(map=dataclasses.replace(cfg.map, auto_evict=False, auto_rebuild=False))
    cap = cfg.map.capacity

    def run(n_scans):
        state = kiss_icp.init_state(cfg, dev)
        poses, iters, ms = [], [], []
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        for i in range(n_scans):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            scan = preprocess_scan(raws[i], body.lidar)
            state, out = kiss_icp.register_frame_step(state, scan, body)
            if (i + 1) % BLOCK == 0:
                m = voxel_map.evict_far(state.map, state.pose[:3, 3], cfg.map, inplace=True)
                if bool((m.next_slot > cap - cap // 4) & (m.tombstones > cap // 16)):
                    m = voxel_map.rebuild(m, cfg.map)
                state = state._replace(map=m)
            ev1.record()
            poses.append(out.pose)
            iters.append(out.icp_iterations)
            ms.append((ev0, ev1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        step_ms = np.array([a.elapsed_time(b) for a, b in ms])
        return state, torch.stack(poses).cpu().numpy(), torch.stack(iters).cpu().numpy(), wall, step_ms

    run(3)  # warm-up on a throwaway state (lazy module / kernel loading)
    _common.reset_launches()
    state, poses, iters, wall, step_ms = run(N_SCANS)
    launches = dict(_common.LAUNCHES)
    _require(np.isfinite(poses).all(), "slice: non-finite pose")
    ate = _ate(poses, gt, shift=0.5)
    voxels = int(voxel_map.num_voxels(state.map))
    drops = int(state.map.drops)
    print(f"slice: {N_SCANS / wall:.2f} scans/s  p50 {np.percentile(step_ms, 50):.3f} ms  "
          f"p95 {np.percentile(step_ms, 95):.3f} ms per scan (CUDA events)")
    print(f"slice: ICP iterations mean {iters.mean():.2f} max {iters.max()}  "
          f"map voxels {voxels}  drops {drops}  launches {launches}")
    print(f"slice: ATE {ate:.4f} m (mid-scan, limit {ATE_LIMIT_M})")
    for name in ("fused_gn_carry", "pose_pre", "pose_post"):
        _require(launches[name] > 0, f"slice: kernel {name} never launched")
    _require(launches["pose_pre"] == N_SCANS and launches["pose_post"] == N_SCANS,
             "slice: pose kernels did not run once per scan")
    _require(ate <= ATE_LIMIT_M, f"slice: ATE {ate:.4f} m above {ATE_LIMIT_M}")
    return launches


def mc_cfg(cfgmod):
    """The Monte-Carlo VLP-16 deployment (bench.py:_bench_monte_carlo)."""
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(num_scan_lines=16, max_points=16384, min_range=1.0,
                                 max_range=40.0, sort_by_time=False),
        map=cfgmod.MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 13,
                             neighborhood=8, nn_points=2, grid_z=32, store_points=False),
        icp=cfgmod.IcpConfig(max_map_points=2048, max_source_points=512,
                             gn_backend="pallas"),
    )


def _gn_streams(dev, mcfg, icp, n_streams, n_world, extent, rng):
    """K4 / K5 inputs at a deployment's shape: per-stream seeded maps, each
    stream's source shifted by its own offset (0.02 to 0.45 m), so the
    streams converge after different iteration counts."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map

    lo, hi = np.array([-extent, -extent, -2.0]), np.array([extent, extent, 10.0])
    pts = rng.uniform(lo, hi, (n_streams, n_world, 3)).astype(np.float32)
    world = torch.from_numpy(pts).to(dev)
    ones = torch.ones(n_streams, n_world, dtype=torch.bool, device=dev)
    g = voxel_map.fused_downsample(world, ones, mcfg.voxel_size, icp.max_map_points)
    m = voxel_map.insert_grouped(voxel_map.create(mcfg, dev, streams=n_streams), g, mcfg)
    n = icp.max_source_points
    scale = np.linspace(0.02, 0.45, n_streams)[:, None, None]
    shift = (rng.uniform(-1, 1, (n_streams, 1, 3)) * scale).astype(np.float32)
    src = g.points[:, :n] - torch.from_numpy(shift).to(dev)
    mask = g.mask[:, :n]
    nq = torch.clamp(mask.sum(-1, keepdim=True), min=1).float()
    anchor = torch.where(mask[..., None], src, torch.zeros_like(src)).sum(1) / nq
    q = (src - anchor[:, None]).transpose(1, 2).contiguous()
    cand = voxel_map.gather_candidate_planes_packed(m, src, mask, mcfg, anchor).contiguous()
    kth = torch.from_numpy(rng.uniform(0.2, 0.8, n_streams)).to(dev)
    scal = torch.stack([kth, torch.full_like(kth, 1.5**2)] + [
        torch.full_like(kth, v) for v in (icp.estimation_threshold, 20.0, 2.0,
                                          (0.5 * mcfg.voxel_size) ** 2, 0.0, 0.0)], dim=-1)
    return q, mask.float().contiguous(), cand, scal.contiguous()


def _rows_err(rows, ref, what):
    """Per-stream bars of a K4 / K5 result against its plain version."""
    a = rows.cpu().numpy().reshape(-1, 16)
    b = ref.cpu().numpy().reshape(-1, 16)
    err_R = float(np.abs(a[:, :9] - b[:, :9]).max())
    err_t = float(np.abs(a[:, 9:12] - b[:, 9:12]).max())
    iters = sorted(set(b[:, 14].astype(int).tolist()))
    print(f"{what}: max|dR| {err_R:.3e} (tol 1e-5)  max|dt| {err_t:.3e} m (tol 1e-4)  "
          f"iteration counts {iters}  max|d n_corr| {np.abs(a[:, 12] - b[:, 12]).max():.0f}")
    _require(err_R <= 1e-5 and err_t <= 1e-4, f"{what}: pose disagrees with its plain version")
    _require((a[:, 14:16] == b[:, 14:16]).all(), f"{what}: iterations/flags disagree")
    _require(np.abs(a[:, 12] - b[:, 12]).max() <= 1, f"{what}: n_corr disagrees")
    return max(err_R, err_t), iters


def batched_kernel_phase(dev, cfg, cfgmod):
    """K4 and K5 against their plain versions at the batched paths' shapes."""
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn

    rng = np.random.default_rng(1)
    inner = 4  # batch_config's inner unroll
    hdl = _gn_streams(dev, cfg.map, cfg.icp, STREAMS, POINTS_PER_SCAN, 60.0, rng)
    _require(tuple(hdl[2].shape) == (STREAMS, 3, 80, 4096), f"K5 candidates {hdl[2].shape}")
    mcc = mc_cfg(cfgmod)
    mc = _gn_streams(dev, mcc.map, mcc.icp, MC_STREAMS, 16384, 30.0, rng)
    _require(tuple(mc[2].shape) == (MC_STREAMS, 3, 16, 512), f"K5 MC candidates {mc[2].shape}")

    one = tuple(t[0].contiguous() for t in hdl)
    err4, _ = _rows_err(icp_gn.fused_gn(*one, inner), icp_gn.fused_gn_ref(*one, inner),
                        "K4 fused_gn (1 x 4096 x 80)")
    ms4 = _cuda_ms(lambda: icp_gn.fused_gn(*one, inner), 50)
    plain4 = _cuda_ms(lambda: icp_gn.fused_gn_ref(*one, inner), 5)
    print(f"K4 {ms4:.4f} ms/launch  plain {plain4:.4f} ms/call")

    errs, times = [], {}
    for name, args in (("8 x 4096 x 80", hdl), ("256 x 512 x 16", mc)):
        err, iters = _rows_err(icp_gn.fused_gn_batched(*args, inner),
                               icp_gn.fused_gn_batched_ref(*args, inner),
                               f"K5 fused_gn_batched ({name})")
        _require(len(iters) > 1, f"K5 ({name}): every stream stopped at one count")
        errs.append(err)
        times[name] = (_cuda_ms(lambda: icp_gn.fused_gn_batched(*args, inner), 50),
                       _cuda_ms(lambda: icp_gn.fused_gn_batched_ref(*args, inner), 5))
        print(f"K5 ({name}) {times[name][0]:.4f} ms/launch  plain {times[name][1]:.4f} ms/call")
    src = "lidar_imu_slam_tpu_torch/csrc/icp_gn.cu"
    return [
        dict(name="fused_gn", route="cuda", source=src,
             replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:281",
             max_abs_err=err4, ms=ms4, plain_ms=plain4),
        dict(name="fused_gn_batched", route="cuda", source=src,
             replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:415",
             max_abs_err=max(errs), ms=times["8 x 4096 x 80"][0],
             plain_ms=times["8 x 4096 x 80"][1],
             ms_256x512x16=times["256 x 512 x 16"][0],
             plain_ms_256x512x16=times["256 x 512 x 16"][1]),
    ]


def _no_sync(fn):
    """Run fn with every host-device synchronization raising."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def small_batched_phase(dev):
    """3 streams x 5 small scans under batch_config on the card and the
    CPU; then one stream through register_frame under batch_config (K4)."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import (RawScan, pack_raw_scan,
                                                         preprocess_scan, stack_raw_scans)
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = streams.batch_config(cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=False, max_insert_voxels=700),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend="pallas", deskew=True),
    ))
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=8, speed=2.0, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(7):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5,
                                                 30.0, noise=0.01, seed=i)
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048))

    def on(d, raw):
        return RawScan(*(t.to(d) for t in raw))

    states = {d: streams.init_batched_state(cfg, 3, d) for d in (dev, "cpu")}
    worst = 0.0
    for i in range(5):
        poses = {}
        for d in (dev, "cpu"):
            scans = preprocess_scan(on(d, stack_raw_scans(raws[i:i + 3])), cfg.lidar)
            states[d], out = streams.batched_register_frame_step(states[d], scans, cfg)
            poses[d] = out.pose.cpu().numpy()
        worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
    print(f"small batched drive (3 streams): card vs CPU max|d pose| {worst:.3e} (tol 1e-4)")
    _require(worst <= 1e-4, "small batched drive: card and CPU poses disagree")

    single = {d: kiss_icp.init_state(cfg, d) for d in (dev, "cpu")}
    worst = 0.0
    _common.reset_launches()
    for i in range(5):
        poses = {}
        for d in (dev, "cpu"):
            scan = preprocess_scan(on(d, raws[i]), cfg.lidar)
            single[d], out = kiss_icp.register_frame_step(single[d], scan, cfg)
            poses[d] = out.pose.cpu().numpy()
        worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
    launches = dict(_common.LAUNCHES)
    print(f"single stream under batch_config: card vs CPU max|d pose| {worst:.3e} (tol 1e-4)  "
          f"launches {launches}")
    _require(worst <= 1e-4, "single-stream batch_config drive: card and CPU poses disagree")
    expect_k4 = 5 * cfg.icp.batch_unroll_outer
    _require(launches["fused_gn"] == expect_k4, f"K4 launched {launches['fused_gn']} "
             f"times, not {expect_k4}")
    return launches


def multi_stream_phase(dev, cfg, raws, gt):
    """bench.py:_bench_batched_chained on the card: 8 HDL-64E streams x 60
    scans, staggered by one scan per stream."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan, stack_raw_scans
    from lidar_imu_slam_tpu_torch.parallel import streams

    bcfg = streams.batch_config(cfg)
    last = STREAM_SCANS - 1

    def step(states, i):
        batch = stack_raw_scans([raws[min(i + s, last)] for s in range(STREAMS)])
        return streams.batched_register_frame_step(
            states, preprocess_scan(batch, bcfg.lidar), bcfg)

    warm = streams.init_batched_state(bcfg, STREAMS, dev)
    warm, _ = step(warm, 0)
    _no_sync(lambda: step(warm, 1))
    print("multi-stream: one batched step ran under sync debug mode 'error'")
    del warm

    states = streams.init_batched_state(bcfg, STREAMS, dev)
    _common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses = []
    for i in range(STREAM_SCANS):
        states, out = step(states, i)
        poses.append(out.pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_common.LAUNCHES)
    poses = torch.stack(poses).cpu().numpy()  # (steps, S, 4, 4)
    _require(np.isfinite(poses).all(), "multi-stream: non-finite pose")
    ates = [_ate(poses[:STREAM_SCANS - s, s], gt[s:]) for s in range(STREAMS)]
    print(f"multi-stream: {STREAMS} streams x {STREAM_SCANS} scans, "
          f"{STREAMS * STREAM_SCANS / wall:.2f} scans/s aggregate "
          f"({wall / STREAM_SCANS * 1000.0:.2f} ms per batched step)")
    print("multi-stream: ATE per stream (m, mid-scan) " + " ".join(f"{a:.4f}" for a in ates))
    print(f"multi-stream: launches {launches}  map voxels "
          f"{voxel_map.num_voxels(states.map).cpu().tolist()}  "
          f"drops {states.map.drops.cpu().tolist()}")
    _require(ates[0] <= ATE_LIMIT_M, f"multi-stream: stream 0 ATE {ates[0]:.4f} m above "
             f"{ATE_LIMIT_M}")
    expect = STREAM_SCANS * bcfg.icp.batch_unroll_outer
    _require(launches["fused_gn_batched"] == expect,
             f"multi-stream: K5 launched {launches['fused_gn_batched']} times, not {expect}")
    for k in ("fused_gn_carry", "pose_pre", "pose_post", "fused_gn"):
        _require(launches[k] == 0, f"multi-stream: {k} launched on the batched path")
    return launches


def monte_carlo_phase(dev, cfgmod):
    """bench.py:_bench_monte_carlo on the card: 256 perturbed VLP-16
    streams, 2 warm + 20 timed steps, tracking within 0.5 m."""
    import torch

    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = mc_cfg(cfgmod)
    bcfg = streams.batch_config(cfg)
    world = synthetic.make_world(seed=1, n_points=200_000, extent=(60.0, 20.0, 8.0))
    gt = synthetic.make_trajectory(n_poses=MC_STEPS + 2, speed=2.0, yaw_rate=0.01, dt=0.1)
    raws = [pack_raw_scan(synthetic.render_scan(world, pose, 16384, 1.0, 40.0, noise=0.02,
                                                seed=i),
                          stamp=i * 0.1, max_points=16384, device=dev)
            for i, pose in enumerate(gt)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(states, i):
        ens = streams.perturb_scans(preprocess_scan(raws[i], cfg.lidar), gen, MC_STREAMS, 0.01)
        return streams.batched_register_frame_step(states, ens, bcfg)

    states = streams.init_batched_state(bcfg, MC_STREAMS, dev)
    _common.reset_launches()
    states, _ = step(states, 0)
    states, out = _no_sync(lambda: step(states, 1))
    print("monte-carlo: one batched step ran under sync debug mode 'error'")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(2, MC_STEPS + 2):
        states, out = step(states, i)
    final = out.pose.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(_common.LAUNCHES)
    gt_rel = np.linalg.inv(gt[0]) @ gt[MC_STEPS + 1]
    err = np.linalg.norm(final[:, :3, 3] - gt_rel[:3, 3], axis=-1)
    tracking = float(np.mean(err < 0.5))
    print(f"monte-carlo: {MC_STREAMS} streams x {MC_STEPS} steps, "
          f"{MC_STREAMS * MC_STEPS / wall:.2f} scans/s aggregate  tracking_frac {tracking} "
          f"(max err {err.max():.4f} m, mean {err.mean():.4f} m)  launches {launches}")
    _require(np.isfinite(final).all(), "monte-carlo: non-finite pose")
    _require(tracking == 1.0, f"monte-carlo: tracking_frac {tracking} below 1.0")
    _require(launches["fused_gn_batched"] == (MC_STEPS + 2) * bcfg.icp.batch_unroll_outer,
             "monte-carlo: K5 not launched once per ICP round")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda, sys.version.split()[0])
    card = _card_line()
    print(card)

    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib}")
    log = lib.replace("libkernels_", "nvcc_").replace(".so", ".log")
    with open(log) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    cfg = bench_cfg(cfgmod, POINTS_PER_SCAN)
    kernels = kernel_phase(dev, cfg) + batched_kernel_phase(dev, cfg, cfgmod)
    small_drive_phase(dev)
    raws, gt = render_hdl_drive(dev)
    launches = slice_phase(dev, cfg, raws, gt)
    # each kernel's launches come from the drive of its own path
    launches["fused_gn"] = small_batched_phase(dev)["fused_gn"]
    launches["fused_gn_batched"] = multi_stream_phase(dev, cfg, raws, gt)["fused_gn_batched"]
    del raws
    monte_carlo_phase(dev, cfgmod)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        _require(k["launches"] > 0, f"kernel {k['name']} never launched on its path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
