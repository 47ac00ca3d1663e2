"""KISS-ICP-style LiDAR odometry (counterpart of the JAX package's
`models/kiss_icp.py`; reference src/odom_run.cpp:154-185 ->
src/sensors/lidar/icp.cpp:49-86).

    state', out = register_frame(state, scan, cfg)

Two paths, chosen by the config as in the JAX package:

* the fast path (gn_backend="pallas", batch_unroll_outer == 0): kernel K2
  (`pose_pre`: CV guess, adaptive sigma, deskew twist) -> CV deskew ->
  world transform at the guess -> fused grouped downsample -> source
  downsample + IQR mask -> fused ICP (kernel K1 per round) -> kernel K3
  (`pose_post`: compose, divergence gate, orthonormalize, map delta, and
  the next state's pose bookkeeping) -> map insert / evict. Host syncs per
  scan: one per ICP round, plus one for the conditional compaction when
  `cfg.map.auto_rebuild` is on.
* the classic branch (every other config): the pose chain in plain f64
  tensor code (`register_core`) and the ICP the config selects —
  - gn_backend="xla" (the default config): the f64 loops over candidates
    from the f32 point slab, no kernel. The while loop reads one flag pair
    from the device per GN iteration; under `batch_unroll_outer > 0` the
    fixed unroll reads nothing;
  - gn_backend="pallas" with `batch_unroll_outer > 0` (as
    `parallel.streams.batch_config` sets it): the fixed unroll with one K4
    launch per ICP round (K5 when the state carries a leading stream axis).
  Plus one host read per scan for the conditional compaction when
  `cfg.map.auto_rebuild` is on, which batch_config turns off.

Poses and threshold accumulators are f64; points f32. The classic path
takes a state and scan whose every leaf has a leading stream axis S (the
batched path of `parallel/streams.py`) or none.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import PipelineConfig
from ..ops import deskew as deskew_ops
from ..ops import icp as icp_ops
from ..ops import lie, stats, voxel_map
from ..ops.kernels import pose_chain
from ..ops.preprocess import Scan
from ..utils.profiling import annotate

F64 = torch.float64


class KissState(NamedTuple):
    map: voxel_map.VoxelMap
    pose: torch.Tensor  # (4, 4) f64 — T_{n-1} (latest)
    pose_prev: torch.Tensor  # (4, 4) f64 — T_{n-2}
    first_pose: torch.Tensor  # (4, 4) f64 — poses.front() for has_moved
    num_poses: torch.Tensor  # () i32
    threshold: icp_ops.ThresholdState


class FrameOutput(NamedTuple):
    pose: torch.Tensor  # (4, 4) f64 world pose of this scan
    keypoints: torch.Tensor  # (S, 3) f32 ICP source (world frame @ guess)
    keypoints_mask: torch.Tensor  # (S,)
    deskewed: torch.Tensor  # (M, 3) f32 corrected map-insert downsample
    deskewed_mask: torch.Tensor  # (M,)
    icp_iterations: torch.Tensor  # () i32
    num_correspondences: torch.Tensor  # () i32
    residual_rms: torch.Tensor  # () f64
    sigma: torch.Tensor  # () f64 adaptive threshold used
    map_voxels: torch.Tensor  # () i32
    icp_converged: torch.Tensor  # () bool
    window_drops: torch.Tensor  # () i32


class CoreOutput(NamedTuple):
    """Everything downstream bookkeeping needs from one classic registration."""

    new_map: voxel_map.VoxelMap
    threshold: icp_ops.ThresholdState
    pose: torch.Tensor  # (..., 4, 4) f64 world pose (divergence-gated)
    keypoints: torch.Tensor
    keypoints_mask: torch.Tensor
    map_points: torch.Tensor  # (..., M, 3) f32 corrected map-insert downsample
    map_points_mask: torch.Tensor
    icp_iterations: torch.Tensor
    num_correspondences: torch.Tensor
    residual_rms: torch.Tensor
    sigma: torch.Tensor
    icp_converged: torch.Tensor
    window_drops: torch.Tensor


class FastCoreOutput(NamedTuple):
    new_map: voxel_map.VoxelMap
    post: pose_chain.PosePost  # kernel K3's outputs: the new pose and its bookkeeping
    source: torch.Tensor
    source_mask: torch.Tensor
    map_points: torch.Tensor
    map_points_mask: torch.Tensor
    sigma: torch.Tensor  # () f64
    iterations: int
    num_correspondences: torch.Tensor
    residual_rms: torch.Tensor  # () f64
    converged: torch.Tensor
    window_drops: torch.Tensor


def init_state(cfg: PipelineConfig, device: torch.device | str = "cuda",
               streams: int | None = None) -> KissState:
    """A fresh state; with `streams`, S fresh states on a leading axis."""
    lead = () if streams is None else (streams,)

    def eye():
        return _eye4(device, lead).clone()

    return KissState(
        map=voxel_map.create(cfg.map, device, streams),
        pose=eye(),
        pose_prev=eye(),
        first_pose=eye(),
        num_poses=torch.zeros(lead, dtype=torch.int32, device=device),
        threshold=icp_ops.threshold_init(device, lead),
    )


def _eye4(device, lead: tuple = ()) -> torch.Tensor:
    return torch.eye(4, dtype=F64, device=device).expand(lead + (4, 4))


def _where(cond, a, b):
    """Per-stream select of (..., 4, 4) poses by a (...) condition."""
    return torch.where(cond[..., None, None], a, b)


def has_moved(state: KissState, min_motion_th: float) -> torch.Tensor:
    """Reference icp.cpp:156-163: ||(first^-1 last).t|| > 5 * min_motion_th."""
    rel = lie.compose(lie.transform_inverse(state.first_pose), state.pose)
    motion = torch.linalg.norm(rel[..., :3, 3], dim=-1)
    return (state.num_poses > 0) & (motion > 5.0 * min_motion_th)


def get_prediction_model(state: KissState) -> torch.Tensor:
    """T_{n-2}^-1 T_{n-1} (reference icp.cpp:146-154)."""
    pred = lie.compose(lie.transform_inverse(state.pose_prev), state.pose)
    return _where(state.num_poses < 2, _eye4(pred.device, pred.shape[:-2]), pred)


def _rebuild_where_needed(m: voxel_map.VoxelMap, cfg: PipelineConfig) -> voxel_map.VoxelMap:
    """Conditional slab compaction (JAX kiss_icp.py:199-207): one host read
    of the per-stream predicate; when any stream needs it, the streams
    that do take the rebuilt tables."""
    cap = cfg.map.capacity
    need = (m.next_slot > cap - cap // 8) & (m.tombstones > cap // 16)
    if not bool(torch.any(need)):  # host sync: compaction is rare
        return m
    rebuilt = voxel_map.rebuild(m, cfg.map)
    return voxel_map.VoxelMap(*(
        torch.where(need.reshape(need.shape + (1,) * (a.dim() - need.dim())), a, b)
        for a, b in zip(rebuilt, m)))


def register_core(m: voxel_map.VoxelMap, threshold: icp_ops.ThresholdState, moved,
                  deskewed_xyz, mask, init_guess, cfg: PipelineConfig, tau=None,
                  inplace: bool = False) -> CoreOutput:
    """Downsample -> adaptive-threshold robust ICP -> divergence gate ->
    map update: the classic registration trunk (JAX kiss_icp.py:102,
    reference icp.cpp:58-86), all pose math f64. Inputs may carry a leading
    stream axis. With `inplace` the map tables are updated in place."""
    dev = deskewed_xyz.device
    lead = mask.shape[:-1]
    tg = init_guess[..., :3, 3].to(torch.float32)
    world = (lie.rotate_points(init_guess[..., None, :3, :3], deskewed_xyz)
             + tg[..., None, :])
    g = voxel_map.fused_downsample(
        world, mask, cfg.map.voxel_size, cfg.icp.max_map_points,
        tau=None if cfg.lidar.sort_by_time else tau,
    )
    with annotate("kiss_icp.source"):
        source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
            g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
        )
        d_sq = torch.sum((source - tg[..., None, :]) ** 2, dim=-1)
        source_mask = stats.iqr_inlier_mask(d_sq.to(F64), source_mask)

    thr_state, sigma = icp_ops.compute_threshold(
        threshold, moved, cfg.icp.initial_threshold, cfg.icp.min_motion_th,
        cfg.map.max_range)
    # ICP on the world-frame source from identity: the result is the
    # correction, composed with the guess here
    result = icp_ops.registration_dispatch(
        m, source, source_mask, _eye4(dev, lead), sigma, cfg.map, cfg.icp)
    pose_icp = lie.compose(result.pose, init_guess)
    # scan-level divergence gate, then the quaternion re-orthonormalization
    eye = _eye4(dev, lead)
    model_dev = lie.compose(lie.transform_inverse(init_guess), pose_icp)
    diverged = torch.linalg.norm(model_dev[..., :3, 3], dim=-1) > cfg.icp.max_model_deviation
    new_pose = lie.orthonormalize(_where(diverged, init_guess, pose_icp))
    model_dev = _where(diverged, eye, model_dev)
    thr_state = icp_ops.update_model_deviation(thr_state, model_dev)

    # map update with the correction delta only (reference icp.cpp:81);
    # keys from the PRE-correction grouping (unique per group)
    delta = lie.compose(new_pose, lie.transform_inverse(init_guess))
    g_corr = g._replace(
        points=lie.rotate_points(delta[..., None, :3, :3], g.points)
        + delta[..., None, :3, 3].to(torch.float32))
    pre_keys = voxel_map.pack_key(voxel_map.voxel_of(g.points, cfg.map.voxel_size))
    new_map = voxel_map.insert_grouped(m, g_corr, cfg.map, keys=pre_keys, inplace=inplace)
    if cfg.map.auto_evict:
        new_map = voxel_map.evict_far(new_map, new_pose[..., :3, 3], cfg.map, inplace=True)
    if cfg.map.auto_rebuild:
        new_map = _rebuild_where_needed(new_map, cfg)
    return CoreOutput(
        new_map=new_map,
        threshold=thr_state,
        pose=new_pose,
        keypoints=source,
        keypoints_mask=source_mask,
        map_points=g_corr.points,
        map_points_mask=g.mask,
        icp_iterations=result.iterations,
        num_correspondences=result.num_correspondences,
        residual_rms=result.residual_rms,
        sigma=sigma,
        icp_converged=result.converged,
        window_drops=g.window_drops + src_drops,
    )


def pose_pre_row(state: KissState, cfg: PipelineConfig) -> pose_chain.PoseRow:
    """Kernel K2 on the pose state: the (32,) f64 row of CV guess, sigma,
    moved flag, threshold accumulators and deskew twist pieces, and the
    accumulators as state tensors (ops/kernels/pose_chain.py)."""
    thr = state.threshold
    return pose_chain.pose_pre(
        state.pose, state.pose_prev, state.first_pose, thr.model_error_sq,
        thr.model_deviation, state.num_poses, thr.num_samples,
        min_motion_th=cfg.icp.min_motion_th,
        initial_threshold=cfg.icp.initial_threshold,
        max_range=cfg.map.max_range,
        deskew_on=cfg.icp.deskew,
    )


def _fast_trunk(state: KissState, deskewed_xyz, mask, tau, guess: torch.Tensor,
                sigma: torch.Tensor, cfg: PipelineConfig,
                inplace: bool = False) -> FastCoreOutput:
    """The registration trunk shared by the lidar-only and LIO paths: world
    transform at the guess, fused grouped downsample, IQR source mask,
    fused ICP, kernel K3 (on the state's map and pose history), map insert
    / evict (+ conditional compaction). `guess` is a 1-D f64 whose first 12
    entries are the guess [R 9 | t 3] (the pose_pre row, or LIO's IMU
    guess); `sigma` the () f64 adaptive threshold. With `inplace` the map
    tables are updated in place."""
    m = state.map
    tg = guess[9:12].to(torch.float32)
    world = lie.rotate_points(guess[:9].reshape(3, 3), deskewed_xyz) + tg
    g = voxel_map.fused_downsample(
        world, mask, cfg.map.voxel_size, cfg.icp.max_map_points,
        tau=None if cfg.lidar.sort_by_time else tau,
    )
    with annotate("kiss_icp.source"):
        source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
            g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
        )
        d_sq = torch.sum((source - tg[None, :]) ** 2, dim=-1)
        source_mask = stats.iqr_inlier_mask(d_sq.to(F64), source_mask)

    # ICP on the world-frame source from identity: the result is the
    # correction; pose_post composes corr @ guess
    dev = source.device
    with annotate("icp.register"):
        res = icp_ops.icp_registration_fused_pair(
            m, source, source_mask,
            torch.eye(3, dtype=F64, device=dev).reshape(9),
            torch.zeros(3, dtype=F64, device=dev),
            max_corresp_dist=3.0 * sigma, kernel_th=sigma / 3.0,
            map_cfg=cfg.map, max_iterations=cfg.icp.max_iterations,
            estimation_threshold=cfg.icp.estimation_threshold,
            min_correspondences=cfg.icp.min_correspondences,
            max_step_norm=cfg.icp.max_step_norm, n_inner=cfg.icp.fused_inner,
        )
    post = pose_chain.pose_post(res.pose, guess, state.pose, state.first_pose,
                                state.num_poses,
                                max_model_deviation=cfg.icp.max_model_deviation)

    # map update with the correction delta only (reference icp.cpp:81);
    # keys from the PRE-correction grouping (unique per group)
    g_corr = g._replace(points=lie.rotate_points(post.delta_R, g.points) + post.delta_t)
    pre_keys = voxel_map.pack_key(voxel_map.voxel_of(g.points, cfg.map.voxel_size))
    new_map = voxel_map.insert_grouped(m, g_corr, cfg.map, keys=pre_keys, inplace=inplace)
    # the insert produced (or, in place, owns) every table the eviction
    # rewrites, so the eviction always works in place
    if cfg.map.auto_evict:
        new_map = voxel_map.evict_far(new_map, post.row[9:12], cfg.map, inplace=True)
    if cfg.map.auto_rebuild:
        cap = cfg.map.capacity
        need = (new_map.next_slot > cap - cap // 8) & (new_map.tombstones > cap // 16)
        if bool(need):  # host sync: compaction is rare and rewrites the map
            new_map = voxel_map.rebuild(new_map, cfg.map)
    return FastCoreOutput(
        new_map=new_map,
        post=post,
        source=source,
        source_mask=source_mask,
        map_points=g_corr.points,
        map_points_mask=g.mask,
        sigma=sigma,
        iterations=res.iterations,
        num_correspondences=res.num_correspondences,
        residual_rms=res.residual_rms,
        converged=res.converged,
        window_drops=g.window_drops + src_drops,
    )


def fast_state(new_map: voxel_map.VoxelMap, pre: pose_chain.PoseRow,
               post: pose_chain.PosePost) -> KissState:
    """The next state of the fast path (JAX kiss_icp.py:409-420) from
    kernel K2's and K3's outputs: the kernels wrote every pose leaf and
    accumulator, so nothing is computed here. The lidar-only and LIO fast
    steps both build their state with it."""
    return KissState(
        map=new_map,
        pose=post.pose,
        pose_prev=post.pose_prev,
        first_pose=post.first_pose,
        num_poses=post.num_poses,
        threshold=icp_ops.ThresholdState(pre.model_error_sq, pre.num_samples,
                                         post.model_deviation),
    )


@annotate("kiss_icp.step")
def _register_frame_fast(state: KissState, scan: Scan, cfg: PipelineConfig,
                         inplace: bool = False):
    """The fast path: pose bookkeeping in kernels K2/K3 around the fused
    ICP trunk (JAX kiss_icp.py:382), all pose math f64."""
    pre = pose_pre_row(state, cfg)
    row = pre.row
    # vector deskew driven by the kernel's twist scalars (identity when the
    # kernel gated them to zero)
    with annotate("kiss_icp.deskew"):
        deskewed_xyz = deskew_ops.deskew_from_scalars(scan.xyz, scan.tau, row[16:29])
    core = _fast_trunk(state, deskewed_xyz, scan.mask, scan.tau, row, row[12], cfg,
                       inplace=inplace)
    new_state = fast_state(core.new_map, pre, core.post)
    out = FrameOutput(
        pose=new_state.pose,
        keypoints=core.source,
        keypoints_mask=core.source_mask,
        deskewed=core.map_points,
        deskewed_mask=core.map_points_mask,
        # a fill, not a host-to-device copy of the loop's count (a sync)
        icp_iterations=torch.full((), core.iterations, dtype=torch.int32,
                                  device=row.device),
        num_correspondences=core.num_correspondences,
        residual_rms=core.residual_rms,
        sigma=core.sigma,
        map_voxels=voxel_map.num_voxels(core.new_map),
        icp_converged=core.converged,
        window_drops=core.window_drops,
    )
    return new_state, out


@annotate("kiss_icp.step")
def register_frame_classic(state: KissState, scan: Scan, cfg: PipelineConfig,
                           inplace: bool = False):
    """The classic branch of `register_frame` (JAX kiss_icp.py:463-514) on
    a state and scan with or without a leading stream axis: CV deskew
    (gated per stream on num_poses > 2), CV guess, `register_core`, pose
    bookkeeping."""
    dev = scan.xyz.device
    lead = scan.mask.shape[:-1]
    if cfg.icp.deskew:
        with annotate("kiss_icp.deskew"):
            deskewed = deskew_ops.constant_velocity_deskew_fast(
                scan.xyz, scan.tau, state.pose_prev, state.pose)
            deskewed_xyz = torch.where((state.num_poses > 2)[..., None, None], deskewed,
                                       scan.xyz)
    else:
        deskewed_xyz = scan.xyz
    last_pose = _where(state.num_poses == 0, _eye4(dev, lead), state.pose)
    init_guess = lie.compose(last_pose, get_prediction_model(state))
    moved = has_moved(state, cfg.icp.min_motion_th)
    core = register_core(state.map, state.threshold, moved, deskewed_xyz, scan.mask,
                         init_guess, cfg, tau=scan.tau, inplace=inplace)
    first = state.num_poses == 0
    new_state = KissState(
        map=core.new_map,
        pose=core.pose,
        pose_prev=_where(first, core.pose, state.pose),
        first_pose=_where(first, core.pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=core.threshold,
    )
    out = FrameOutput(
        pose=core.pose,
        keypoints=core.keypoints,
        keypoints_mask=core.keypoints_mask,
        deskewed=core.map_points,
        deskewed_mask=core.map_points_mask,
        icp_iterations=core.icp_iterations,
        num_correspondences=core.num_correspondences,
        residual_rms=core.residual_rms,
        sigma=core.sigma,
        map_voxels=voxel_map.num_voxels(core.new_map),
        icp_converged=core.icp_converged,
        window_drops=core.window_drops,
    )
    return new_state, out


def _is_fast(cfg: PipelineConfig) -> bool:
    return cfg.icp.gn_backend == "pallas" and cfg.icp.batch_unroll_outer == 0


def register_frame(state: KissState, scan: Scan, cfg: PipelineConfig):
    """One odometry step (reference icp.cpp:49-86). Returns (state', out);
    the passed state is left unchanged.

    gn_backend="pallas" with batch_unroll_outer == 0 runs the fast path;
    every other config the classic branch: with gn_backend="pallas" the
    fixed unroll on kernel K4, with gn_backend="xla" (the default) the f64
    loops."""
    if _is_fast(cfg):
        return _register_frame_fast(state, scan, cfg)
    return register_frame_classic(state, scan, cfg)


def register_frame_step(state: KissState, scan: Scan, cfg: PipelineConfig):
    """`register_frame` that updates the map tables of `state` in place —
    the analogue of the JAX package's donated `register_frame_step`: no
    copy of the ~40 MB map per scan. The caller must not reuse `state`
    after the call (the returned state shares its storage)."""
    if _is_fast(cfg):
        return _register_frame_fast(state, scan, cfg, inplace=True)
    return register_frame_classic(state, scan, cfg, inplace=True)
