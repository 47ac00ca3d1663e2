"""KISS-ICP-style LiDAR odometry (counterpart of the JAX package's
`models/kiss_icp.py`; reference src/odom_run.cpp:154-185 ->
src/sensors/lidar/icp.cpp:49-86).

    state', out = register_frame(state, scan, cfg)

One registration trunk: guess -> world points -> grouped downsample,
source and IQR mask (`select_source`) -> threshold -> ICP -> divergence
gate -> map update with the correction delta, keyed by the pre-correction
voxels (`update_map`: insert, evict, compaction) -> next state. It has two
forms, chosen by the config as in the JAX package:

* `register_core_fast` (gn_backend="pallas", batch_unroll_outer == 0):
  kernel K2 (`pose_pre`: CV guess, adaptive sigma, deskew twist) runs
  before it; inside, the fused ICP (kernel K1 per round) and kernel K3
  (`pose_post`: compose, divergence gate, orthonormalize, map delta, and
  the next state's pose bookkeeping). Host syncs per scan: one per ICP
  round, plus one for the conditional compaction when
  `cfg.map.auto_rebuild` is on.
* `register_core` (every other config): the threshold, the gate and the
  pose bookkeeping in plain f64 tensor code (`adaptive_threshold`,
  `divergence_gate`, `next_state`) around the ICP the config selects —
  - gn_backend="xla" (the default config): the f64 loops over candidates
    from the f32 point slab, no kernel. The while loop reads one flag pair
    from the device per GN iteration; under `batch_unroll_outer > 0` the
    fixed unroll reads nothing;
  - gn_backend="pallas" with `batch_unroll_outer > 0` (as
    `parallel.streams.batch_config` sets it): the fixed unroll with one K4
    launch per ICP round (K5 when the state carries a leading stream axis).
  Plus one host read per scan for the conditional compaction when
  `cfg.map.auto_rebuild` is on, which batch_config turns off.

The lidar-only steps below and the LIO step (`models/lio.py`) call the
trunk; the map-sharded step (`parallel/sharded_map.py`) calls its pieces
around its sharded ICP and owner-masked insert.

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
    """One registration's outputs; leaves carry the state's stream axis."""

    pose: torch.Tensor  # (4, 4) f64 world pose of this scan (divergence-gated)
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


def init_state(cfg: PipelineConfig, device: torch.device | str = "cuda",
               streams: int | None = None) -> KissState:
    """A fresh state; with `streams`, S fresh states on a leading axis."""
    lead = () if streams is None else (streams,)

    def eye():
        return lie.eye4(device, lead).clone()

    return KissState(
        map=voxel_map.create(cfg.map, device, streams),
        pose=eye(),
        pose_prev=eye(),
        first_pose=eye(),
        num_poses=torch.zeros(lead, dtype=torch.int32, device=device),
        threshold=icp_ops.threshold_init(device, lead),
    )


def has_moved(state: KissState, min_motion_th: float) -> torch.Tensor:
    """Reference icp.cpp:156-163: ||(first^-1 last).t|| > 5 * min_motion_th."""
    rel = lie.compose(lie.transform_inverse(state.first_pose), state.pose)
    motion = torch.linalg.norm(rel[..., :3, 3], dim=-1)
    return (state.num_poses > 0) & (motion > 5.0 * min_motion_th)


def get_prediction_model(state: KissState) -> torch.Tensor:
    """T_{n-2}^-1 T_{n-1} (reference icp.cpp:146-154)."""
    pred = lie.compose(lie.transform_inverse(state.pose_prev), state.pose)
    return lie.where_pose(state.num_poses < 2, lie.eye4(pred.device, pred.shape[:-2]), pred)


def constant_velocity_guess(state: KissState) -> torch.Tensor:
    """The registration's initial guess: the last pose (the identity before
    the first scan) composed with the prediction model."""
    eye = lie.eye4(state.pose.device, state.num_poses.shape)
    last_pose = lie.where_pose(state.num_poses == 0, eye, state.pose)
    return lie.compose(last_pose, get_prediction_model(state))


def constant_velocity_deskew(state: KissState, scan: Scan, cfg: PipelineConfig,
                             pre: pose_chain.PoseRow | None = None) -> torch.Tensor:
    """The scan's points deskewed at constant velocity. On the fast path
    (`pre`, kernel K2's row) by the row's twist scalars, which the kernel
    gated to the identity when deskew is off or fewer than 3 poses exist;
    otherwise, under `cfg.icp.deskew`, between the last two poses where
    num_poses > 2 (per stream)."""
    if pre is not None:
        with annotate("kiss_icp.deskew"):
            return deskew_ops.deskew_from_scalars(scan.xyz, scan.tau, pre.row[16:29])
    if not cfg.icp.deskew:
        return scan.xyz
    with annotate("kiss_icp.deskew"):
        deskewed = deskew_ops.constant_velocity_deskew_fast(
            scan.xyz, scan.tau, state.pose_prev, state.pose)
        return torch.where((state.num_poses > 2)[..., None, None], deskewed, scan.xyz)


def select_source(world, mask, centre, cfg: PipelineConfig, tau=None):
    """The world points at the guess (..., N, 3) f32 through the fused
    grouped downsample (by `tau` only when the scan is not sorted by time),
    then the ICP source (first point per 1.5-voxel) and its IQR inlier mask
    on the squared distance to `centre` (..., 3) f32, the guess's
    translation. Returns (grouped cloud, source, source mask, window
    drops)."""
    g = voxel_map.fused_downsample(
        world, mask, cfg.map.voxel_size, cfg.icp.max_map_points,
        tau=None if cfg.lidar.sort_by_time else tau,
    )
    with annotate("kiss_icp.source"):
        source, source_mask, _, src_drops = voxel_map.first_point_per_voxel(
            g.points, g.mask, 1.5 * cfg.map.voxel_size, cfg.icp.max_source_points
        )
        d_sq = torch.sum((source - centre[..., None, :]) ** 2, dim=-1)
        source_mask = stats.iqr_inlier_mask(d_sq.to(F64), source_mask)
    return g, source, source_mask, g.window_drops + src_drops


def adaptive_threshold(state, cfg: PipelineConfig):
    """`has_moved` and the adaptive threshold on a state with `pose`,
    `first_pose`, `num_poses` and `threshold`: (threshold state', sigma)."""
    moved = has_moved(state, cfg.icp.min_motion_th)
    return icp_ops.compute_threshold(state.threshold, moved, cfg.icp.initial_threshold,
                                     cfg.icp.min_motion_th, cfg.map.max_range)


def divergence_gate(guess, pose_icp, threshold: icp_ops.ThresholdState, cfg: PipelineConfig):
    """The scan-level divergence gate (a pose that moved more than
    `max_model_deviation` from the guess falls back to the guess), the
    quaternion re-orthonormalization, and the model deviation recorded for
    the next threshold. Returns (new pose, threshold state')."""
    eye = lie.eye4(guess.device, guess.shape[:-2])
    model_dev = lie.compose(lie.transform_inverse(guess), pose_icp)
    diverged = torch.linalg.norm(model_dev[..., :3, 3], dim=-1) > cfg.icp.max_model_deviation
    new_pose = lie.orthonormalize(lie.where_pose(diverged, guess, pose_icp))
    model_dev = lie.where_pose(diverged, eye, model_dev)
    return new_pose, icp_ops.update_model_deviation(threshold, model_dev)


def map_delta(new_pose, guess):
    """The map correction new_pose guess^-1 as (rotation (..., 1, 3, 3) f64,
    translation (..., 1, 3) f32), broadcast over a cloud's points."""
    delta = lie.compose(new_pose, lie.transform_inverse(guess))
    return delta[..., None, :3, :3], delta[..., None, :3, 3].to(torch.float32)


def corrected_cloud(g: voxel_map.GroupedCloud, delta_R, delta_t, cfg: PipelineConfig):
    """The grouped cloud moved by the correction delta only (reference
    icp.cpp:81), and the keys of its PRE-correction voxels (unique per
    group) that the insert files it under."""
    g_corr = g._replace(points=lie.rotate_points(delta_R, g.points) + delta_t)
    keys = voxel_map.pack_key(voxel_map.voxel_of(g.points, cfg.map.voxel_size))
    return g_corr, keys


def _rebuild_where_needed(m: voxel_map.VoxelMap, cfg: PipelineConfig) -> voxel_map.VoxelMap:
    """Conditional slab compaction (JAX kiss_icp.py:199-207): one host read
    of the per-stream predicate. One stream takes the rebuilt tables as
    they are; with a stream axis, when any stream needs it, the streams
    that do take theirs."""
    cap = cfg.map.capacity
    need = (m.next_slot > cap - cap // 8) & (m.tombstones > cap // 16)
    if need.dim() == 0:  # host sync: compaction is rare and rewrites the map
        return voxel_map.rebuild(m, cfg.map) if bool(need) else m
    if not bool(torch.any(need)):  # host sync
        return m
    rebuilt = voxel_map.rebuild(m, cfg.map)
    return voxel_map.VoxelMap(*(
        torch.where(need.reshape(need.shape + (1,) * (a.dim() - need.dim())), a, b)
        for a, b in zip(rebuilt, m)))


def update_map(m: voxel_map.VoxelMap, g: voxel_map.GroupedCloud, delta_R, delta_t, origin,
               cfg: PipelineConfig, inplace: bool = False):
    """Insert the corrected cloud under its pre-correction keys, then evict
    around `origin` (the new pose's translation) under `auto_evict` and
    compact under `auto_rebuild`. With `inplace` the insert updates the map
    tables in place; the insert produced (or, in place, owns) every table
    the eviction rewrites, so the eviction always works in place. Returns
    (map', corrected points)."""
    g_corr, keys = corrected_cloud(g, delta_R, delta_t, cfg)
    new_map = voxel_map.insert_grouped(m, g_corr, cfg.map, keys=keys, inplace=inplace)
    if cfg.map.auto_evict:
        new_map = voxel_map.evict_far(new_map, origin, cfg.map, inplace=True)
    if cfg.map.auto_rebuild:
        new_map = _rebuild_where_needed(new_map, cfg)
    return new_map, g_corr.points


def next_state(state, new_map, new_pose, threshold: icp_ops.ThresholdState):
    """The classic next-pose bookkeeping on any state with KissState's
    fields (`_replace` keeps its type): pose_prev and first_pose take the
    new pose on the first scan."""
    first = state.num_poses == 0
    return state._replace(
        map=new_map,
        pose=new_pose,
        pose_prev=lie.where_pose(first, new_pose, state.pose),
        first_pose=lie.where_pose(first, new_pose, state.first_pose),
        num_poses=state.num_poses + 1,
        threshold=threshold,
    )


def register_core(state: KissState, deskewed_xyz, mask, init_guess, cfg: PipelineConfig,
                  tau=None, inplace: bool = False):
    """The classic registration trunk (JAX kiss_icp.py:102, reference
    icp.cpp:58-86), all pose math f64: source selection at the (..., 4, 4)
    guess, adaptive-threshold robust ICP, divergence gate, map update, pose
    bookkeeping. Inputs may carry a leading stream axis. With `inplace` the
    map tables are updated in place. Returns (state', FrameOutput)."""
    dev = deskewed_xyz.device
    lead = mask.shape[:-1]
    tg = init_guess[..., :3, 3].to(torch.float32)
    world = (lie.rotate_points(init_guess[..., None, :3, :3], deskewed_xyz)
             + tg[..., None, :])
    g, source, source_mask, drops = select_source(world, mask, tg, cfg, tau)
    thr_state, sigma = adaptive_threshold(state, cfg)
    # ICP on the world-frame source from identity: the result is the
    # correction, composed with the guess here
    result = icp_ops.registration_dispatch(
        state.map, source, source_mask, lie.eye4(dev, lead), sigma, cfg.map, cfg.icp)
    new_pose, thr_state = divergence_gate(init_guess, lie.compose(result.pose, init_guess),
                                          thr_state, cfg)
    new_map, map_points = update_map(state.map, g, *map_delta(new_pose, init_guess),
                                     new_pose[..., :3, 3], cfg, inplace)
    out = FrameOutput(
        pose=new_pose,
        keypoints=source,
        keypoints_mask=source_mask,
        deskewed=map_points,
        deskewed_mask=g.mask,
        icp_iterations=result.iterations,
        num_correspondences=result.num_correspondences,
        residual_rms=result.residual_rms,
        sigma=sigma,
        map_voxels=voxel_map.num_voxels(new_map),
        icp_converged=result.converged,
        window_drops=drops,
    )
    return next_state(state, new_map, new_pose, thr_state), out


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


def fast_state(new_map: voxel_map.VoxelMap, pre: pose_chain.PoseRow,
               post: pose_chain.PosePost) -> KissState:
    """The next state of the fast path (JAX kiss_icp.py:409-420) from
    kernel K2's and K3's outputs: the kernels wrote every pose leaf and
    accumulator, so nothing is computed here."""
    return KissState(
        map=new_map,
        pose=post.pose,
        pose_prev=post.pose_prev,
        first_pose=post.first_pose,
        num_poses=post.num_poses,
        threshold=icp_ops.ThresholdState(pre.model_error_sq, pre.num_samples,
                                         post.model_deviation),
    )


def register_core_fast(state: KissState, deskewed_xyz, mask, guess: torch.Tensor,
                       cfg: PipelineConfig, pre: pose_chain.PoseRow, tau=None,
                       inplace: bool = False):
    """The trunk on the fast path, one stream: source selection at the
    guess, fused ICP, kernel K3 (on the state's map and pose history), map
    update. `guess` is a 1-D f64 whose first 12 entries are the guess [R 9
    | t 3] (K2's row `pre.row`, or LIO's IMU guess); the adaptive threshold
    and the accumulators come from K2's `pre`, whichever guess K3 composes
    with. With `inplace` the map tables are updated in place. Returns
    (state', FrameOutput)."""
    tg = guess[9:12].to(torch.float32)
    world = lie.rotate_points(guess[:9].reshape(3, 3), deskewed_xyz) + tg
    g, source, source_mask, drops = select_source(world, mask, tg, cfg, tau)
    sigma = pre.row[12]
    # ICP on the world-frame source from identity: the result is the
    # correction; pose_post composes corr @ guess
    dev = source.device
    with annotate("icp.register"):
        res = icp_ops.icp_registration_fused_pair(
            state.map, source, source_mask,
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
    new_map, map_points = update_map(state.map, g, post.delta_R, post.delta_t, post.row[9:12],
                                     cfg, inplace)
    new_state = fast_state(new_map, pre, post)
    out = FrameOutput(
        pose=new_state.pose,
        keypoints=source,
        keypoints_mask=source_mask,
        deskewed=map_points,
        deskewed_mask=g.mask,
        # a fill, not a host-to-device copy of the loop's count (a sync)
        icp_iterations=torch.full((), res.iterations, dtype=torch.int32, device=dev),
        num_correspondences=res.num_correspondences,
        residual_rms=res.residual_rms,
        sigma=sigma,
        map_voxels=voxel_map.num_voxels(new_map),
        icp_converged=res.converged,
        window_drops=drops,
    )
    return new_state, out


@annotate("kiss_icp.step")
def _register_frame_fast(state: KissState, scan: Scan, cfg: PipelineConfig,
                         inplace: bool = False):
    """The fast path: kernel K2, the K2-driven deskew, then the fast trunk
    (JAX kiss_icp.py:382), all pose math f64."""
    pre = pose_pre_row(state, cfg)
    deskewed_xyz = constant_velocity_deskew(state, scan, cfg, pre)
    return register_core_fast(state, deskewed_xyz, scan.mask, pre.row, cfg, pre,
                              tau=scan.tau, inplace=inplace)


@annotate("kiss_icp.step")
def register_frame_classic(state: KissState, scan: Scan, cfg: PipelineConfig,
                           inplace: bool = False):
    """The classic branch of `register_frame` (JAX kiss_icp.py:463-514) on
    a state and scan with or without a leading stream axis: CV deskew
    (gated per stream on num_poses > 2), CV guess, `register_core`."""
    deskewed_xyz = constant_velocity_deskew(state, scan, cfg)
    return register_core(state, deskewed_xyz, scan.mask, constant_velocity_guess(state), cfg,
                         tau=scan.tau, inplace=inplace)


def is_fast(cfg: PipelineConfig) -> bool:
    """Whether the config takes the fast path (`register_core_fast`)."""
    return cfg.icp.gn_backend == "pallas" and cfg.icp.batch_unroll_outer == 0


def register_frame(state: KissState, scan: Scan, cfg: PipelineConfig):
    """One odometry step (reference icp.cpp:49-86). Returns (state', out);
    the passed state is left unchanged.

    gn_backend="pallas" with batch_unroll_outer == 0 runs the fast path;
    every other config the classic branch: with gn_backend="pallas" the
    fixed unroll on kernel K4, with gn_backend="xla" (the default) the f64
    loops."""
    if is_fast(cfg):
        return _register_frame_fast(state, scan, cfg)
    return register_frame_classic(state, scan, cfg)


def register_frame_step(state: KissState, scan: Scan, cfg: PipelineConfig):
    """`register_frame` that updates the map tables of `state` in place —
    the analogue of the JAX package's donated `register_frame_step`: no
    copy of the ~40 MB map per scan. The caller must not reuse `state`
    after the call (the returned state shares its storage)."""
    if is_fast(cfg):
        return _register_frame_fast(state, scan, cfg, inplace=True)
    return register_frame_classic(state, scan, cfg, inplace=True)
