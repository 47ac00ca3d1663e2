"""Map-parallel odometry: ONE SLAM stream whose voxel map is split into D
shards (counterpart of the JAX package's `parallel/sharded_map.py`).

Every shard is an independent sub-table of `cfg.map.capacity` slots; voxel
keys go to shards by a salted hash (`_owner`), so the total capacity is D x
capacity and a window never crosses a shard boundary. With zero drops the
sharded pipeline stores the same per-voxel content as one map of D x
capacity and picks the same NN winners, so the poses agree with it.

The JAX package computes the shard axis as a leading axis under `jax.vmap`
and lets GSPMD place it. Here the axis is explicit, as the stream axis of
`parallel/streams.py` is: the map's leaves carry a leading D (a multi-state
(S, D)), and the port's `voxel_map` functions take it as one more leading
axis. Over a `parallel.mesh.Mesh` each rank holds a contiguous block of the
shard axis (`shard_state`); without a mesh one device holds all D. The
replicated work runs the same on every rank, as under GSPMD: it is the
lidar-only registration trunk's own code (`models/kiss_icp`: the CV guess,
`select_source`, `adaptive_threshold`, `divergence_gate`,
`corrected_cloud`, `next_state`; `icp.gn_step` for the GN solve). The only
collectives, all over the mesh's map axis:

* per GN iteration, the cross-shard NN winner (`_sharded_nn_from_candidates`):
  one all_reduce MIN of (d^2 bits << 32 | global shard index), which keeps
  jnp.argmin's first-shard tie rule, and one all_reduce SUM of the winner's
  coordinate bits (zero elsewhere). Both are exact, and NCCL and gloo-on-CUDA
  support both;
* per scan, the map's voxel count before the ICP (the empty-map guard) and
  the voxel and drop counts after the insert.

The JAX package masks only the group heads by owner (sharded_map.py:237).
With the head-compacted insert (`max_insert_voxels > 0`) that attributes a
non-owned group's members to the previous owned head; the port partitions
each shard's owned groups to the front instead (`_owned_cloud`), which
gives JAX's tables bit for bit where JAX's insert is right
(`max_insert_voxels == 0`) and the single map's content where it is not
(ROADMAP queue 3).

The sharded NN and GN are plain torch, as they are plain jnp in the JAX
package: this path launches no kernel. No step reads the device from the
host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..models import kiss_icp
from ..ops import icp as icp_ops
from ..ops import lie, voxel_map
from .mesh import Mesh, all_reduce, on_device, tree_map

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64


class ShardedKissState(NamedTuple):
    map: voxel_map.VoxelMap  # leaves with a leading (D, ...) shard axis
    pose: torch.Tensor
    pose_prev: torch.Tensor
    first_pose: torch.Tensor
    num_poses: torch.Tensor
    threshold: icp_ops.ThresholdState


def init_state(cfg: PipelineConfig, n_shards: int,
               device: torch.device | str = "cuda") -> ShardedKissState:
    """D empty shards and a fresh pose state, all on `device`."""
    def eye():
        return torch.eye(4, dtype=F64, device=device)

    return ShardedKissState(
        map=voxel_map.create(cfg.map, device, streams=n_shards),
        pose=eye(),
        pose_prev=eye(),
        first_pose=eye(),
        num_poses=torch.zeros((), dtype=I32, device=device),
        threshold=icp_ops.threshold_init(device),
    )


def shard_state(state: ShardedKissState, mesh: Mesh, axis: str = "mp") -> ShardedKissState:
    """This rank's block of the map's shard axis on the mesh's device; the
    rest replicated."""
    def shard(x):
        return on_device(x[slice(*mesh.block(axis, x.shape[0]))], mesh.device)

    return ShardedKissState(tree_map(shard, state.map),
                            *tree_map(lambda x: on_device(x, mesh.device), tuple(state[1:])))


def _owner(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard of each key, by a salted hash whose bits are independent of the
    in-table bucket hash (JAX sharded_map.py:79). The uint32 arithmetic runs
    in int64, masked to 32 bits after each step: the keys are below 2^32 and
    the constants below 2^30, so every product fits in 63 bits."""
    m32 = 0xFFFFFFFF
    k = (keys.to(I64) & m32) ^ 0x9E3779B9
    k = ((k ^ (k >> 15)) * 0x2C1B3C6D) & m32
    k = ((k ^ (k >> 12)) * 0x297A2D39) & m32
    k = k ^ (k >> 15)
    return (k % n_shards).to(I32)


def _sharded_fetch(smap: voxel_map.VoxelMap, queries_f32, qmask, cfg: PipelineConfig):
    """Per-shard candidate gather (once per outer round): the replicated
    queries (..., N, 3) against every local shard, (..., D, N, NB*K)
    de-interleaved planes."""
    lead = qmask.shape[:-1]
    d = smap.keys.shape[len(lead)]
    q = queries_f32.unsqueeze(-3).expand(lead + (d,) + tuple(queries_f32.shape[-2:]))
    qm = qmask.unsqueeze(-2).expand(lead + (d, qmask.shape[-1]))
    cand, cand_valid = voxel_map.gather_candidates(smap, q, qm, cfg.map)
    return (*voxel_map.deinterleave_candidates(cand), cand_valid)


def _sharded_nn_from_candidates(planes, qx, qy, qz, qmask, shard0: int, group):
    """Per-shard reduce over the cached candidates, then the cross-shard
    argmin with jnp.argmin's tie rule (the lowest global shard index among
    the shards that reach the least d^2). Returns SoA winners (..., N).

    The d^2 are non-negative f32 (+inf where none), so their bit patterns
    order as integers: one MIN of (bits << 32 | shard) picks the winner, and
    a SUM of the winner's coordinate bits (zero elsewhere) carries its point
    exactly."""
    cx, cy, cz, cand_valid = planes
    tx, ty, tz, d2, _ = voxel_map.nn_from_candidates_soa(
        cx, cy, cz, cand_valid, qx.unsqueeze(-2), qy.unsqueeze(-2), qz.unsqueeze(-2),
        qmask.unsqueeze(-2))  # (..., D, N)
    d = d2.shape[-2]
    gidx = shard0 + torch.arange(d, dtype=I64, device=d2.device)[:, None]
    key = (d2.view(I32).to(I64) << 32) | gidx
    best = all_reduce(key.amin(dim=-2), dist.ReduceOp.MIN, group)
    winner = gidx == (best & 0xFFFFFFFF).unsqueeze(-2)
    bits = torch.stack([tx, ty, tz], dim=-3).view(I32)  # (..., 3, D, N)
    xyz = torch.where(winner.unsqueeze(-3), bits, torch.zeros_like(bits)).to(I64).sum(dim=-2)
    xyz = all_reduce(xyz, dist.ReduceOp.SUM, group).to(I32).view(F32)
    nn_d2 = (best >> 32).to(I32).view(F32)
    found = qmask & torch.isfinite(nn_d2)
    return xyz[..., 0, :], xyz[..., 1, :], xyz[..., 2, :], nn_d2, found


def _map_voxels(smap: voxel_map.VoxelMap, lead: tuple, group) -> torch.Tensor:
    """Voxels over every shard of the map, (...) i64."""
    return all_reduce(voxel_map.num_voxels(smap).to(I64).sum(dim=len(lead)),
                      dist.ReduceOp.SUM, group)


def _icp_sharded(smap, source, source_mask, max_corresp_dist, kernel_th,
                 cfg: PipelineConfig, n_outer: int, n_inner: int, shard0: int = 0,
                 group=None):
    """Fixed-unroll GN-ICP against the sharded map (JAX sharded_map.py:121):
    `icp_registration_unrolled`'s fetch-per-outer-round schedule and GN step
    (`icp.gn_step`) with the sharded NN. Inputs may carry a leading stream
    axis. Returns (T_icp, iterations, correspondences)."""
    dev = source.device
    lead = source_mask.shape[:-1]
    max_d2 = max_corresp_dist * max_corresp_dist
    px, py, pz = (source[..., i].to(F64) for i in range(3))
    eye = lie.eye4(dev, lead)

    T_icp = eye
    converged = torch.zeros(lead, dtype=torch.bool, device=dev)
    n_corr = torch.zeros(lead, dtype=I32, device=dev)
    iters = torch.zeros(lead, dtype=I32, device=dev)
    for _ in range(n_outer):
        fx, fy, fz = icp_ops.transform_soa(T_icp, px, py, pz)
        qf = torch.stack([fx.to(F32), fy.to(F32), fz.to(F32)], dim=-1)
        planes = _sharded_fetch(smap, qf, source_mask, cfg)
        for _ in range(n_inner):
            wx, wy, wz = icp_ops.transform_soa(T_icp, px, py, pz)
            tx, ty, tz, d2, found = _sharded_nn_from_candidates(
                planes, wx.to(F32), wy.to(F32), wz.to(F32), source_mask, shard0, group)
            estimate, nc, _, conv = icp_ops.gn_step(
                wx, wy, wz, tx, ty, tz, d2, found, max_d2, kernel_th,
                cfg.icp.min_correspondences, cfg.icp.max_step_norm,
                cfg.icp.estimation_threshold)
            active = ~converged
            T_icp = torch.where(active[..., None, None], lie.compose(estimate, T_icp), T_icp)
            n_corr = torch.where(active, nc, n_corr)
            iters = iters + active.to(I32)
            converged = converged | conv

    empty = _map_voxels(smap, lead, group) == 0
    return torch.where(empty[..., None, None], eye, T_icp), iters, n_corr


def _owned_cloud(g: voxel_map.GroupedCloud, keys, owner, shard_ids):
    """Each local shard's view of the grouped cloud: the rows of the groups
    it owns moved to the front in their order (a group's rows share their
    head's key and so its owner), the rest masked. The head-compacted
    insert reads group sizes from row spans, so the owned groups must be
    contiguous. Returns (cloud (..., D, M, ...), keys (..., D, M))."""
    lead = g.mask.shape[:-1]
    d, m = shard_ids.numel(), g.mask.shape[-1]
    own = g.mask.unsqueeze(-2) & (owner.unsqueeze(-2) == shard_ids[:, None])  # (..., D, M)
    row = torch.arange(m, dtype=I64, device=own.device)
    order = torch.sort(((~own).to(I64) << 32) | row, dim=-1).values & 0xFFFFFFFF

    def take(x):
        x = x.unsqueeze(len(lead)).expand(lead + (d,) + tuple(x.shape[len(lead):]))
        idx = order.reshape(order.shape + (1,) * (x.dim() - order.dim())).expand(x.shape)
        return torch.gather(x, len(lead) + 1, idx)

    n_own = own.sum(dim=-1)
    mask = row < n_own[..., None]
    head = take(g.head) & mask
    cloud = voxel_map.GroupedCloud(
        points=take(g.points),
        mask=mask,
        head=head,
        head_pos=torch.cummax(torch.where(head, row, torch.zeros_like(row)), -1).values.to(I32),
        rank=take(g.rank),
        n_unique=n_own.to(I32),
        window_drops=g.window_drops.unsqueeze(-1).expand(lead + (d,)),
    )
    return cloud, take(keys)


def register_frame(state: ShardedKissState, scan, cfg: PipelineConfig, n_shards: int,
                   n_outer: int = 2, n_inner: int = 4, mesh: Mesh | None = None,
                   axis: str = "mp"):
    """Map-sharded analog of kiss_icp.register_frame (JAX
    sharded_map.py:181): the same flow with the sharded NN and the
    owner-masked insert, no deskew. The state's map holds this rank's block
    of the `n_shards` shards of the mesh's `axis` (all of them without a
    mesh). State and scan may carry a leading stream axis. Returns (state',
    pose, metrics)."""
    dev = scan.xyz.device
    lead = scan.mask.shape[:-1]
    d_local = state.map.keys.shape[len(lead)]
    ranks = 1 if mesh is None else mesh.size(axis)
    if d_local * ranks != n_shards:
        raise ValueError(f"{d_local} local shards x {ranks} ranks is not {n_shards} shards")
    group = None if mesh is None else mesh.group(axis)
    shard0 = 0 if mesh is None else mesh.index(axis) * d_local

    init_guess = kiss_icp.constant_velocity_guess(state)
    tg = init_guess[..., :3, 3].to(F32)
    world = lie.rotate_points(init_guess[..., None, :3, :3], scan.xyz) + tg[..., None, :]
    g, source, source_mask, window_drops = kiss_icp.select_source(world, scan.mask, tg, cfg)
    thr_state, sigma = kiss_icp.adaptive_threshold(state, cfg)
    T_icp, iters, n_corr = _icp_sharded(
        state.map, source, source_mask, 3.0 * sigma, sigma / 3.0, cfg, n_outer, n_inner,
        shard0, group)
    new_pose, thr_state = kiss_icp.divergence_gate(init_guess, lie.compose(T_icp, init_guess),
                                                   thr_state, cfg)

    g_corr, pre_keys = kiss_icp.corrected_cloud(g, *kiss_icp.map_delta(new_pose, init_guess),
                                                cfg)
    shard_ids = shard0 + torch.arange(d_local, dtype=I32, device=dev)
    owned, owned_keys = _owned_cloud(g_corr, pre_keys, _owner(pre_keys, n_shards), shard_ids)
    new_map = voxel_map.insert_grouped(state.map, owned, cfg.map, keys=owned_keys)
    origin = new_pose[..., None, :3, 3].expand(lead + (d_local, 3))
    new_map = voxel_map.evict_far(new_map, origin, cfg.map, inplace=True)
    new_state = kiss_icp.next_state(state, new_map, new_pose, thr_state)
    counts = torch.stack([voxel_map.num_voxels(new_map).to(I64).sum(dim=-1),
                          new_map.drops.to(I64).sum(dim=-1)])
    counts = all_reduce(counts, dist.ReduceOp.SUM, group)
    metrics = {
        "icp_iterations": iters,
        "num_correspondences": n_corr,
        "map_voxels": counts[0].to(I32),
        "drops": counts[1].to(I32),
        "window_drops": window_drops,
    }
    return new_state, new_pose, metrics


# ---------------------------------------------------------------------------
# Combined scale axes: S streams x a map sharded D ways ((dp, mp) mesh)
# ---------------------------------------------------------------------------
#
# A (dp, mp) grid runs dp independent streams, each with an mp-way sharded
# map of mp * cfg.map.capacity slots. Per step the mp axis carries the NN
# winner reduction of every GN iteration ((S_local, N) i64 and (S_local, 3,
# N) i64, N = max_source_points); the dp axis carries nothing in the step.


def init_multi_state(cfg: PipelineConfig, n_streams: int, n_shards: int,
                     device: torch.device | str = "cuda") -> ShardedKissState:
    """(S, D, ...) map leaves; (S, ...) pose and threshold leaves."""
    return tree_map(lambda x: on_device(x.expand((n_streams,) + tuple(x.shape)), device),
                    init_state(cfg, n_shards, device))


def shard_multi_state(state: ShardedKissState, mesh: Mesh, dp: str = "dp",
                      mp: str = "mp") -> ShardedKissState:
    """Map leaves split (dp, mp), the per-stream leaves split (dp,)."""
    def streams(x):
        return slice(*mesh.block(dp, x.shape[0]))

    smap = tree_map(lambda x: on_device(x[streams(x), slice(*mesh.block(mp, x.shape[1]))],
                                        mesh.device), state.map)
    rest = tree_map(lambda x: on_device(x[streams(x)], mesh.device), tuple(state[1:]))
    return ShardedKissState(smap, *rest)


def batched_register_frame(states: ShardedKissState, scans, cfg: PipelineConfig,
                           n_shards: int, n_outer: int = 2, n_inner: int = 4,
                           mesh: Mesh | None = None, mp: str = "mp"):
    """The map-sharded step over a leading stream axis (the counterpart of
    JAX's `batched_register_frame_jit`, a vmap of `register_frame`): this
    rank's streams, each against its block of the mesh's `mp` axis."""
    return register_frame(states, scans, cfg, n_shards, n_outer, n_inner, mesh, mp)
