"""State carried across between the JAX package and the port.

The odometry state is the system's "weights": a JAX `KissState` (with its
`VoxelMap` and `ThresholdState`), once its leaves are converted to numpy
arrays, becomes the port's `KissState` on a device, and back. This module
takes and returns numpy only; it reads fields by name, so any object with
the JAX field names works (a NamedTuple of numpy arrays, for example).

Batched states (`parallel.streams`) carry a leading stream axis S on every
leaf, as the JAX package's `init_batched_state` makes them.

The LIO state (`models.lio.LioState`: the odometry state, the EKF state,
the IMU initialization and the LIO bookkeeping) and the IMU packet cross
the same way (`lio_state_from_numpy`, `lio_state_to_numpy`,
`imu_packet_from_numpy`). So does the backend's pose graph
(`models.backend.PoseGraph`: `pose_graph_from_numpy`, `pose_graph_to_numpy`),
and the sharded map's state (`parallel.sharded_map.ShardedKissState`: map
leaves with a leading shard axis D, or (S, D) for the multi-state;
`sharded_state_from_numpy`, `sharded_multi_state_from_numpy` and their
`_to_numpy` pairs).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ekf import EkfState, ImuPacket
from .models.kiss_icp import KissState
from .models.backend import PoseGraph
from .models.lio import LioState
from .ops.imu import ImuInitState
from .ops.icp import ThresholdState
from .ops.voxel_map import VoxelMap
from .parallel.mesh import on_device
from .parallel.sharded_map import ShardedKissState


def _t(a, device) -> torch.Tensor:
    """A copy of `a` on `device`, as the front view of a flat buffer with
    one spare element (the layout the map's in-place scatters reuse)."""
    return on_device(torch.from_numpy(np.array(a, copy=True)), device)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def kiss_state_from_numpy(tree, device: torch.device | str = "cuda") -> KissState:
    """Port state from the numpy leaves of a JAX KissState."""
    m, thr = tree.map, tree.threshold
    return KissState(
        map=VoxelMap(*(_t(getattr(m, f), device) for f in VoxelMap._fields)),
        pose=_t(tree.pose, device),
        pose_prev=_t(tree.pose_prev, device),
        first_pose=_t(tree.first_pose, device),
        num_poses=_t(tree.num_poses, device),
        threshold=ThresholdState(*(_t(getattr(thr, f), device)
                                   for f in ThresholdState._fields)),
    )


def kiss_state_to_numpy(state: KissState) -> KissState:
    """The port's state with numpy leaves, in the JAX field order (so
    `jax_kiss_icp.KissState(VoxelMap(*s.map), ..., ThresholdState(*s.threshold))`
    rebuilds the JAX state)."""
    return KissState(
        map=VoxelMap(*(_n(t) for t in state.map)),
        pose=_n(state.pose),
        pose_prev=_n(state.pose_prev),
        first_pose=_n(state.first_pose),
        num_poses=_n(state.num_poses),
        threshold=ThresholdState(*(_n(t) for t in state.threshold)),
    )


def _stream_count(tree) -> int:
    leaves = [getattr(tree.map, f) for f in VoxelMap._fields]
    leaves += [getattr(tree, f) for f in ("pose", "pose_prev", "first_pose", "num_poses")]
    s = {tuple(x.shape)[:1] for x in leaves}
    if len(s) != 1 or len(tree.num_poses.shape) != 1:
        raise ValueError(f"a batched state needs one leading stream axis on every leaf, "
                         f"got leading sizes {sorted(s)}")
    return s.pop()[0]


def batched_kiss_state_from_numpy(tree, device: torch.device | str = "cuda") -> KissState:
    """Port state from the numpy leaves of a JAX batched KissState (a
    leading stream axis S on every leaf, as `init_batched_state` makes)."""
    _stream_count(tree)
    return kiss_state_from_numpy(tree, device)


def batched_kiss_state_to_numpy(state: KissState) -> KissState:
    """The port's batched state with numpy leaves in the JAX field order."""
    _stream_count(state)
    return kiss_state_to_numpy(state)


def _plain(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), device=device)


def imu_packet_from_numpy(tree, device: torch.device | str = "cuda") -> ImuPacket:
    """Port IMU packet from the numpy leaves of a JAX ImuPacket."""
    return ImuPacket(*(_plain(getattr(tree, f), device) for f in ImuPacket._fields))


def lio_state_from_numpy(tree, device: torch.device | str = "cuda") -> LioState:
    """Port LIO state from the numpy leaves of a JAX LioState."""
    rest = {f: _plain(getattr(tree, f), device) for f in LioState._fields[3:]}
    return LioState(
        odo=kiss_state_from_numpy(tree.odo, device),
        ekf=EkfState(*(_plain(getattr(tree.ekf, f), device) for f in EkfState._fields)),
        imu_init=ImuInitState(*(_plain(getattr(tree.imu_init, f), device)
                                for f in ImuInitState._fields)),
        **rest,
    )


def lio_state_to_numpy(state: LioState) -> LioState:
    """The port's LIO state with numpy leaves, in the JAX field order."""
    return LioState(
        odo=kiss_state_to_numpy(state.odo),
        ekf=EkfState(*(_n(t) for t in state.ekf)),
        imu_init=ImuInitState(*(_n(t) for t in state.imu_init)),
        **{f: _n(getattr(state, f)) for f in LioState._fields[3:]},
    )


def pose_graph_from_numpy(tree, device: torch.device | str = "cuda") -> PoseGraph:
    """Port pose graph from the numpy leaves of a JAX PoseGraph (its counts
    become host ints)."""
    return PoseGraph(*(_plain(getattr(tree, f), device) for f in PoseGraph._fields[:7]),
                     num_nodes=int(tree.num_nodes), num_edges=int(tree.num_edges))


def pose_graph_to_numpy(g: PoseGraph) -> PoseGraph:
    """The port's pose graph with numpy leaves in the JAX field order (the
    counts as i32 scalars, as JAX keeps them)."""
    return PoseGraph(*(_n(getattr(g, f)) for f in PoseGraph._fields[:7]),
                     num_nodes=np.int32(g.num_nodes), num_edges=np.int32(g.num_edges))


def _sharded_lead(tree, n_lead: int) -> None:
    """Raise unless the map leaves carry `n_lead` + 1 leading axes (streams
    and shards) and the pose leaves `n_lead` (streams)."""
    keys, pose = tree.map.keys, tree.pose
    if len(keys.shape) != n_lead + 2 or len(pose.shape) != n_lead + 2 or (
            tuple(keys.shape)[:n_lead] != tuple(pose.shape)[:n_lead]):
        what = "(S, D) map and (S,) pose" if n_lead else "(D,) map and unbatched pose"
        raise ValueError(f"a sharded state needs {what} leading axes, got map keys "
                         f"{tuple(keys.shape)} and pose {tuple(pose.shape)}")


def sharded_state_from_numpy(tree, device: torch.device | str = "cuda") -> ShardedKissState:
    """Port sharded state from the numpy leaves of a JAX ShardedKissState
    (map leaves (D, ...), the rest unbatched), all on `device`."""
    _sharded_lead(tree, 0)
    return ShardedKissState(*kiss_state_from_numpy(tree, device))


def sharded_state_to_numpy(state: ShardedKissState) -> ShardedKissState:
    """The port's sharded state with numpy leaves in the JAX field order."""
    _sharded_lead(state, 0)
    return ShardedKissState(*kiss_state_to_numpy(state))


def sharded_multi_state_from_numpy(tree, device: torch.device | str = "cuda") -> ShardedKissState:
    """Port multi-state from the numpy leaves of a JAX `init_multi_state`
    (map leaves (S, D, ...), the rest (S, ...))."""
    _sharded_lead(tree, 1)
    return ShardedKissState(*kiss_state_from_numpy(tree, device))


def sharded_multi_state_to_numpy(state: ShardedKissState) -> ShardedKissState:
    """The port's multi-state with numpy leaves in the JAX field order."""
    _sharded_lead(state, 1)
    return ShardedKissState(*kiss_state_to_numpy(state))
