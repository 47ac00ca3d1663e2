"""Device mesh over `torch.distributed` (counterpart of the JAX package's
`parallel/mesh.py`).

JAX runs one controller: a `NamedSharding` places a leading axis over the
devices and GSPMD inserts the collectives, so its numbers do not depend on
the device count. The port keeps that property with explicit leading axes
and explicit collectives:

* one process per device (SPMD). A `Mesh` names its axes, their sizes,
  this rank's coordinates, one process group per axis (None where the axis
  has one rank) and this rank's device. Ranks are laid out row-major over
  the axes, as `grid_mesh` reshapes the device list in the JAX package;
* each rank holds a contiguous block of a sharded leading axis on its own
  device (`shard_streams`, `sharded_map.shard_state`);
* world size 1 is no process group at all: the whole axis lives on one
  device and every collective is skipped. Every larger world gives the
  same poses bit for bit (tests/test_torch_mesh.py,
  test_torch_sharded_map.py).

The backend is the caller's choice and is never switched here: NCCL with
one rank per card, gloo for CPU ranks, gloo for several ranks that share
one card (gloo reduces CUDA tensors through host copies, so those
collectives synchronize with the host; NCCL refuses two ranks on one card).
An unsupported backend / device pair raises when the mesh is built.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..ops.preprocess import Scan
from . import streams


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: tuple[str, ...]
    shape: tuple[int, ...]
    coords: tuple[int, ...]  # this rank's position on each axis
    groups: tuple  # a ProcessGroup per axis, None where the axis has one rank
    device: torch.device

    def _at(self, axis: str) -> int:
        if axis not in self.axes:
            raise ValueError(f"mesh axes {self.axes} have no axis {axis!r}")
        return self.axes.index(axis)

    def size(self, axis: str) -> int:
        return self.shape[self._at(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self._at(axis)]

    def group(self, axis: str):
        return self.groups[self._at(axis)]

    def block(self, axis: str, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's contiguous block of an n-long axis."""
        size = self.size(axis)
        if n % size:
            raise ValueError(f"an axis of {n} does not split over {size} ranks of {axis!r}")
        per = n // size
        return self.index(axis) * per, (self.index(axis) + 1) * per


def _world() -> tuple[int, int, str | None]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def _rank_device(device, world: int, rank: int, backend: str | None) -> torch.device:
    """This rank's device: "cuda" puts rank r on card r mod the card count,
    "cuda:k" puts every rank on card k. Raises on a pair the backend does
    not support; never picks another device or backend."""
    d = torch.device(device)
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the mesh runs nccl or gloo")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu', not {device!r}")
    if backend == "nccl" and d.type == "cpu":
        raise ValueError("nccl reduces CUDA tensors only: run gloo for CPU ranks")
    if backend == "nccl" and world > 1 and d.index is not None:
        raise ValueError(f"nccl needs one rank per card, got {world} ranks on {device!r}: "
                         f"NCCL refuses two ranks on one card; run gloo for ranks that "
                         f"share a card")
    if d.type == "cpu":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {device!r} needs a CUDA card; this process has none")
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and world > n_cards:
        raise ValueError(f"nccl needs one rank per card, got {world} ranks on {n_cards} "
                         f"cards; run gloo for ranks that share a card")
    return d if d.index is not None else torch.device("cuda", rank % n_cards)


def _make_mesh(axes: tuple[str, ...], shape: tuple[int, ...], device) -> Mesh:
    world, rank, backend = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {math.prod(shape)} ranks, the "
                         f"process group has {world}" + ("" if backend else " (none initialized)"))
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    ids = np.arange(world).reshape(shape)  # row-major rank layout
    groups = []
    for a, size in enumerate(shape):
        if size == 1:
            groups.append(None)
            continue
        if size == world:
            groups.append(dist.group.WORLD)
            continue
        # every rank creates every group of the axis, in the same order
        lines = np.moveaxis(ids, a, -1).reshape(-1, size)
        made = [dist.new_group(line.tolist()) for line in lines]
        groups.append(next(g for g, line in zip(made, lines) if rank in line))
    return Mesh(axes, shape, coords, tuple(groups), _rank_device(device, world, rank, backend))


def stream_mesh(world: int | None = None, axis: str = "dp",
                device: torch.device | str = "cuda") -> Mesh:
    """A 1-D mesh over every rank of the process group (one rank without
    one). `world`, when given, must be the group's size."""
    n = _world()[0] if world is None else world
    return _make_mesh((axis,), (n,), device)


def grid_mesh(dp: int, mp: int, axes=("dp", "mp"),
              device: torch.device | str = "cuda") -> Mesh:
    """2-D mesh for the combined scale axes: `dp` independent SLAM streams,
    each stream's voxel map sharded over `mp` ranks (parallel/sharded_map.py).
    Rank r sits at (r // mp, r % mp). Lay dp over the slower interconnect
    and mp over the faster one: the map axis carries the cross-shard NN
    reduction of every GN iteration, the stream axis only metric
    reductions."""
    return _make_mesh(tuple(axes), (dp, mp), device)


def on_device(x: torch.Tensor, device) -> torch.Tensor:
    """A copy of `x` on `device`, as the front view of a flat buffer with
    one spare element (the layout the map's in-place scatters reuse)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
    buf[:-1].copy_(x.reshape(-1))
    return buf[:-1].view(x.shape)


def tree_map(fn, tree):
    """`fn` on every tensor leaf of nested NamedTuples / tuples / lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if tree is None:
        return None
    raise TypeError(f"not a tensor tree leaf: {type(tree).__name__}")


def shard_streams(tree, mesh: Mesh, axis: str = "dp"):
    """This rank's block of the leading (stream) axis of every leaf, on the
    mesh's device."""
    return tree_map(lambda x: on_device(x[slice(*mesh.block(axis, x.shape[0]))], mesh.device),
                    tree)


class GlobalMetrics(NamedTuple):
    mean_residual_rms: torch.Tensor  # () f64 — all-reduced across the mesh
    total_correspondences: torch.Tensor  # () i64
    max_icp_iterations: torch.Tensor  # () i32
    mean_map_voxels: torch.Tensor  # () f64


def all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """`t` reduced over `group` in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(t, op=op, group=group)
    return t


def _step_with_metrics(states, scans: Scan, cfg: PipelineConfig, mesh: Mesh, axis: str):
    states, outs = streams.batched_register_frame(states, scans, cfg)
    group = mesh.group(axis)
    n_streams = outs.pose.shape[0] * mesh.size(axis)
    f64 = all_reduce(torch.stack([outs.residual_rms.sum(),
                                  outs.map_voxels.to(torch.float64).sum()]),
                     dist.ReduceOp.SUM, group)
    corr = all_reduce(outs.num_correspondences.to(torch.int64).sum(), dist.ReduceOp.SUM, group)
    iters = all_reduce(outs.icp_iterations.amax(), dist.ReduceOp.MAX, group)
    metrics = GlobalMetrics(
        mean_residual_rms=f64[0] / n_streams,
        total_correspondences=corr,
        max_icp_iterations=iters,
        mean_map_voxels=f64[1] / n_streams,
    )
    return states, outs.pose, metrics


def sharded_multistream_step(mesh: Mesh, cfg: PipelineConfig, axis: str = "dp"):
    """The multi-stream step over the mesh's `axis`: each rank registers its
    block of streams (`streams.batched_register_frame`; kernel K5 with
    gn_backend="pallas") and the metrics are reduced over the axis. Use:

        mesh = stream_mesh()
        states = shard_streams(streams.init_batched_state(cfg, S, "cpu"), mesh)
        step = sharded_multistream_step(mesh, cfg)
        states, poses, metrics = step(states, shard_streams(scans, mesh))

    Returns (local states', local poses (S_local, 4, 4), GlobalMetrics)."""
    def step(states, scans):
        return _step_with_metrics(states, scans, cfg, mesh, axis)

    return step
