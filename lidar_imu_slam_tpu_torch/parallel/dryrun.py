"""Multi-device dry run: the three checks of the JAX package's
`__graft_entry__.dryrun_multichip` on the port's mesh.

    python -m lidar_imu_slam_tpu_torch.parallel.dryrun N [--world W]
        [--backend gloo|nccl] [--device cuda|cpu]

N is the logical device count of the JAX dry run: N streams, an N-way
sharded map and 2 streams x N/2 map shards. Without `--backend` one
process holds all of it on one device (no process group); with it,
W ranks (default N) are started by `spawn` over that backend, each with its
block of every axis. Rank 0 prints the JAX run's three lines, then the
backend, the world size and the ms of a step. Every world gives the same
numbers (poses bit for bit).

The stream check runs `streams.batch_config` of the tiny config: the port's
batched step is the fixed unroll (the JAX package vmaps its while loop).
"""

from __future__ import annotations

import argparse
import datetime
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import config as cfgmod
from ..host import synthetic
from ..ops import voxel_map
from ..ops.preprocess import Scan, pack_raw_scan, preprocess_scan
from . import mesh as mesh_mod
from . import sharded_map, streams

I64 = torch.int64


def tiny_cfg() -> cfgmod.PipelineConfig:
    """The dry run's configuration (`__graft_entry__._tiny_cfg`)."""
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20),
        ekf=cfgmod.EkfConfig(lidar_pose_trail=4),
        imu=cfgmod.ImuConfig(max_init_count=20, max_samples_per_scan=32),
    )


def example_scan(cfg: cfgmod.PipelineConfig, seed: int = 0,
                 device: torch.device | str = "cuda"):
    """The dry run's scan (`__graft_entry__._example_inputs`): 1,500 points
    of a seeded synthetic world seen from the origin."""
    world = synthetic.make_world(seed=seed, n_points=20000, extent=(20.0, 8.0, 4.0))
    pts = synthetic.render_scan(world, np.eye(4), 1500, 0.5, 30.0, seed=seed)
    raw = pack_raw_scan(pts, stamp=0.0, max_points=cfg.lidar.max_points, device=device)
    return preprocess_scan(raw, cfg.lidar)


def _stack(tree, n: int):
    return mesh_mod.tree_map(lambda x: x.expand((n,) + tuple(x.shape)), tree)


def _gather_rows(local: torch.Tensor, start: int, total: int, group) -> np.ndarray:
    """The (total, ...) array whose rows [start, start + len) are `local`,
    from every rank of `group`, bit for bit (an i64 SUM over zero rows)."""
    full = torch.zeros((total,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[start:start + local.shape[0]] = local
    bits = full.view(I64) if full.element_size() == 8 else full.to(I64)
    out = mesh_mod.all_reduce(bits, dist.ReduceOp.SUM, group)
    out = out.view(full.dtype) if full.element_size() == 8 else out.to(full.dtype)
    return out.cpu().numpy()


def _expect(cond: bool, what: str) -> None:
    """The dry run's checks (the JAX run asserts the same)."""
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _timed(fn, device):
    """fn() twice; returns (second result, its ms)."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def run(n_devices: int, device: torch.device | str = "cuda", seed: int = 0,
        quiet: bool = False) -> dict:
    """The three checks on every rank of the process group (one rank
    without one), each two steps from a fresh state; rank 0 prints. Returns
    the global results as numpy (the same on every rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 and not quiet else (lambda *a, **k: None)
    cfg = tiny_cfg()
    bcfg = streams.batch_config(cfg)

    # --- N streams over the dp axis --------------------------------------
    mesh = mesh_mod.stream_mesh(device=device)
    dev = mesh.device
    scan = example_scan(cfg, seed, dev)
    n_streams = n_devices
    scans = mesh_mod.shard_streams(_stack(scan, n_streams), mesh)
    step = mesh_mod.sharded_multistream_step(mesh, bcfg)

    def streams_run():
        states = streams.init_batched_state(bcfg, scans.mask.shape[0], dev)
        states, poses, metrics = step(states, scans)
        return step(states, scans)

    (_, poses, metrics), ms_streams = _timed(streams_run, dev)
    start = mesh.block("dp", n_streams)[0]
    poses = _gather_rows(poses, start, n_streams, mesh.group("dp"))
    metrics = {k: v.item() for k, v in metrics._asdict().items()}
    _expect(poses.shape == (n_streams, 4, 4) and np.isfinite(poses).all()
            and np.isfinite(metrics["mean_residual_rms"])
            and metrics["total_correspondences"] > 0, "streams: a pose or metric is off")
    say(f"dryrun_multichip OK: {n_devices} devices, {n_streams} streams, metrics={metrics}")

    # --- one stream, its map sharded over the mp axis ---------------------
    mp_mesh = mesh_mod.stream_mesh(axis="mp", device=device)

    def sharded_run():
        st = sharded_map.shard_state(sharded_map.init_state(cfg, n_devices, dev), mp_mesh)
        for _ in range(2):
            st, pose, m = sharded_map.register_frame(st, scan, cfg, n_devices, mesh=mp_mesh)
        return pose, m

    (spose, smetrics), ms_sharded = _timed(sharded_run, dev)
    smetrics = {k: int(v) for k, v in smetrics.items()}
    spose = spose.cpu().numpy()
    _expect(np.isfinite(spose).all() and smetrics["map_voxels"] > 0,
            "sharded map: a non-finite pose or an empty map")
    say(f"dryrun_multichip sharded-map OK: {n_devices} shards, "
        f"voxels={smetrics['map_voxels']}, corr={smetrics['num_correspondences']}")
    out = dict(poses=poses, metrics=metrics, sharded_pose=spose, sharded_metrics=smetrics,
               ms={"streams": ms_streams, "sharded": ms_sharded})

    # --- dp streams x mp-sharded maps on a 2-D mesh ------------------------
    if n_devices >= 4:
        dp, mp = 2, n_devices // 2
        dp_ranks = 2 if world % 2 == 0 else 1
        grid = mesh_mod.grid_mesh(dp_ranks, world // dp_ranks, device=device)
        mscans = mesh_mod.shard_streams(_stack(scan, dp), grid, "dp")

        def combined_run():
            st = sharded_map.shard_multi_state(sharded_map.init_multi_state(cfg, dp, mp, dev),
                                               grid)
            for _ in range(2):
                st, p, m = sharded_map.batched_register_frame(st, mscans, cfg, mp, mesh=grid)
            return p, m

        (mposes, mmetrics), ms_combined = _timed(combined_run, dev)
        start = grid.block("dp", dp)[0]
        mposes = _gather_rows(mposes, start, dp, grid.group("dp"))
        voxels = _gather_rows(mmetrics["map_voxels"], start, dp, grid.group("dp"))
        _expect(mposes.shape == (dp, 4, 4) and np.isfinite(mposes).all() and voxels.sum() > 0,
                "combined: a non-finite pose or an empty map")
        say(f"dryrun_multichip combined OK: {dp} streams x {mp} map shards, "
            f"voxels/stream={voxels.tolist()}")
        out.update(combined_poses=mposes, combined_voxels=voxels.tolist())
        out["ms"]["combined"] = ms_combined

    # replicated results agree on every rank (and the backend ran a collective)
    if dist.is_initialized():
        bits = torch.from_numpy(spose).view(I64).to(dev)
        lo, hi = bits.clone(), bits.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        _expect(torch.equal(lo, hi), "the ranks' sharded-map poses differ")
    backend = dist.get_backend() if dist.is_initialized() else "none"
    say(f"dryrun: backend {backend}, world {world}, device {dev}: ms a step "
        + "  ".join(f"{k} {v / 2:.3f}" for k, v in out["ms"].items()))
    return out


# ---------------------------------------------------------------------------
# drives on any world (what the tests hold world N against world 1 with)
# ---------------------------------------------------------------------------


def _scan_on(arrays, device) -> Scan:
    return Scan(*(torch.as_tensor(a).to(device) for a in arrays))


def drive_sharded(cfg: cfgmod.PipelineConfig, scans, n_shards: int,
                  device: torch.device | str = "cuda") -> dict:
    """One stream over `scans` (each a Scan's fields as numpy) with its map
    sharded `n_shards` ways over every rank of the process group. Returns
    numpy poses (T, 4, 4), the metrics per scan and this rank's per-shard
    voxel counts per scan (T, D_local)."""
    mesh = mesh_mod.stream_mesh(axis="mp", device=device)
    state = sharded_map.shard_state(sharded_map.init_state(cfg, n_shards, mesh.device), mesh)
    poses, metrics, voxels = [], [], []
    for arrays in scans:
        state, pose, m = sharded_map.register_frame(state, _scan_on(arrays, mesh.device), cfg,
                                                    n_shards, mesh=mesh)
        poses.append(pose)
        metrics.append({k: int(v) for k, v in m.items()})
        voxels.append(voxel_map.num_voxels(state.map))
    return dict(poses=torch.stack(poses).cpu().numpy(), metrics=metrics,
                shard_voxels=torch.stack(voxels).cpu().numpy())


def drive_streams(cfg: cfgmod.PipelineConfig, steps, device: torch.device | str = "cuda") -> dict:
    """`sharded_multistream_step` over `steps` (each a batched Scan's fields
    as numpy, leading S) with the streams split over every rank. Returns
    this rank's first stream index, its poses (T, S_local, 4, 4) and the
    global metrics per step."""
    mesh = mesh_mod.stream_mesh(device=device)
    step = mesh_mod.sharded_multistream_step(mesh, cfg)
    states, poses, metrics = None, [], []
    for arrays in steps:
        scans = mesh_mod.shard_streams(_scan_on(arrays, "cpu"), mesh)
        if states is None:
            states = streams.init_batched_state(cfg, scans.mask.shape[0], mesh.device)
        states, p, m = step(states, scans)
        poses.append(p)
        metrics.append({k: v.item() for k, v in m._asdict().items()})
    return dict(start=mesh.block("dp", steps[0][0].shape[0])[0],
                poses=torch.stack(poses).cpu().numpy(), metrics=metrics)


def mesh_layout(dp: int, mp: int, device: torch.device | str = "cuda") -> dict:
    """This rank's coordinates on a (dp, mp) `grid_mesh` and the ranks of
    its two axis groups."""
    grid = mesh_mod.grid_mesh(dp, mp, device=device)
    rank = dist.get_rank() if dist.is_initialized() else 0

    def ranks(g):
        return [rank] if g is None else dist.get_process_group_ranks(g)

    return dict(coords=grid.coords, dp=ranks(grid.group("dp")), mp=ranks(grid.group("mp")))


# ---------------------------------------------------------------------------
# process start
# ---------------------------------------------------------------------------


def _rank_main(rank, world, backend, init_method, timeout_s, fn, args, results):
    torch.set_num_threads(1)
    try:
        device = args[1] if len(args) > 1 else None
        if backend == "nccl" and device is not None:
            d = torch.device(device)
            torch.cuda.set_device(d if d.index is not None
                                  else rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))  # for the parent's error
        raise


def spawn(world: int, fn, args: tuple = (), backend: str = "gloo",
          timeout_s: float = 300.0) -> list:
    """Run fn(*args) on `world` ranks, each a process started with
    torch.multiprocessing "spawn", joined by a `file://` rendezvous in a
    temporary directory (no TCP port) over `backend`. `fn` must be
    importable by the children (a module-level function of the port); when
    args[1] is a CUDA device and the backend is NCCL, each rank first
    selects its card as `mesh.stream_mesh` does. A rank that fails, or any
    rank still running after `timeout_s` (the process group's timeout too),
    fails the call: the others are killed. Returns the ranks' results in
    rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="lis_dist_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, init_method, timeout_s, fn, args, results))
             for r in range(world)]
    out, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world - len(out)} of {world} ranks did not finish in "
                                   f"{timeout_s:.0f} s")
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [p.pid for p in procs if p.exitcode not in (None, 0)]
                if dead and not errors:
                    errors.append(f"ranks with pids {dead} died without a result")
                    break
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
        if errors:
            raise RuntimeError("spawned ranks failed: " + "\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Multi-device dry run of the port.")
    ap.add_argument("n_devices", type=int, help="logical devices: streams and map shards")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: n_devices with --backend, else one process)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend; without it, no process group")
    ap.add_argument("--device", default="cuda", help="'cuda', 'cuda:K' or 'cpu'")
    args = ap.parse_args(argv)
    if args.backend is None:
        if args.world not in (None, 1):
            ap.error("--world above 1 needs --backend")
        run(args.n_devices, args.device)
        return 0
    world = args.world or args.n_devices
    spawn(world, run, (args.n_devices, args.device), backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
