"""Smoke run of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this checkout (it drives
`lidar_imu_slam_tpu_torch`, never JAX). Phases, each fatal on failure:

1. the card: name and power limit (nvidia-smi);
2. build: every kernel compiled by nvcc from `lidar_imu_slam_tpu_torch/csrc`
   (one nvcc per source, all started together);
3. kernels: K1 `fused_gn_carry`, K2 `pose_pre` and K3 `pose_post` held
   against their plain PyTorch versions on the card at main-path shapes
   (K1: N = 4096 queries x NC = 80 candidate slots from seeded synthetic
   geometry; K2 / K3: a seeded 5-pose state), each timed beside its plain
   version with CUDA events. The GN cluster and spread kernels' ptxas
   registers and spills, K1's launch shape (one cluster of C CTAs a
   stream, at least 8 at N = 4096, never spread there), a repeated launch
   bit-equal, and K1 timed at cluster sizes 4, 8 and 16 and spread over G
   clusters of C (SPREAD_SWEEP; a shape the card cannot hold at once must
   raise before it launches); the same at the kitti_64beam preset's 8192
   source points, where K1 spreads over several clusters.
   K2 and K3 also on device (launches queued behind a stream sleep) and
   host (enqueue clock) beside the launch floor (an empty one-block
   launch), and on every branch case of tools/pose_chain_cases.py, every
   output (row and epilogue) within 1e-9 of the plain version;
4. batched kernels: K4 `fused_gn` (one stream, 4096 x 80) and K5
   `fused_gn_batched` at both batched deployments' shapes (8 streams x
   4096 queries x 80 slots; 256 x 512 x 16), held against their plain
   versions per stream and timed beside them; each launch's cluster shape,
   a repeated launch bit-equal, K5 timed at cluster sizes 4, 8 and 16 (8
   streams) and 1, 2 and 4 (256 streams);
4b. the ICP candidate fetch kernel (`csrc/candidate_fetch.cu`): its planes
   bit-equal to the plain version's (+inf included) and a repeated launch
   bit-equal on every case of tools/fetch_cases.py (batched at 8192 and
   16,384 queries a stream, one stream, NB 27, Kp 4 and 5, a third masked,
   an empty map, an f32 anchor, wrapped keys 300 m out), then at the
   benchmark cells' shapes (128 x 8192, 64 x 16,384; each stream's map
   about the cell's live voxels; and 128 x 8192 at NB 27) bit-equal and
   timed (kernel per call and device, the path's fetch with its anchor
   terms, the plain version) beside its bound by bytes;
4c. the IMU deskew kernel (`csrc/imu_deskew.cu`): its points bit-equal to
   the plain per-point pass's and a repeated launch bit-equal on every case
   of tools/deskew_cases.py (64 x 16,384 points of the LIO ensemble's
   drive, no stream axis, masked NaN points, times on an offset or past
   the last one, a three-sample packet, the small-angle branch, the LIO
   slice's 131,072 points and 17-entry trail), then at
   the LIO ensemble's 4096 x 16,384 bit-equal and timed (kernel per call
   and device, the plain version) beside its bound by bytes;
5. K6 `nn_bruteforce` at the classic path's shape (4096 queries x a
   1,310,720-entry pool, ~30% +inf, 256 exact ties) and on every
   adversarial case of tools/nn_cases.py at that shape: indices and d^2
   equal to the plain version's bit for bit, a repeated launch bit-equal,
   timed (per call, device, host) beside the plain version and the
   `torch.cdist` + min yardstick, and at slice lengths 4096, 8192, 16384,
   with the SM clock and power draw sampled while it runs;
5b. probes: the tools/ probes P1-P4 through the port's probe entry point
   (`python -m lidar_imu_slam_tpu_torch.tools.probes all`) at the probes'
   own shapes — that run's counts are the probe kernels' launches. Its
   rows hold `take_rows` (P1, P4 f32 W = 128 and 512, P4 i32 broadcast)
   and `take_lanes` (P2) bit-equal to their plain versions and `gn_proto`
   (P3, 4096 x 80 x 8 iterations, one cluster of 16 CTAs: its ptxas
   registers and spills, a repeated launch bit-equal, device times at
   cluster sizes 4, 8 and 16 and at 0, 1 and 8 iterations) within GN_TOL
   with an equal conv, each
   timed beside its plain version and (gathers) the PyTorch library call
   that computes the same function: per call (CUDA events over back-to-back
   calls), on the device (calls queued behind a stream sleep) and on the
   host (enqueue time), for the kernel and for the library call alike;
6. small drives: 5 scans of a small configuration on the card and on the
   CPU, fast path (kernels; candidates from the packed slab, and with
   packed_nn=False from the f32 point slab) and classic f64 path
   (gn_backend="xla"), and
   3 classic streams x 5 scans under `batch_config` — poses must agree;
   then the tiny LIO deployment (`__graft_entry__._tiny_cfg`) over 8 scans
   on both registration branches, static init completing at scan 1 —
   poses must agree;
7. slice: the HDL-64E-scale deployment (131,072-point rolling-shutter
   scans at 8 m/s, 1 m voxels, a 2^17-slot packed map, 8-voxel
   neighbourhood, CV deskew, fused ICP), 120 scans through
   `register_frame_step` with eviction / conditional compaction every 10
   scans. Host reads per scan by call site and aten ops dispatched per
   scan, over scans 0-19. Launch counters are zeroed just before the timed
   run and read just after: every kernel must have run, K2 and K3 once per
   scan. Poses must be finite and the ATE (mid-scan convention) at most
   0.12 m;
8. classic slice: bench.py's f64 anchor (mode 5: the same deployment with
   gn_backend="xla", so the f32 point slab) on the same 120 scans — ATE at
   most 0.12 m, host reads per scan counted, no kernel launched;
8b. LIO slice: bench.py:_bench_lio's deployment (the fast config with a
   16-sample IMU packet, a 2-pose EKF trail, ICP-tuned pose noise) on the
   same 120 scans with 100 Hz IMU packets of the trajectory, through
   `lio.step_donated`, eviction / compaction every 10 scans. Host reads
   per scan over scans 0-19 by call site and ops dispatched per scan;
   launch counters zeroed just
   before the timed run: K2 and K3 once per scan, K1 launched, the IMU
   deskew kernel once per IMU-branch scan. Poses
   finite, `used_imu` on every scan after static init, ATE at the scan end
   at most LIO_ATE_LIMIT_M; then the drive again up to two IMU-branch
   scans, each scan's deskew kernel output bit-equal to the plain
   per-point pass on the same inputs;
9. K6 on its path: the classic map's pool queried with the last scan's
   keypoints, against the plain version and the hash fetch
   `voxel_map.nearest_neighbors` (never farther; equal wherever the hash
   searched K6's winning voxel); then adversarial queries on the same
   pool (on live entries, at midpoints, 1e4 m away, not finite) against
   the plain version;
10. small batched drive: 3 streams x 5 small scans under `batch_config` on
   the card and on the CPU, and 5 scans of one stream through
   `register_frame` under `batch_config` (kernel K4, counted) — poses must
   agree; the same again with packed_nn=False (the f32-slab fetch);
11. multi-stream: the deployment of bench.py:_bench_batched_chained — the
   HDL-64E config under `batch_config` (2 x 4 unroll), 8 streams x 60
   scans of the slice's drive, stream s at step i on scan min(i + s, 59).
   Every pose finite, stream 0's ATE at most 0.12 m, K5 launched exactly
   2 x 60 times and K1-K3 never;
12. Monte-Carlo: the deployment of bench.py:_bench_monte_carlo — 256
   perturbed VLP-16 streams (sigma 0.01 m), 2 warm + 20 timed steps;
   every stream must end within 0.5 m of the ground truth
   (tracking_frac 1.0).
13. runner: `host/runner.OdometryRunner(cfg, device).run` over the same
   120 scans as host messages (xyz, per-point time, stamp), under the
   deployment's own in-step eviction and `auto_rebuild`: poses and
   metrics bit-equal to a hand loop that makes the same calls and copies
   each scan's outputs at once; ATE (mid-scan) at most 0.12 m; scans/s,
   the StepTimer's p50 / p95 and host reads per scan by call site over the
   whole run; K2 and K3 once a scan, K1 launched (counters zeroed just
   before the run); the runner layer's own times (pack + upload +
   preprocess on the worker, host and device; the time outside the step;
   the final fetch); the hand loop's rate. Then in two turns the runner
   as it is, with the upload from pageable memory, with the pack on the
   main thread, and without the in-step eviction and compaction check,
   beside the direct loop's p50 of phase 7;
14. LIO runner: `LioRunner(lio_cfg, device).run_lio` on the same scans
   with the 100 Hz IMU stream as rows: bit-equal to its hand loop, scan-end
   ATE at most LIO_ATE_LIMIT_M, `used_imu` on every scan after static
   init, `imu_overflow` 0, the same numbers and launch checks, beside
   phase 8b's direct loop;
15. CLI: `python -m lidar_imu_slam_tpu_torch.cli --synthetic 40` (the
   `kitti` preset: 131,072 points, a 2^18-slot map, the fast path) with
   the trajectory, metrics and clouds written: exit 0, 40 poses and
   records, ATE at most 0.12 m, the PLY files finite; then `--bag --lio`
   on a bag of 30 HDL-64E scans and their IMU (`tools/bag_writer.py`):
   exit 0, one pose a scan. Each with its seconds.
16. backend: the loop-closure backend at full width — `config.kitti_64beam()`
   (131,072-point scans, a 2^18-slot map with the f32 slab, the fast path
   K1-K3) with `BackendConfig(enabled=True)` at its defaults (512
   keyframes, 2048 edges, `auto` -> cg) but the verify thresholds (0.65 m,
   150 correspondences: the defaults verified no loop here) — through
   `OdometryRunner(cfg, device).run` over one closed circuit of 200
   rolling-shutter HDL-64E scans (4 m/s, a ~12.7 m radius): the raw poses
   bit-equal to the same runner without the backend, K2 / K3 once a scan,
   K1 launched; at least one verified loop edge, `optimized_poses()`
   finite, its mid-scan ATE at most 1.05 x the raw one + 1e-6; keyframes,
   loop edges, optimizations, thin events, host reads per scan by call
   site, each optimize()'s and each verification's host time. The
   backend's last graph re-optimized with cg and dense on the card and on
   the CPU (within 1e-8 m / rad), twice on the card (bit-equal, or the
   difference printed), and the host reads of one optimize() counted;
17. solvers: dense LM on a 128-keyframe loop (H 768 x 768 f64) and cg on
   tests/test_backend_scale.py's 500-node double loop (512 / 1024), on the
   card and on the CPU: graph_error < 1e-6, card vs CPU within 1e-8; host
   clock, CUDA events and peak memory per call;
18. oracle: tests/test_torch_classic.py's oracle drive (52 scans) on the
   card through the classic f64 path against the port's numpy oracle copy
   (`match_jax`): scans 0-7 under 1e-4 m / rad, max 5e-2 m, median 1e-3 m;
19. profiling: `utils/profiling.device_trace` round three scans of the
   phase-16 runner: the trace names the fast path's kernels (K1, K2, K3)
   and the port's own spans (`kiss_icp.step` holding deskew, downsample,
   source, `icp.register` with its fetches and GN calls, insert, evict;
   `backend.optimize`), each step span holds its children, and the span
   gate reads true under `emit_nvtx`;
20. native: `host/native.py` builds (g++), packs three of the circuit's
   scans like `preprocess_scan` on the card (masks equal, xyz 1e-6, rel_t
   1e-9 + 1e-7 relative, test_native.py's bar), keeps the first point of a
   voxel; its host time beside phase
   13's pack;
21. CLI: `--synthetic 40 --loop-closure` on the `kitti` preset: exit 0,
   `<out>.optimized` with 40 poses.
22. multi-device (`parallel/mesh.py`, `sharded_map.py`, `dryrun.py`; run
   right after phase 11, on the slice's 120 scans): (a) the map sharded 4
   ways (2^15 slots each) at world 1 through `sharded_map.register_frame`
   against the single-map control at 2^17 through `kiss_icp.register_frame`,
   both the classic deployment (f32 slab) under `batch_config` without
   deskew: drops and window drops 0, every position within 1e-6 m of the
   control's, every shard holding voxels and the largest under 3x the
   smallest, ATE beside the control's, ms a scan, host reads a scan, peak
   memory, no kernel launched; (b) phase 11's 8 streams through
   `mesh.sharded_multistream_step` at world 1 for 10 steps: poses
   bit-equal to `batched_register_frame_step`, GlobalMetrics equal to its
   outputs' reduction, K5 exactly 2 x 10 launches; (c) 2 streams x 4 shards
   for 10 scans, each stream within 1e-9 m of the single sharded run on its
   scans; (d) `dryrun` at the tiny config in processes (`dryrun.spawn`):
   world 2 over gloo with both ranks on one card and world 1 over NCCL
   (and NCCL with one rank per card where there are two cards), each
   bit-equal to world 1 without a process group, with JAX's counts (4080,
   927 / 510, [927, 927]).
23. dense solid-state (run right after phase 7): `config.livox_dense()`
   (BASELINE.json config 4: 262,144-point scans, the packed-sort budget
   2^18, 6 lines, 5-100 m, no per-point time, no deskew, a 2^18-slot map
   with the f32 slab, 65,536 map / 16,384 source points, in-step eviction
   and compaction check, the fast path K1-K3) on tests/test_livox.py's
   world and trajectory over 60 scans (24 m), each rendered at exactly
   262,144 points. (a) `register_frame_step` on the uploaded scans: drops
   and window drops 0, more than 1,000 correspondences on every scan after
   scan 0, every position within 0.3 m of the truth, ATE printed; K1, K2
   and K3 launches (counters zeroed just before the run; K1 launched, K2 /
   K3 once a scan); scans/s, p50 / p95 ms a scan (CUDA events round
   preprocess + step), host reads by call site and aten ops a scan over
   scans 0-19, peak memory, final map voxels. (b) The first 6 scans on the
   card and on the CPU: scan 0's map bit-equal, poses within 1e-4. (c) K1
   at 16,384 x 80 on the inputs of scan 5's first ICP round (captured in
   (b)): spread over G > 1 clusters (its G, C, queries a CTA, dynamic
   shared memory, registers and spills, and the clusters the card holds
   at once printed), within 1e-5 rad / 1e-4 m of its plain version, a
   repeated launch bit-equal, ms per call and on the device with its
   iteration count and bound, and the same sweep as phase 3; every K1
   launch of (a) spread (kernel `gn_spread` in the JSON line). (d)
   `OdometryRunner(cfg, device).run` on the scans as host messages:
   bit-equal to (a)'s loop; scans/s, host reads a scan.
One step of each batched drive (and of the sharded map and the stream
mesh) runs under
`torch.cuda.set_sync_debug_mode("error")`: the batched step never waits
for the device.

Prints one JSON line with the kernels' numbers, then, as the very last
line, {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA card or any phase fails.

    python3 chip_smoke.py --measure ROOT
    python3 chip_smoke.py --turns PARENT
    python3 chip_smoke.py --dryrun-only

`--measure` runs only K1's checks, K2's, K3's, K6's and gn_proto's times
(per call, device, host), the fast and LIO slices and phase 23's dense
drive, on the package of the checkout ROOT, and ends with one line
`MEASURE {json}`. `--turns` runs `--measure` on the checkout PARENT (a
`git archive` of an earlier commit, say) and on this one in turns —
parent, change, change, parent, each in a process of its own — and sets
their numbers side by side. `--dryrun-only` runs only phase 22 (d), the
dry run in processes (on four cards, NCCL with one rank per card too).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
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
K6_QUERIES = 4096  # the classic path's max_source_points
K6_POOL = (1 << 17) * 10  # capacity x points per voxel of the classic map
LIO_ATE_LIMIT_M = 0.30  # scan-end ATE of the LIO slice (JAX: 0.2075, BENCH_r05)
LIO_IMU_CAP = 16  # bench.py:_bench_lio's packet budget
PROBE_REPLACES = {  # the tools/ Pallas probes each probe kernel ports
    "take_rows": "tools/exp_pallas.py:52 (P1), tools/exp_gather2.py:34 (P4)",
    "take_lanes": "tools/exp_pallas.py:79 (P2)",
    "gn_proto": "tools/exp_pallas.py:296 (P3, _gn_kernel :114)",
}
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM3 rate and the
# f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def _bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: bytes at the memory rate or f32
    operations at the non-tensor-core peak, whichever is longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _gn_bound(q, qmask, cand, scal, rows, carry=None):
    """K1 / K4 / K5: every input read once, the rows written once; per GN
    iteration a stream runs, each query's 8 f32 operations per candidate
    slot (d^2) plus ~40 for its transform, residual and weight."""
    rows2 = rows.reshape(-1, 16)
    n, nc = q.shape[-1], cand.shape[-2]
    iters = float(rows2[:, 14].sum())
    extra = (carry,) if carry is not None else ()
    return _bound_ms(_nbytes(q, qmask, cand, scal, rows, *extra), iters * n * (8.0 * nc + 40.0))


def _ptxas_lines(entry: str) -> list[str]:
    """ptxas' register and spill lines of the kernel whose mangled name
    holds `entry`, from the build's nvcc log."""
    from lidar_imu_slam_tpu_torch.ops.kernels import _build

    path = os.path.join(_build.BUILD_DIR, f"nvcc_{_build.source_hash()}.log")
    lines, inside = [], False
    with open(path) as f:
        for line in f:
            if "Compiling entry" in line:
                inside = entry in line
            elif inside and ("registers" in line or "spill" in line):
                lines.append(line.strip())
    return lines


def _gn_cluster(what, n, nc, streams=1) -> dict:
    """Print and check one GN launch's shape: G clusters of C CTAs a
    stream of n queries x nc slots (G = 1: the cluster kernel, streams x C
    CTAs in all; G > 1: the spread kernel, one stream), at most `per`
    queries a CTA, its dynamic shared memory and the clusters the card
    holds at once. Returns them."""
    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn

    dev = torch.device("cuda", torch.cuda.current_device())
    g, c, per, resident = (icp_gn.device_shape(n, nc, dev) if streams == 1
                           else (1, *icp_gn.launch_shape(n, nc), False))
    if g == 1:
        smem, active = 0, icp_gn.max_active_clusters(c)
        print(f"{what}: G = 1 cluster of C = {c} CTAs x {per} queries per stream, "
              f"{streams * c} CTAs in total (the cluster kernel); {active} clusters of {c} "
              f"resident at most")
        if n >= 4096:
            _require(c >= 8, f"{what}: {c} CTAs per stream at N = {n}, fewer than 8")
    else:
        smem = icp_gn.slab_bytes(per, nc) if resident else 0
        active, budget = icp_gn.spread_limits(dev, c, nc, per, resident)
        print(f"{what}: G = {g} clusters of C = {c} CTAs, at most {per} queries a CTA, "
              f"{g * c} CTAs (the spread kernel); candidates "
              f"{'resident' if resident else 'from L2'}, {smem} bytes of dynamic shared memory "
              f"a CTA (budget {budget}); {active} clusters of {c} resident at most")
    return dict(groups=g, cluster=c, per_cta=per, resident=resident, smem=smem,
                active_clusters=active)


def _spread_ptxas() -> None:
    """ptxas' registers and spills of the spread kernel's two variants."""
    for variant, tag in (("resident", "gn_spread_kernelILb1E"), ("from L2", "gn_spread_kernelILb0E")):
        print(f"K1 / K4 gn_spread_kernel ({variant}), ptxas: " + "; ".join(_ptxas_lines(tag)))


def _outputs(out) -> tuple:
    """A kernel's result as a tuple of tensors (a bare tensor: a 1-tuple)."""
    return tuple(out) if isinstance(out, tuple) else (out,)


def _same_twice(what, fn, quiet=False):
    """Launch a kernel twice on the same inputs; every output must be equal
    bit for bit (the GN cluster adds its CTA sums in rank order; K2 / K3
    have no reduction)."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    _require(all(torch.equal(x, y) for x, y in zip(_outputs(a), _outputs(b))),
             f"{what}: a repeated launch is not bit-equal")
    if not quiet:
        print(f"{what}: repeated launch bit-equal")
    return a


def _device_ms(fn, reps: int) -> float:
    """A kernel's device time per launch (the probe entry point's
    `device_ms`): the stream sleeps while the host queues `reps` launches,
    so the events time the launches back to back, free of the host's
    launch cost (which `_cuda_ms` includes when the kernel is shorter)."""
    from lidar_imu_slam_tpu_torch.tools import probes as tp

    try:
        return tp.device_ms(fn, reps)
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e


SPREAD_SWEEP = ((4, 8, 16), (2, 4, 8, 16, 30))  # (C, G) of the spread kernel's sweep


def _cluster_sweep(what, launch, n, nc, sizes, spread=False, reps=50):
    """Device time of the GN kernel at other shapes than the launch rule's:
    one cluster of each C in `sizes`, and with `spread` (one stream) G
    clusters of C CTAs for each (C, G) of SPREAD_SWEEP (the spread kernel).
    A shape with a CTA without queries is skipped; one whose clusters the
    card cannot hold at once must raise before it launches. Returns
    {"C=c,G=g": ms or None}."""
    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import _common, icp_gn

    dev = torch.device("cuda", torch.cuda.current_device())
    shapes = [(1, *icp_gn.cluster_shape(n, c), False) for c in sizes]
    for g in SPREAD_SWEEP[1] if spread else ():
        for c in SPREAD_SWEEP[0]:
            try:
                shapes.append(icp_gn.spread_split(n, nc, g, c, icp_gn.spread_limits(dev, c)[1]))
            except ValueError:
                pass  # more CTAs than warps of queries
    times = {}
    for shape in shapes:
        key = f"C={shape[1]},G={shape[0]}"
        before = dict(_common.LAUNCHES)
        try:
            launch(shape)
        except RuntimeError as e:
            _require("cannot all be resident" in str(e), f"{what} {key}: {e}")
            _require(_common.LAUNCHES == before, f"{what} {key}: launched although it raised")
            times[key] = None
            continue
        times[key] = _device_ms(lambda: launch(shape), reps)
    print(f"{what}: device ms/launch by shape " + "  ".join(
        f"{k}: {'not co-resident (raised)' if ms is None else f'{ms:.4f}'}"
        for k, ms in times.items()) +
        f"  (rule: {_shape_label(icp_gn.device_shape(n, nc, dev) if spread else None, n, nc)})")
    return times


def _shape_label(shape, n, nc) -> str:
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn

    g, c = shape[:2] if shape else (1, icp_gn.launch_shape(n, nc)[0])
    return f"C={c},G={g}"


def bench_cfg(cfgmod, points_per_scan: int, gn_backend: str = "pallas"):
    """The HDL-64E-scale deployment of bench.py:_make_cfg: the fast path
    with gn_backend="pallas" (packed slab only), the classic f64 path with
    gn_backend="xla" (the f32 point slab too)."""
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(
            num_scan_lines=64, max_points=points_per_scan, min_range=2.5,
            max_range=80.0, sort_by_time=False, time_source="per_point",
        ),
        map=cfgmod.MapConfig(
            voxel_size=1.0, max_range=80.0, capacity=1 << 17, neighborhood=8,
            store_points=gn_backend == "xla", max_insert_voxels=20480,
        ),
        icp=cfgmod.IcpConfig(
            max_map_points=32768, max_source_points=4096,
            estimation_threshold=5e-4, gn_backend=gn_backend, deskew=True,
        ),
    )


def _se3(rng, scale_t, scale_r):
    import torch

    from lidar_imu_slam_tpu_torch.ops import lie

    xi = np.concatenate([rng.normal(size=3) * scale_t, rng.normal(size=3) * scale_r])
    return lie.se3_exp(torch.from_numpy(xi))


def _k1_check(what, q, qmask, cand, scal, carry, inner, plain_reps) -> dict:
    """K1 on one set of inputs: its cluster shape, a repeated launch
    bit-equal, within 1e-5 rad / 1e-4 m of its plain version (iterations
    and flags equal, n_corr within 1), timed per call and on the device
    beside the plain version and its bound, and at cluster sizes 4, 8 and
    16. Returns its row and numbers."""
    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn

    n, nc = q.shape[1], cand.shape[1]
    shape = f"{n} x {nc}"
    launch_shape = _gn_cluster(f"{what} ({shape})", n, nc)
    fn = lambda: icp_gn.fused_gn_carry(q, qmask, cand, scal, carry, inner)  # noqa: E731
    plain = lambda: icp_gn.fused_gn_carry_ref(q, qmask, cand, scal, carry, inner)  # noqa: E731
    row = _same_twice(what, fn)
    ref = plain()
    torch.cuda.synchronize()
    a, b = row.cpu().numpy(), ref.cpu().numpy()
    err_R = float(np.abs(a[:9] - b[:9]).max())
    err_t = float(np.abs(a[9:12] - b[9:12]).max())
    print(f"{what}: row {np.round(a, 6).tolist()}")
    print(f"{what}: max|dR| {err_R:.3e} (tol 1e-5)  max|dt| {err_t:.3e} m (tol 1e-4)  "
          f"iters {a[14]:.0f}/{b[14]:.0f}  flags {a[15]:.0f}/{b[15]:.0f}  "
          f"n_corr {a[12]:.0f}/{b[12]:.0f} (tol 1)")
    _require(err_R <= 1e-5 and err_t <= 1e-4, f"{what}: pose disagrees with its plain version")
    _require(a[14] == b[14] and a[15] == b[15], f"{what}: iterations / flags disagree")
    _require(abs(a[12] - b[12]) <= 1, f"{what}: n_corr disagrees")
    ms = _cuda_ms(fn, 50)
    plain_ms = _cuda_ms(plain, plain_reps)
    bound, by = _gn_bound(q, qmask, cand, scal, row, carry)
    dev_ms = _device_ms(fn, 50)
    print(f"{what}: {ms:.4f} ms/launch (device {dev_ms:.4f}) over {a[14]:.0f} iterations  "
          f"plain {plain_ms:.4f} ms/call  bound {bound:.5f} ms ({by})")
    sweep = _cluster_sweep(f"{what} ({shape})", lambda sh: icp_gn._launch(
        "fused_gn_carry", q, qmask, cand, scal, carry, inner, 1, (16,), shape=sh), n, nc,
        (4, 8, 16), spread=True)
    return dict(launch_shape, row=row, max_abs_err=max(err_R, err_t), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by, device_ms=dev_ms,
                iterations=float(a[14]), device_ms_by_shape=sweep)


def kernel_phase(dev, cfg):
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map

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

    def inputs(n):
        src = g.points[:n] - torch.tensor([0.25, -0.15, 0.1], device=dev)
        mask = g.mask[:n]
        nq = torch.clamp(mask.sum(), min=1).float()
        anchor = torch.where(mask[:, None], src, torch.zeros_like(src)).sum(0) / nq
        q = (src - anchor).T.contiguous()
        cand = voxel_map.gather_candidate_planes_packed(m, src, mask, mcfg, anchor).contiguous()
        _require(tuple(cand.shape) == (3, 80, n), f"K1 candidates {tuple(cand.shape)}")
        scal = torch.tensor([0.5, 1.5**2, cfg.icp.estimation_threshold, 20.0, 2.0,
                             (0.5 * mcfg.voxel_size) ** 2, 0.0, 0.0],
                            dtype=torch.float64, device=dev)
        carry = torch.cat([torch.eye(3, dtype=torch.float64, device=dev).reshape(9),
                           torch.zeros(3, dtype=torch.float64, device=dev),
                           anchor.double()])
        return q, mask.float().contiguous(), cand, scal, carry

    print("K1 / K4 / K5 gn_cluster_kernel, ptxas: " + "; ".join(_ptxas_lines("gn_cluster_kernel")))
    _spread_ptxas()
    k1 = _k1_check("K1 fused_gn_carry", *inputs(cfg.icp.max_source_points),
                   cfg.icp.fused_inner, 5)
    _require(k1["groups"] == 1, "K1 at 4096 x 80 left the one-cluster kernel")
    # the kitti_64beam preset's 8192 source points (phases 16-21): spread
    wide = _k1_check("K1 fused_gn_carry at 8192", *inputs(8192), cfg.icp.fused_inner, 2)
    _require(wide["groups"] > 1, "K1 at 8192 x 80: one cluster, not spread over several")
    # no single PyTorch call computes a robust GN solve: library_ms is null
    results.append(dict(name="fused_gn_carry", route="cuda",
                        source="lidar_imu_slam_tpu_torch/csrc/icp_gn.cu",
                        replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:383",
                        max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
                        bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=None,
                        device_ms=k1["device_ms"], cluster=k1["cluster"], ctas=k1["cluster"],
                        device_ms_by_shape=k1["device_ms_by_shape"],
                        at_8192={k: v for k, v in wide.items() if k != "row"}))

    return results + pose_chain_phase(dev, cfg, rng, k1["row"])


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct buffers under `tensors` (views share one)."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def pose_chain_phase(dev, cfg, rng, k1):
    """K2 and K3 at the seeded 5-pose state, deskew on (K3 on K1's row as
    the correction and K2's row as the guess): each against its plain
    version (tol 1e-9), a repeated launch bit-equal, and four times — per
    call (CUDA events over 200 back-to-back launches), device (launches
    queued behind a stream sleep), host (the enqueue clock over 1,000
    calls) and the launch floor (an empty one-block launch,
    `torch.cuda._sleep(1)`, timed those two ways); device, host and floor
    are medians of 5 rounds taken in turns (tools/probes.py). The pose
    step (`pose_step_*` on K3's entry) is K2, K3 and the fast step's pose
    bookkeeping after them — the next state's pose leaves and accumulators
    and the f32 map delta — as the step runs them, timed the same three
    ways over 20 calls (host: 200), medians of 5 rounds."""
    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.kernels import pose_chain
    from lidar_imu_slam_tpu_torch.tools import pose_chain_cases as pc
    from lidar_imu_slam_tpu_torch.tools import probes as tp

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
    mmd = cfg.icp.max_model_deviation
    row = pose_chain.pose_pre(*pre_args, **kw).row
    state = (pre_args[0], pre_args[2], pre_args[5])  # state.pose, first_pose, num_poses
    # the bytes each function needs to read: [R | t] (12 doubles) of each
    # pose it takes, the 6 entries of model_dev that K2's model error reads,
    # the scalars; its outputs are counted as written, once each
    calls = {  # name: (kernel call, plain call, bytes read, TPU kernel, tag)
        "pose_pre": (lambda: pose_chain.pose_pre(*pre_args, **kw),
                     lambda: pose_chain.pose_pre_ref(*pre_args, **kw),
                     8 * (3 * 12 + 6 + 1) + 4 * 2, "pose_chain.py:244", "K2"),
        "pose_post": (lambda: pose_chain.pose_post(k1, row, *state, max_model_deviation=mmd),
                      lambda: pose_chain.pose_post_ref(k1, row, *state,
                                                       max_model_deviation=mmd),
                      8 * 4 * 12 + 4, "pose_chain.py:346", "K3"),
    }

    def pose_step():  # the kernels write the state's pose leaves and the delta
        pre = pose_chain.pose_pre(*pre_args, **kw)
        post = pose_chain.pose_post(k1, pre.row, *state, max_model_deviation=mmd)
        return kiss_icp.fast_state(None, pre, post), post.delta_R, post.delta_t

    outs = {}
    for name, (fn, ref_fn, _, _, tag) in calls.items():
        outs[name] = _same_twice(tag, fn)
        err = pc.max_err(outs[name], ref_fn())
        print(f"{tag} {name} max|d| {err:.3e} (tol 1e-9)")
        _require(err <= 1e-9, f"{tag} disagrees with its plain version")
        outs[name] = (outs[name], err)
    fns = [c[0] for c in calls.values()] + [lambda: torch.cuda._sleep(1)]
    *times, floor = tp._times_in_turns(fns, dev)
    # the pose step takes 20 calls behind the stream's sleep, not 100: a
    # step of tensor ops enqueues for ~0.3 ms a call, and the device time
    # needs the queueing done within half the sleep
    step = dict(zip(("ms", "device_ms", "host_ms"), map(np.median, zip(*[
        (_cuda_ms(pose_step, 20), tp.device_ms(pose_step, 20), tp.host_ms(pose_step, 200))
        for _ in range(5)]))))
    print(f"K2 + K3 + the fast step's pose bookkeeping: {step['ms']:.4f} ms/call (events over "
          f"20); device {step['device_ms']:.4f}, host {step['host_ms']:.4f} (medians of 5 "
          f"rounds)")
    results = []
    for (name, (fn, ref_fn, n_read, line, tag)), t in zip(calls.items(), times):
        out, err = outs[name]
        ms = _cuda_ms(fn, 200)
        plain_ms = _cuda_ms(ref_fn, 20)
        # a few hundred f64 operations: the bytes bound it
        bound, by = _bound_ms(n_read + _storage_bytes(out), 0.0)
        print(f"{tag} {ms:.4f} ms/launch (events over 200); device {t['device_ms']:.4f}, "
              f"host {t['host_ms']:.4f}; launch floor device {floor['device_ms']:.4f}, host "
              f"{floor['host_ms']:.4f} (medians of 5 rounds in turns); plain {plain_ms:.4f} "
              f"ms/call; bound {bound:.7f} ms ({by})")
        results.append(dict(name=name, route="cuda",
                            source="lidar_imu_slam_tpu_torch/csrc/pose_chain.cu",
                            replaces=f"{REFERENCE_PKG}/ops/pallas/{line}",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None, device_ms=t["device_ms"],
                            host_ms=t["host_ms"], floor_ms=floor["device_ms"],
                            floor_host_ms=floor["host_ms"]))
    results[-1].update({f"pose_step_{k}": v for k, v in step.items()})
    return results


def pose_chain_cases_phase(dev):
    """K2 then K3 on each branch case of tools/pose_chain_cases.py (num_poses
    0 / 1 / 2 / 5, deskew off, a relative rotation of sine 0 and of 1e-8,
    not moved, not accepted, no samples, diverged, diverged on the first
    scan): every output within 1e-9 of the plain version on the same
    inputs, the i32 outputs equal, the f32 map delta the kernel's own f64
    delta rounded to f32, a repeated launch bit-equal. These launches are
    counted off the main path."""
    from lidar_imu_slam_tpu_torch.ops.kernels import pose_chain
    from lidar_imu_slam_tpu_torch.tools import pose_chain_cases as pc

    worst = 0.0
    for name in pc.CASES:
        args, kw, corr = pc.case(name, dev)
        pre = _same_twice(f"K2 ({name})", lambda: pose_chain.pose_pre(*args, **kw), quiet=True)
        post_args = pc.post_args(args, corr, pre.row)
        post = _same_twice(f"K3 ({name})", lambda: pose_chain.pose_post(
            *post_args, max_model_deviation=pc.MAX_MODEL_DEVIATION), quiet=True)
        err = max(pc.max_err(pre, pose_chain.pose_pre_ref(*args, **kw)),
                  pc.max_err(post, pose_chain.pose_post_ref(
                      *post_args, max_model_deviation=pc.MAX_MODEL_DEVIATION)))
        _require(err <= 1e-9, f"K2 / K3 ({name}): {err:.3e} from the plain version")
        _require(pc.delta_is_own_rounding(post), f"K3 ({name}): the f32 map delta is not its "
                 "own f64 delta rounded")
        worst = max(worst, err)
    print(f"K2 / K3 on {len(pc.CASES)} branch cases ({', '.join(pc.CASES)}): max|d| {worst:.3e} "
          f"over every f64 output (tol 1e-9), i32 outputs equal, f32 delta its own f64 delta "
          f"rounded, repeated launches bit-equal")


def small_drive_phase(dev, packed_nn=True):
    """5 small scans through register_frame on the card and on the CPU; the
    candidates come from the packed slab, or with packed_nn=False from the
    f32 point slab (`voxel_map.gather_candidate_planes`)."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=not packed_nn, packed_nn=packed_nn),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend="pallas", deskew=True),
    )
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=5, speed=2.0, yaw_rate=0.03, dt=0.1)
    slab = "packed slab" if packed_nn else "f32 slab"
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
    print(f"small drive ({slab}): card (kernels) vs CPU (plain) max|d pose| {worst:.3e} "
          f"(tol 1e-4)")
    _require(worst <= 1e-4, f"small drive ({slab}): card and CPU poses disagree")


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
    """The HDL-64E rolling-shutter drive (bench.py:_make_raws): the scans
    uploaded, the same scans as host messages {"xyz", "time", "stamp"}
    (what the runners take), and the ground truth."""
    import torch

    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan

    t0 = time.perf_counter()
    world = synthetic.make_world(seed=0, n_points=600_000, extent=(160.0, 40.0, 12.0))
    gt = synthetic.make_trajectory(n_poses=N_SCANS, speed=8.0, yaw_rate=0.01, dt=0.1)
    raws, msgs = [], []
    for i in range(N_SCANS):
        pts, rel = synthetic.render_scan_rolling(
            world, gt[i], gt[min(i + 1, N_SCANS - 1)], 0.1, POINTS_PER_SCAN,
            2.5, 80.0, noise=0.02, seed=i)
        msgs.append({"xyz": pts, "time": i * 0.1 + rel, "stamp": i * 0.1})
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1,
                                  max_points=POINTS_PER_SCAN, device=dev))
    torch.cuda.synchronize()
    print(f"slice: rendered and uploaded {N_SCANS} scans in {time.perf_counter() - t0:.1f} s")
    return raws, msgs, gt


def _op_counter():
    """A dispatch mode that counts the aten ops dispatched under it: `ops`
    all of them, `compute` those that are not views (each of these may
    allocate or launch a kernel). The kernels' ctypes launches pass no
    dispatcher and are not counted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        ops = compute = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.compute += not getattr(func, "is_view", False)
            return func(*args, **(kwargs or {}))

    return OpCounter()


def _counting(counter):
    """Host reads raise a warning (sync debug mode "warn") and ops are
    counted while the context is open; with counter None, nothing."""
    import contextlib

    import torch

    if counter is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    torch.cuda.set_sync_debug_mode("warn")
    stack.callback(torch.cuda.set_sync_debug_mode, 0)
    stack.enter_context(counter)
    return stack


def _sites(caught) -> collections.Counter:
    """The host reads among the recorded warnings, by call site."""
    return collections.Counter(f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
                               if "called a synchronizing" in str(w.message))


def _reads_and_ops(run, n_scans=20) -> dict:
    """Host reads per scan by call site and aten ops dispatched per scan
    over `run(n_scans, counter)`, which counts its scan loop only (not its
    set-up)."""
    import warnings

    counter = _op_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(n_scans, counter)
    sites = _sites(caught)
    return dict(host_reads_per_scan=sum(sites.values()) / n_scans,
                host_reads_by_site=dict(sites.most_common(8)),
                ops_per_scan=counter.ops / n_scans,
                compute_ops_per_scan=counter.compute / n_scans)


def _reads_ops_line(what, c: dict) -> str:
    return (f"{what}: host reads per scan {c['host_reads_per_scan']:.2f} over scans 0-19 (sync "
            f"debug mode), by call site {c['host_reads_by_site']}; aten ops dispatched per "
            f"scan {c['ops_per_scan']:.2f}, {c['compute_ops_per_scan']:.2f} of them not views")


def slice_phase(dev, cfg, raws, gt):
    """The 120-scan HDL-64E-scale drive on the card. Host reads by call
    site and ops dispatched, per scan over scans 0-19; launch counters
    zeroed just before the timed 120-scan run and read just after. Returns
    (launches, the drive's numbers)."""
    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    # eviction and compaction at block boundaries (bench.py:_bench_chained)
    body = cfg.replace(map=dataclasses.replace(cfg.map, auto_evict=False, auto_rebuild=False))
    cap = cfg.map.capacity

    def run(n_scans, counter=None):
        state = kiss_icp.init_state(cfg, dev)
        poses, iters, ms = [], [], []
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        with _counting(counter):
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
    counts = _reads_and_ops(run)
    _common.reset_launches()
    state, poses, iters, wall, step_ms = run(N_SCANS)
    launches = dict(_common.LAUNCHES)
    _require(np.isfinite(poses).all(), "slice: non-finite pose")
    ate = _ate(poses, gt, shift=0.5)
    voxels = int(voxel_map.num_voxels(state.map))
    drops = int(state.map.drops)
    stats = dict(scans_per_s=N_SCANS / wall, p50_ms=float(np.percentile(step_ms, 50)),
                 p95_ms=float(np.percentile(step_ms, 95)), ate_m=ate,
                 icp_iterations=float(iters.mean()), **counts)
    print(f"slice: {stats['scans_per_s']:.2f} scans/s  p50 {stats['p50_ms']:.3f} ms  "
          f"p95 {stats['p95_ms']:.3f} ms per scan (CUDA events)")
    print(f"slice: ICP iterations mean {iters.mean():.2f} max {iters.max()}  "
          f"map voxels {voxels}  drops {drops}  launches {launches}")
    print(_reads_ops_line("slice", counts))
    print(f"slice: ATE {ate:.4f} m (mid-scan, limit {ATE_LIMIT_M})")
    for name in ("fused_gn_carry", "pose_pre", "pose_post"):
        _require(launches[name] > 0, f"slice: kernel {name} never launched")
    _require(launches["gn_spread"] == 0, "slice: K1 at 4096 x 80 left the one-cluster kernel")
    _require(launches["pose_pre"] == N_SCANS and launches["pose_post"] == N_SCANS,
             "slice: pose kernels did not run once per scan")
    # (a package without the fetch kernel, as `--measure` may drive, counts none)
    _require(launches.get("candidate_fetch", launches["fused_gn_carry"])
             == launches["fused_gn_carry"],
             "slice: the ICP rounds' fetches did not all launch the fetch kernel")
    _require(ate <= ATE_LIMIT_M, f"slice: ATE {ate:.4f} m above {ATE_LIMIT_M}")
    return launches, stats


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
    c4 = _gn_cluster("K4 fused_gn (1 x 4096 x 80)", one[0].shape[-1], one[2].shape[-2])
    _require(c4["groups"] == 1, "K4 at 4096 x 80 left the one-cluster kernel")
    c4 = c4["cluster"]
    rows4 = _same_twice("K4", lambda: icp_gn.fused_gn(*one, inner))
    err4, _ = _rows_err(rows4, icp_gn.fused_gn_ref(*one, inner), "K4 fused_gn (1 x 4096 x 80)")
    ms4 = _cuda_ms(lambda: icp_gn.fused_gn(*one, inner), 50)
    plain4 = _cuda_ms(lambda: icp_gn.fused_gn_ref(*one, inner), 5)
    bound4, by4 = _gn_bound(*one, rows4)
    dev4 = _device_ms(lambda: icp_gn.fused_gn(*one, inner), 50)
    print(f"K4 {ms4:.4f} ms/launch (device {dev4:.4f})  plain {plain4:.4f} ms/call  "
          f"bound {bound4:.5f} ms ({by4})")

    errs, times, bounds, shapes = [], {}, {}, {}
    for name, args, sizes in (("8 x 4096 x 80", hdl, (4, 8, 16)),
                              ("256 x 512 x 16", mc, (1, 2, 4))):
        n_st, n, nc = args[0].shape[0], args[0].shape[-1], args[2].shape[-2]
        shapes[name] = _gn_cluster(f"K5 fused_gn_batched ({name})", n, nc, n_st)["cluster"]
        rows = _same_twice(f"K5 ({name})", lambda: icp_gn.fused_gn_batched(*args, inner))
        err, iters = _rows_err(rows, icp_gn.fused_gn_batched_ref(*args, inner),
                               f"K5 fused_gn_batched ({name})")
        _require(len(iters) > 1, f"K5 ({name}): every stream stopped at one count")
        errs.append(err)
        times[name] = (_cuda_ms(lambda: icp_gn.fused_gn_batched(*args, inner), 50),
                       _cuda_ms(lambda: icp_gn.fused_gn_batched_ref(*args, inner), 5),
                       _device_ms(lambda: icp_gn.fused_gn_batched(*args, inner), 50))
        bounds[name] = _gn_bound(*args, rows)
        print(f"K5 ({name}) {times[name][0]:.4f} ms/launch (device {times[name][2]:.4f})  "
              f"plain {times[name][1]:.4f} ms/call  bound {bounds[name][0]:.5f} ms "
              f"({bounds[name][1]})")
        _cluster_sweep(f"K5 ({name})", lambda shape: icp_gn._launch(
            "fused_gn_batched", *args, None, inner, n_st, (n_st, 16), shape=shape), n, nc,
            sizes)
    src = "lidar_imu_slam_tpu_torch/csrc/icp_gn.cu"
    return [
        dict(name="fused_gn", route="cuda", source=src,
             replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:281",
             max_abs_err=err4, ms=ms4, plain_ms=plain4, bound_ms=bound4, bound_by=by4,
             library_ms=None, device_ms=dev4, cluster=c4, ctas=c4),
        dict(name="fused_gn_batched", route="cuda", source=src,
             replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:415",
             max_abs_err=max(errs), ms=times["8 x 4096 x 80"][0],
             plain_ms=times["8 x 4096 x 80"][1],
             bound_ms=bounds["8 x 4096 x 80"][0], bound_by=bounds["8 x 4096 x 80"][1],
             library_ms=None,
             ms_256x512x16=times["256 x 512 x 16"][0],
             plain_ms_256x512x16=times["256 x 512 x 16"][1],
             bound_ms_256x512x16=bounds["256 x 512 x 16"][0],
             device_ms=times["8 x 4096 x 80"][2], device_ms_256x512x16=times["256 x 512 x 16"][2],
             cluster=shapes["8 x 4096 x 80"], ctas=STREAMS * shapes["8 x 4096 x 80"],
             cluster_256x512x16=shapes["256 x 512 x 16"],
             ctas_256x512x16=MC_STREAMS * shapes["256 x 512 x 16"]),
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


def small_batched_phase(dev, packed_nn=True):
    """3 streams x 5 small scans under batch_config on the card and the
    CPU; then one stream through register_frame under batch_config (K4).
    Candidates from the packed slab, or with packed_nn=False from the f32
    point slab."""
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
                             neighborhood=8, store_points=not packed_nn, packed_nn=packed_nn,
                             max_insert_voxels=700),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend="pallas", deskew=True),
    ))
    slab = "packed slab" if packed_nn else "f32 slab"
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=8, speed=2.0, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(7):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5,
                                                 30.0, noise=0.01, seed=i)
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                  device="cpu"))

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
    print(f"small batched drive (3 streams, {slab}): card vs CPU max|d pose| {worst:.3e} "
          f"(tol 1e-4)")
    _require(worst <= 1e-4, f"small batched drive ({slab}): card and CPU poses disagree")

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
    print(f"single stream under batch_config ({slab}): card vs CPU max|d pose| {worst:.3e} "
          f"(tol 1e-4)  launches {launches}")
    _require(worst <= 1e-4, f"single-stream batch_config drive ({slab}): card and CPU poses "
             "disagree")
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


def _cdist_min(q, pool_rows, chunk):
    """The library yardstick for K6: torch.cdist (no matmul shortcut) and a
    min over the same pool chunks as the plain version. Timed only."""
    import torch

    best = None
    for start in range(0, pool_rows.shape[0], chunk):
        d = torch.cdist(q, pool_rows[start:start + chunk],
                        compute_mode="donot_use_mm_for_euclid_dist").min(dim=1).values
        best = d if best is None else torch.minimum(best, d)
    return best


def _k6_check(what, q, pool):
    """K6 against its plain version on the card: indices equal and d^2 equal
    bit for bit (both round every f32 step the same way). Returns (d2, idx,
    max |d2 - d2_plain| over the finite entries)."""
    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import nn_bruteforce as nnb

    d2, idx = nnb.nn_bruteforce(q, pool)
    d2_p, idx_p = nnb.nn_bruteforce_plain(q, pool)
    torch.cuda.synchronize()
    n_idx = int((idx != idx_p).sum())
    n_d2 = int((d2.view(torch.int32) != d2_p.view(torch.int32)).sum())
    print(f"{what}: {q.shape[0]} x {pool.shape[1]}: indices differing {n_idx}, d2 bit patterns "
          f"differing {n_d2} (tol 0 and 0)")
    _require(n_idx == 0 and n_d2 == 0, f"{what}: K6 disagrees with its plain version")
    fin = torch.isfinite(d2_p)
    return d2, idx, float((d2 - d2_p)[fin].abs().max()) if bool(fin.any()) else 0.0


def _k6_inputs(dev):
    """K6 at the classic path's shape: 4096 queries x a 1,310,720-entry pool
    with ~30% +inf entries and 256 exact duplicate points (the first index
    must win), the first 256 queries on them. Returns (q, pool, dup)."""
    import torch

    rng = np.random.default_rng(3)
    lo, hi = np.array([-80.0, -80.0, -3.0]), np.array([80.0, 80.0, 12.0])
    pts = rng.uniform(lo, hi, (K6_POOL, 3)).astype(np.float32)
    pts[rng.uniform(size=K6_POOL) < 0.3] = np.inf
    dup = rng.choice(K6_POOL // 2, 256, replace=False)
    tie = rng.uniform(lo, hi, (256, 3)).astype(np.float32)
    pts[dup] = tie
    pts[dup + K6_POOL // 2] = tie  # the same point at a later index
    qs = rng.uniform(lo, hi, (K6_QUERIES, 3)).astype(np.float32)
    qs[:256] = tie  # exact hits: d2 = 0 at two indices
    pool = torch.from_numpy(np.ascontiguousarray(pts.T)).to(dev)
    return torch.from_numpy(qs).to(dev), pool, dup


def _k6_times(q, pool) -> dict:
    """K6's per-call (CUDA events), device (launches queued behind a stream
    sleep) and host (enqueue clock) ms at one input, through the public
    wrapper (so `--measure` times a parent checkout alike)."""
    from lidar_imu_slam_tpu_torch.ops.kernels import nn_bruteforce as nnb
    from lidar_imu_slam_tpu_torch.tools import probes as tp

    fn = lambda: nnb.nn_bruteforce(q, pool)  # noqa: E731
    return dict(ms=_cuda_ms(fn, 20), device_ms=_device_ms(fn, 20), host_ms=tp.host_ms(fn, 20))


def _clocks_during(fn, seconds: float = 2.0) -> list[str]:
    """The card's SM clock and power draw (nvidia-smi, every 200 ms) while
    `fn` runs back to back; the first samples, taken before the load
    settles, are dropped."""
    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader", "-lms", "200"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    return [ln.strip() for ln in out.splitlines()[2:] if ln.strip()]


def nn_kernel_phase(dev):
    """K6 against its plain version at the classic path's shape (random
    pool, 256 exact ties), then on every adversarial case of
    tools/nn_cases.py at the same shape, each bit-equal; timed beside the
    plain version and the cdist yardstick, on device and host, and at other
    slice lengths."""
    from lidar_imu_slam_tpu_torch.ops.kernels import nn_bruteforce as nnb
    from lidar_imu_slam_tpu_torch.tools import nn_cases

    import torch

    print("K6 nn_seed_kernel / nn_slice_kernel, ptxas: " + "; ".join(
        _ptxas_lines("nn_seed_kernel") + _ptxas_lines("nn_slice_kernel")))
    q, pool, dup = _k6_inputs(dev)
    d2, idx, err = _k6_check("K6 nn_bruteforce", q, pool)
    _require(bool((idx[:256].cpu().numpy() == dup).all()),
             "K6: an exact tie did not resolve to the first index")
    _same_twice("K6", lambda: nnb.nn_bruteforce(q, pool))
    t = _k6_times(q, pool)
    ms = t["ms"]
    plain_ms = _cuda_ms(lambda: nnb.nn_bruteforce_plain(q, pool), 3)
    rows = pool.T.contiguous()
    library_ms = _cuda_ms(lambda: _cdist_min(q, rows, nnb.PLAIN_CHUNK), 1)
    n, m = q.shape[0], pool.shape[1]
    bound, by = _bound_ms(_nbytes(q, pool, d2, idx), 8.0 * n * m)
    print(f"K6 {ms:.4f} ms/launch (device {t['device_ms']:.4f}, host {t['host_ms']:.4f})  "
          f"plain {plain_ms:.4f} ms/call  cdist+min {library_ms:.4f} ms  "
          f"bound {bound:.4f} ms ({by}); 256 exact ties resolved to the first index")
    print("K6 running back to back: SM clock, power " +
          "; ".join(_clocks_during(lambda: nnb.nn_bruteforce(q, pool))))
    sweep = {s: _cuda_ms(lambda s=s: nnb._launch(q, pool, s), 20) for s in (4096, 8192, 16384)}
    print("K6 ms/launch by slice length " + "  ".join(f"{s}: {v:.4f}" for s, v in sweep.items())
          + f"  (wrapper: {nnb.SLICE})")
    case_ms = {}
    for case in nn_cases.CASES:
        qs, pts = nn_cases.make(case, K6_QUERIES, K6_POOL, seed=3)
        cq, cp = torch.from_numpy(qs).to(dev), torch.from_numpy(pts).to(dev)
        _, _, case_err = _k6_check(f"K6 adversarial case {case}", cq, cp)
        err = max(err, case_err)
        case_ms[case] = _cuda_ms(lambda: nnb.nn_bruteforce(cq, cp), 3)
        del cq, cp
    print("K6 ms/launch by adversarial case " +
          "  ".join(f"{c}: {v:.4f}" for c, v in case_ms.items()))
    return dict(name="nn_bruteforce", route="cuda",
                source="lidar_imu_slam_tpu_torch/csrc/nn_bruteforce.cu",
                replaces=f"{REFERENCE_PKG}/ops/pallas/nn_bruteforce.py:66",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, device_ms=t["device_ms"], host_ms=t["host_ms"],
                slice_sweep_ms=sweep, case_ms=case_ms)


def _fetch_distinct(m, q, qm, cfg) -> tuple[int, int]:
    """The distinct grid cells and packed rows a batched fetch reads: what
    its inputs need, each read once."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map

    s = q.shape[0]
    keys = voxel_map.pack_key(voxel_map._neighbor_voxels(q, cfg)).reshape(s, -1)
    on = qm.repeat(1, cfg.neighborhood)
    offs = torch.arange(s, device=q.device)[:, None]
    pos = voxel_map.grid_pos(keys, cfg).to(torch.int64) + offs * m.grid.shape[-1]
    slots = voxel_map._lookup(m, keys, on, cfg).to(torch.int64)
    rows = (slots + offs * m.packed.shape[-2])[slots >= 0]
    return int(torch.unique(pos[on]).numel()), int(torch.unique(rows).numel())


def fetch_kernel_phase(dev) -> dict:
    """The ICP candidate fetch kernel against its plain version: bit-equal
    (+inf included) on every case of tools/fetch_cases.py and a repeated
    launch bit-equal; then at the benchmark cells' shapes (128 x 8192 and
    64 x 16,384 queries, NB 8, Kp 10, maps of about the cells' live voxels;
    128 x 8192 at NB 27 too) bit-equal again and timed: the kernel
    alone (CUDA events; device: queued behind a stream sleep), the whole
    fetch as the path calls it (with its anchor terms), and the plain
    version, beside the bound (every byte it needs once: the planes written,
    the distinct grid cells and packed rows read, the queries and mask) and
    the count of one cell and one row a (query, neighbour)."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import candidate_fetch as cf
    from lidar_imu_slam_tpu_torch.tools import fetch_cases

    def bits(t):
        return t.view(torch.int32)

    print("fetch candidate_fetch_kernel, ptxas: " +
          "; ".join(_ptxas_lines("candidate_fetch_kernel")))
    for case in fetch_cases.CASES:
        m, q, qm, cfg, anchor = fetch_cases.case(case, dev)
        out = _same_twice(f"fetch {case}", lambda: voxel_map.gather_candidate_planes_packed(
            m, q, qm, cfg, anchor), quiet=True)
        ref = voxel_map.gather_candidate_planes_packed_plain(m, q, qm, cfg, anchor)
        _require(torch.equal(bits(out), bits(ref)),
                 f"fetch {case}: the kernel's planes differ from the plain version's")
        del m, q, qm, out, ref
    print(f"fetch: bit-equal to the plain version, twice, on {len(fetch_cases.CASES)} cases "
          f"({', '.join(fetch_cases.CASES)})")
    shapes = {}
    for name in fetch_cases.DEPLOYMENTS:
        m, q, qm, cfg, anchor = fetch_cases.deployment(name, dev)
        av, aoff = voxel_map._anchor_terms(anchor, cfg.voxel_size)
        geo = voxel_map.fetch_geometry(cfg)

        def kernel():
            return cf.candidate_fetch(m.grid, m.packed, q, qm, av, aoff, **geo)

        def path():
            return voxel_map.gather_candidate_planes_packed(m, q, qm, cfg, anchor)

        def plain():
            return voxel_map.gather_candidate_planes_packed_plain(m, q, qm, cfg, anchor)

        out = path()
        ref = plain()
        _require(torch.equal(bits(out), bits(ref)),
                 f"fetch {name}: the kernel's planes differ from the plain version's")
        found = float(torch.isfinite(out).all(dim=-3).float().mean())
        del ref
        s, n = q.shape[0], q.shape[1]
        nb, kp = cfg.neighborhood, cfg.packed_width
        cells, rows = _fetch_distinct(m, q, qm, cfg)
        lookup_ms = _bound_ms(_nbytes(out, q, qm) + s * nb * n * 4 * (1 + kp), 0.0)[0]
        bound, by = _bound_ms(_nbytes(out, q, qm) + 4 * cells + 4 * kp * rows, 0.0)
        t = dict(ms=_cuda_ms(kernel, 20), device_ms=_device_ms(kernel, 20),
                 path_device_ms=_device_ms(path, 20), plain_ms=_cuda_ms(plain, 3),
                 bound_ms=bound, bound_by=by, lookup_bound_ms=lookup_ms, found_share=found,
                 distinct_cells=cells, distinct_rows=rows)
        t["roofline_pct"] = 100.0 * bound / t["device_ms"]
        print(f"fetch {name} ({s} x {n}, NB {nb}, Kp {kp}): kernel {t['ms']:.4f} ms/launch "
              f"(device {t['device_ms']:.4f}; {t['roofline_pct']:.1f}% of the bound), the "
              f"path's fetch device {t['path_device_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms/call; bound {bound:.4f} ms ({by}: {cells} distinct grid cells, {rows} "
              f"distinct rows), {lookup_ms:.4f} ms with a cell and a row a lookup; "
              f"{found:.3f} of the candidates found")
        shapes[name] = t
        del m, q, qm, out
    torch.cuda.empty_cache()
    hdl = shapes["hdl64"]
    return dict(name="candidate_fetch", route="cuda",
                source="lidar_imu_slam_tpu_torch/csrc/candidate_fetch.cu",
                replaces="none (the JAX fetch is plain jnp gathers: "
                         f"{REFERENCE_PKG}/ops/voxel_map.py:gather_candidate_planes_packed)",
                max_abs_err=0.0, library_ms=None,
                **{k: hdl[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                shapes=shapes)


def _ulps_of_norm(out, ref) -> tuple[float, int]:
    """The largest |out - ref| of a point's coordinate in ulps of the
    point's norm, and the count of coordinates whose bits differ."""
    import torch

    norm = torch.linalg.norm(ref, dim=-1, keepdim=True)
    ulp = torch.nextafter(norm, torch.full_like(norm, float("inf"))) - norm
    bad = out.view(torch.int32) != ref.view(torch.int32)
    worst = float(((out - ref).abs() / ulp)[bad].max()) if bool(bad.any()) else 0.0
    return worst, int(bad.sum())


def deskew_kernel_phase(dev) -> dict:
    """The IMU deskew kernel against the plain per-point pass: bit-equal on
    every case of tools/deskew_cases.py and a repeated launch bit-equal;
    then at the LIO ensemble's shape (4096 x 16,384 points,
    `deskew_cases.deployment`) bit-equal again and timed: the kernel alone
    (CUDA events; device: queued behind a stream sleep) and the plain
    version, beside the bound (the points, their f64 times and mask read
    once, the points written once, the trail tables and per-stream terms
    read once)."""
    import torch

    from lidar_imu_slam_tpu_torch.models import ekf
    from lidar_imu_slam_tpu_torch.ops.kernels import imu_deskew as ik
    from lidar_imu_slam_tpu_torch.tools import deskew_cases

    print("deskew imu_deskew_kernel, ptxas: " + "; ".join(_ptxas_lines("imu_deskew_kernel")))
    worst = {}
    for case in deskew_cases.CASES:
        args = deskew_cases.case(case, dev)
        out, again = ekf.deskew_points(*args), ekf.deskew_points(*args)
        _require(torch.equal(out.view(torch.int32), again.view(torch.int32)),
                 f"deskew {case}: a repeated launch is not bit-equal")  # NaN points included
        worst[case] = _ulps_of_norm(out, ekf.deskew_points_plain(*args))
        del args, out, again
    print(f"deskew: (largest gap in ulps of the point's norm, coordinates that differ) from the "
          f"plain version, by case: {worst}")
    _require(not any(n for _, n in worst.values()),
             "deskew: the kernel's points differ from the plain version's")
    args = deskew_cases.deployment(dev)
    out = ik.imu_deskew(*args)
    ref = ekf.deskew_points_plain(*args)
    gap = _ulps_of_norm(out, ref)
    _require(gap[1] == 0, f"deskew at 4096 x 16,384: the kernel differs from the plain "
             f"version: {gap}")
    del ref
    s, n = args[0].shape[:2]
    m = args[3].shape[-1]
    bound, by = _bound_ms(_nbytes(*args, out), 0.0)
    t = dict(ms=_cuda_ms(lambda: ik.imu_deskew(*args), 20),
             device_ms=_device_ms(lambda: ik.imu_deskew(*args), 20),
             plain_ms=_cuda_ms(lambda: ekf.deskew_points_plain(*args), 3), bound_ms=bound,
             bound_by=by, bytes=_nbytes(*args, out))
    t["roofline_pct"] = 100.0 * bound / t["device_ms"]
    print(f"deskew {s} x {n} (M {m}): kernel {t['ms']:.4f} ms/launch (device "
          f"{t['device_ms']:.4f}; {t['roofline_pct']:.1f}% of the bound), plain "
          f"{t['plain_ms']:.3f} ms/call; bound {bound:.4f} ms ({by}: {t['bytes'] / 1e9:.3f} GB)")
    del args, out
    torch.cuda.empty_cache()
    return dict(name="imu_deskew", route="cuda",
                source="lidar_imu_slam_tpu_torch/csrc/imu_deskew.cu",
                replaces="none (the JAX per-point deskew is plain jnp: "
                         f"{REFERENCE_PKG}/models/ekf.py:motion_compensation_with_imu)",
                max_abs_err=0.0, library_ms=None,
                **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                roofline_pct=t["roofline_pct"])


def _small_cfg(cfgmod, gn_backend):
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048,
                                 sort_by_time=False, time_source="per_point"),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12,
                             neighborhood=8, store_points=gn_backend == "xla",
                             max_insert_voxels=700),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512,
                             max_iterations=20, gn_backend=gn_backend, deskew=True),
    )


def small_classic_phase(dev):
    """gn_backend="xla" on the card and on the CPU: 5 small scans through
    register_frame_step, then 3 streams x 5 scans under batch_config (one
    step under sync debug mode "error"). No kernel may launch."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import (RawScan, pack_raw_scan,
                                                         preprocess_scan, stack_raw_scans)
    from lidar_imu_slam_tpu_torch.parallel import streams

    cfg = _small_cfg(cfgmod, "xla")
    world = synthetic.make_world(seed=0, n_points=20000, extent=(20.0, 8.0, 4.0))
    gt = synthetic.make_trajectory(n_poses=8, speed=2.0, yaw_rate=0.03, dt=0.1)
    raws = []
    for i in range(7):
        pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[i + 1], 0.1, 1500, 0.5,
                                                 30.0, noise=0.01, seed=i)
        raws.append(pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                  device="cpu"))

    def on(d, raw):
        return RawScan(*(t.to(d) for t in raw))

    _common.reset_launches()
    single = {d: kiss_icp.init_state(cfg, d) for d in (dev, "cpu")}
    worst = 0.0
    for i in range(5):
        poses = {}
        for d in (dev, "cpu"):
            single[d], out = kiss_icp.register_frame_step(
                single[d], preprocess_scan(on(d, raws[i]), cfg.lidar), cfg)
            poses[d] = out.pose.cpu().numpy()
        worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
    print(f"small classic drive (xla): card vs CPU max|d pose| {worst:.3e} (tol 1e-4)")
    _require(worst <= 1e-4, "small classic drive: card and CPU poses disagree")

    bcfg = streams.batch_config(cfg)
    states = {d: streams.init_batched_state(bcfg, 3, d) for d in (dev, "cpu")}
    worst = 0.0
    for i in range(5):
        poses = {}
        for d in (dev, "cpu"):
            scans = preprocess_scan(on(d, stack_raw_scans(raws[i:i + 3])), bcfg.lidar)
            if d != "cpu" and i == 3:
                states[d], out = _no_sync(
                    lambda: streams.batched_register_frame_step(states[d], scans, bcfg))
            else:
                states[d], out = streams.batched_register_frame_step(states[d], scans, bcfg)
            poses[d] = out.pose.cpu().numpy()
        worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
    print(f"small classic batched drive (xla, 3 streams): card vs CPU max|d pose| {worst:.3e} "
          f"(tol 1e-4); step 4 ran under sync debug mode 'error'")
    _require(worst <= 1e-4, "small classic batched drive: card and CPU poses disagree")
    _require(not any(_common.LAUNCHES.values()),
             f"the classic path launched a kernel: {_common.LAUNCHES}")


def classic_slice_phase(dev, cfg64, raws, gt):
    """The classic f64 deployment (bench.py mode 5, `_make_cfg(131072,
    gn_backend="xla")`) on the slice's 120-scan drive, eviction at block
    boundaries. Returns the final state and the last scan's output."""
    import warnings

    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    body = cfg64.replace(map=dataclasses.replace(cfg64.map, auto_evict=False,
                                                 auto_rebuild=False))
    cap = cfg64.map.capacity

    def run(n_scans, timed=True):
        state = kiss_icp.init_state(cfg64, dev)
        poses, iters, ms = [], [], []
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        for i in range(n_scans):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            state, out = kiss_icp.register_frame_step(
                state, preprocess_scan(raws[i], body.lidar), body)
            if (i + 1) % BLOCK == 0:
                m = voxel_map.evict_far(state.map, state.pose[:3, 3], cfg64.map, inplace=True)
                if bool((m.next_slot > cap - cap // 4) & (m.tombstones > cap // 16)):
                    m = voxel_map.rebuild(m, cfg64.map)
                state = state._replace(map=m)
            ev1.record()
            poses.append(out.pose)
            iters.append(out.icp_iterations)
            ms.append((ev0, ev1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        step_ms = np.array([a.elapsed_time(b) for a, b in ms])
        return (state, out, torch.stack(poses).cpu().numpy(),
                torch.stack(iters).cpu().numpy(), wall, step_ms)

    # host reads, counted by the sync debug mode over the first 20 scans
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, _, it20, _, _ = run(20)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = _sites(caught)
    syncs = sum(sites.values())
    _common.reset_launches()
    state, out, poses, iters, wall, step_ms = run(N_SCANS)
    launches = dict(_common.LAUNCHES)
    _require(np.isfinite(poses).all(), "classic slice: non-finite pose")
    ate = _ate(poses, gt, shift=0.5)
    print(f"classic slice (xla, f64): {N_SCANS / wall:.2f} scans/s  "
          f"p50 {np.percentile(step_ms, 50):.3f} ms  p95 {np.percentile(step_ms, 95):.3f} ms "
          f"per scan (CUDA events)")
    print(f"classic slice: ICP iterations mean {iters.mean():.2f} max {iters.max()}  "
          f"host reads per scan {syncs / 20:.2f} over scans 0-19 (sync debug mode; "
          f"their ICP iterations mean {it20.mean():.2f})  map voxels "
          f"{int(voxel_map.num_voxels(state.map))}  drops {int(state.map.drops)}  "
          f"launches {launches}")
    print(f"classic slice: host reads over scans 0-19 by call site {dict(sites.most_common(8))}")
    print(f"classic slice: ATE {ate:.4f} m (mid-scan, limit {ATE_LIMIT_M})")
    _require(ate <= ATE_LIMIT_M, f"classic slice: ATE {ate:.4f} m above {ATE_LIMIT_M}")
    _require(not any(launches.values()), f"classic slice launched a kernel: {launches}")
    return state, out


def nn_on_path_phase(dev, cfg64, state, out):
    """K6 on the classic slice's final map: its pool, queried with the last
    scan's masked keypoints, against the plain version and against the
    hash fetch `voxel_map.nearest_neighbors` (the 8-voxel block around each
    query, all K points of each voxel).

    K6 is never farther. Where K6's winner lies in a voxel the hash fetch
    searched, the two are equal (the same f32 expression over a superset).
    Every other query is one whose winner is filed under a voxel key one
    voxel off its position — the insert keys points by their position
    before the ICP correction (register_core, PARITY.md) — and is counted:
    within half a voxel these are the only queries where the two differ."""
    import torch

    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.kernels import nn_bruteforce as nnb

    mcfg = cfg64.map
    pool = nnb.pool_from_map(state.map, mcfg)
    _require(tuple(pool.shape) == (3, K6_POOL), f"K6 pool {tuple(pool.shape)}")
    q = out.keypoints[out.keypoints_mask][:K6_QUERIES].contiguous()
    live = int(torch.isfinite(pool[0]).sum())
    _common.reset_launches()
    d2, idx, _ = _k6_check("K6 on the classic map", q, pool)
    launches = _common.LAUNCHES["nn_bruteforce"]
    ones = torch.ones(q.shape[0], dtype=torch.bool, device=dev)
    _, d2_hash, found = voxel_map.nearest_neighbors(state.map, q, ones, mcfg)
    slots = voxel_map._neighbor_slots(state.map, q, ones, mcfg)
    searched = (slots == (idx // mcfg.max_points_per_voxel)[:, None]).any(dim=-1)
    near = found & (d2_hash <= (0.5 * mcfg.voxel_size) ** 2)
    worse = int((found & (d2 > d2_hash)).sum())
    unequal = int((found & searched & (d2 != d2_hash)).sum())
    near_off = int((near & (d2 != d2_hash)).sum())
    closer = float((found & (d2 < d2_hash)).float().mean())
    print(f"K6 on the classic map: {q.shape[0]} keypoints, {live} live pool entries; hash "
          f"found {int(found.sum())}; K6 farther than the hash {worse} (tol 0); unequal with "
          f"the winner's voxel searched {unequal} (tol 0); within half a voxel "
          f"{int(near.sum())}, of which {near_off} differ (winner filed one voxel off); "
          f"K6 strictly closer for {closer:.4%} of the queries")
    _require(worse == 0, "K6 found a farther point than the hash fetch")
    _require(unequal == 0, "K6 and the hash fetch differ where the hash searched K6's winner")
    # adversarial queries on the same pool: exactly on live entries, at the
    # midpoint of two, 1e4 m away, and not finite
    rng = np.random.default_rng(9)
    live_i = torch.nonzero(torch.isfinite(pool[0])).flatten()
    pick = live_i[torch.from_numpy(rng.choice(live_i.numel(), 1024)).to(dev)]
    on = pool[:, pick].T
    mid = 0.5 * (on + pool[:, torch.roll(pick, 1)].T)
    far = on + torch.tensor([1e4, -1e4, 0.0], device=dev)
    bad = on.clone()
    bad[0::3, 0], bad[1::3, 1], bad[2::3, 2] = float("nan"), float("inf"), -float("inf")
    adv = torch.cat([on, mid, far, bad]).contiguous()
    d2_adv, _, _ = _k6_check("K6 on the classic map, adversarial queries", adv, pool)
    _require(bool((d2_adv[:1024] == 0).all()), "K6: a query on a pool entry is not at d2 0")
    _require(bool(torch.isinf(d2_adv[3072:]).all()), "K6: a non-finite query found a neighbour")
    return launches


def probe_phase(dev):
    """The tools/ probes P1-P4 through the port's probe entry point on the
    card; the counts of this run are the probe path's launches. Each row of
    the entry point holds one kernel case against its plain version (the
    gathers bit-equal in every case, gn_proto within GN_TOL with an equal
    conv), its per-call, device and host times beside the plain version's
    and the library call's, and the bytes and operations its bound is
    taken from."""
    import io

    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.tools import probes as tp

    _common.reset_launches()
    buf = io.StringIO()
    rows = tp.run("all", dev, out=buf)
    launches = {k: _common.LAUNCHES[k] for k in PROBE_REPLACES}
    for line in buf.getvalue().splitlines():
        print("probes:", line)
    _require(all(r["correct"] for r in rows), "probes: a probe reported correct=False")

    results = {}
    for r in rows:
        name = r["kernel"]
        if name is None:
            continue
        tol = tp.GN_TOL if name == "gn_proto" else 0.0
        _require(r["max_abs_err"] <= tol,
                 f"{name} {r['probe']} {r['name']}: {r['max_abs_err']} from its plain version")
        bound, by = _bound_ms(r["bytes"], r["ops"])
        case = dict(ms=r["ms"], device_ms=r["device_ms"], host_ms=r["host_ms"],
                    plain_ms=r["plain_ms"], bound_ms=bound, library_ms=r["library_ms"],
                    library_device_ms=r["library_device_ms"],
                    library_host_ms=r["library_host_ms"])
        print(f"{name} {r['probe']} {r['name']}: bound {bound:.6f} ms ({by})")
        if name not in results:
            results[name] = dict(name=name, route="cuda",
                                 source="lidar_imu_slam_tpu_torch/csrc/probes.cu",
                                 replaces=PROBE_REPLACES[name], max_abs_err=r["max_abs_err"],
                                 bound_by=by, **case)
        else:  # take_rows' later cases, under their probe's name
            k = results[name]
            k["max_abs_err"] = max(k["max_abs_err"], r["max_abs_err"])
            k.update({f"{key}[{r['probe']} {r['name']}]": v for key, v in case.items()})

    # gn_proto's cluster: its shape, registers, a repeated launch, other sizes
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn
    from lidar_imu_slam_tpu_torch.ops.kernels import probes as kp

    x = tp.gn_inputs(dev)
    args = (x["q"], x["qmask"], x["cand"], x["scal"], tp.N_INNER)
    c, per = icp_gn.launch_shape(tp.NQ, tp.NC)
    print(f"gn_proto: cluster of C = {c} CTAs x {per} queries; {kp.max_active_clusters(c)} "
          f"clusters of {c} resident at most")
    _require(c > 1, f"gn_proto: {c} CTA at {tp.NQ} x {tp.NC}")
    print("gn_proto_kernel, ptxas: " + "; ".join(_ptxas_lines("gn_proto_kernel")))
    _same_twice("gn_proto", lambda: kp.gn_proto(*args))
    sweep = {}
    for size in (4, 8, 16):
        shape = icp_gn.cluster_shape(tp.NQ, size)
        out = kp._launch(*args, shape)
        ref = kp.gn_proto_plain(*args)
        _require(float((out[:12] - ref[:12]).abs().max()) <= tp.GN_TOL and out[12] == ref[12],
                 f"gn_proto at C = {shape[0]} disagrees with its plain version")
        sweep[shape[0]] = _device_ms(lambda shape=shape: kp._launch(*args, shape), 50)
    print("gn_proto device ms/launch by cluster size " +
          "  ".join(f"C={k}: {v:.4f}" for k, v in sweep.items()) + f"  (rule: C={c})")
    # the launch's fixed cost (n_inner 0: launch, candidate staging, cluster
    # start) against the cost of an iteration
    by_iters = {ni: _device_ms(lambda ni=ni: kp.gn_proto(*args[:4], ni), 50) for ni in (0, 1, 8)}
    print("gn_proto device ms/launch by n_inner " +
          "  ".join(f"{ni}: {v:.4f}" for ni, v in by_iters.items()))
    results["gn_proto"].update(cluster=c, cluster_sweep_device_ms=sweep,
                               iterations_device_ms=by_iters)
    return list(results.values()), launches


def _lio_small_cfg(cfgmod, gn_backend):
    """__graft_entry__._tiny_cfg, on the branch `gn_backend` picks."""
    return cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(max_range=30.0, min_range=0.5, max_points=2048),
        map=cfgmod.MapConfig(voxel_size=0.5, max_range=30.0, capacity=1 << 12, max_probes=16,
                             store_points=gn_backend == "xla"),
        icp=cfgmod.IcpConfig(max_map_points=1024, max_source_points=512, max_iterations=20,
                             gn_backend=gn_backend),
        ekf=cfgmod.EkfConfig(lidar_pose_trail=4),
        imu=cfgmod.ImuConfig(max_init_count=20, max_samples_per_scan=32),
    )


def _imu_packets(gt, cap, device):
    """bench.py:_bench_lio's IMU: 100 Hz samples of the trajectory, packet i
    the samples in [0.1 i, 0.1 (i + 1)), at most 10, times + 1 ms."""
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import lio

    stream = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)
    return [lio.pack_imu_packet(*p, cap, device=device)
            for p in synthetic.imu_packets(*stream, len(gt))]


def small_lio_phase(dev):
    """The tiny LIO deployment on the card and on the CPU, both branches,
    over scans on which static init completes and the IMU branch runs."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import lio
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

    n = 8
    world = synthetic.make_world(seed=11, n_points=30000, extent=(40.0, 12.0, 5.0))
    gt = synthetic.make_trajectory(n_poses=n, speed=3.0, yaw_rate=0.02, dt=0.1)
    for backend in ("xla", "pallas"):
        cfg = _lio_small_cfg(cfgmod, backend)
        packets = {d: _imu_packets(gt, cfg.imu.max_samples_per_scan, d) for d in (dev, "cpu")}
        states = {d: lio.init_state(cfg, d) for d in (dev, "cpu")}
        worst, used = 0.0, []
        _common.reset_launches()
        for i in range(n):
            pts, rel = synthetic.render_scan_rolling(world, gt[i], gt[min(i + 1, n - 1)], 0.1,
                                                     1500, 0.5, 30.0, noise=0.01, seed=i)
            poses = {}
            for d in (dev, "cpu"):
                raw = pack_raw_scan(pts, time=i * 0.1 + rel, stamp=i * 0.1, max_points=2048,
                                    device=d)
                states[d], out = lio.step_donated(states[d], preprocess_scan(raw, cfg.lidar),
                                                  packets[d][i], cfg)
                poses[d] = out.pose.cpu().numpy()
            used.append(bool(out.used_imu))
            worst = max(worst, float(np.abs(poses[dev] - poses["cpu"]).max()))
        launches = dict(_common.LAUNCHES)
        print(f"small LIO drive ({backend}): card vs CPU max|d pose| {worst:.3e} (tol 1e-4); "
              f"used_imu {used}; launches {launches}")
        _require(worst <= 1e-4, f"small LIO drive ({backend}): card and CPU poses disagree")
        _require(sum(used) >= n - 3, f"small LIO drive ({backend}): the IMU branch ran "
                 f"{sum(used)} times")
        _require(launches["imu_deskew"] == sum(used),
                 f"small LIO drive ({backend}): the IMU deskew kernel did not run once per "
                 "IMU-branch scan")
        if backend == "pallas":
            _require(launches["pose_pre"] == launches["pose_post"] == n,
                     "small LIO drive: K2 / K3 did not run once per scan")
        else:
            _require(not any(v for k, v in launches.items() if k != "imu_deskew"),
                     "small LIO drive (xla) launched a registration kernel")


def lio_cfg(cfg):
    """bench.py:_bench_lio's deployment: the HDL-64E fast config with a
    16-sample IMU packet, a 2-pose trail and the ICP-tuned pose noise."""
    return cfg.replace(
        imu=dataclasses.replace(cfg.imu, max_samples_per_scan=LIO_IMU_CAP),
        ekf=dataclasses.replace(cfg.ekf, lidar_pose_trail=2, lidar_pos_noise=0.02,
                                lidar_ori_noise=0.005),
    )


def lio_slice_phase(dev, cfg, raws, gt):
    """bench.py:_bench_lio on the card: 120 HDL-64E scans with 100 Hz IMU
    packets through lio.step_donated, eviction and conditional compaction
    every 10 scans. Host reads by call site and ops dispatched, per scan
    over scans 0-19; launch counters zeroed just before the timed 120-scan
    run and read just after. Returns the drive's numbers."""
    import torch

    from lidar_imu_slam_tpu_torch.models import ekf, lio
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    cfg = lio_cfg(cfg)
    body = cfg.replace(map=dataclasses.replace(cfg.map, auto_evict=False, auto_rebuild=False))
    cap = cfg.map.capacity
    packets = _imu_packets(gt, LIO_IMU_CAP, dev)

    def run(n_scans, counter=None):
        state = lio.init_state(cfg, dev)
        outs, ms = [], []
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        with _counting(counter):  # the steps' own host reads and ops, not the set-up's
            for i in range(n_scans):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                state, out = lio.step_donated(state, preprocess_scan(raws[i], body.lidar),
                                              packets[i], body)
                if (i + 1) % BLOCK == 0:
                    m = voxel_map.evict_far(state.odo.map, state.odo.pose[:3, 3], cfg.map,
                                            inplace=True)
                    if bool((m.next_slot > cap - cap // 4) & (m.tombstones > cap // 16)):
                        m = voxel_map.rebuild(m, cfg.map)
                    state = state._replace(odo=state.odo._replace(map=m))
                ev1.record()
                outs.append((out.pose, out.icp_iterations, out.imu_initialized, out.used_imu))
                ms.append((ev0, ev1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        step_ms = np.array([a.elapsed_time(b) for a, b in ms])
        poses, iters, inited, used = (torch.stack(x).cpu().numpy() for x in zip(*outs))
        return state, poses, iters, inited, used, wall, step_ms

    run(3)  # warm-up on a throwaway state
    counts = _reads_and_ops(run)
    _common.reset_launches()
    state, poses, iters, inited, used, wall, step_ms = run(N_SCANS)
    launches = dict(_common.LAUNCHES)
    _require(np.isfinite(poses).all(), "LIO slice: non-finite pose")
    ate = _ate(poses, gt, shift=1.0)
    init_scan = int(np.argmax(inited)) if inited.any() else -1
    stats = dict(scans_per_s=N_SCANS / wall, p50_ms=float(np.percentile(step_ms, 50)),
                 p95_ms=float(np.percentile(step_ms, 95)), ate_m=ate,
                 icp_iterations=float(iters.mean()),
                 imu_deskew_launches=launches["imu_deskew"], **counts)
    print(f"LIO slice: {stats['scans_per_s']:.2f} scans/s  p50 {stats['p50_ms']:.3f} ms  "
          f"p95 {stats['p95_ms']:.3f} ms per scan (CUDA events)")
    print(f"LIO slice: ICP iterations mean {iters.mean():.2f} max {iters.max()} (JAX 6.57 / 28, "
          f"BENCH_r05)  imu_initialized from scan {init_scan}  used_imu on {int(used.sum())} "
          f"scans  map voxels {int(voxel_map.num_voxels(state.odo.map))}  launches {launches}")
    print(_reads_ops_line("LIO slice", counts))
    print(f"LIO slice: ATE {ate:.4f} m (scan end, shift 1.0; JAX 0.2075, BENCH_r05; limit "
          f"{LIO_ATE_LIMIT_M})")
    _require(init_scan >= 0, "LIO slice: the IMU static initialization never completed")
    _require(bool(used[init_scan + 1:].all()), "LIO slice: a scan after init skipped the IMU")
    _require(launches["pose_pre"] == N_SCANS and launches["pose_post"] == N_SCANS,
             "LIO slice: K2 / K3 did not run once per scan")
    _require(launches["fused_gn_carry"] > 0, "LIO slice: K1 never launched")
    _require(launches["imu_deskew"] == int(used.sum()),
             "LIO slice: the IMU deskew kernel did not run once per IMU-branch scan")
    _require(ate <= LIO_ATE_LIMIT_M, f"LIO slice: ATE {ate:.4f} m above {LIO_ATE_LIMIT_M}")

    # the deskew kernel on the path's own inputs (no stream axis, 131,072
    # points, a 17-entry trail) against the plain per-point pass
    kernel_pass, seen = ekf.deskew_points, []

    def checked(*args):
        out = kernel_pass(*args)
        ref = ekf.deskew_points_plain(*args)
        seen.append((tuple(args[0].shape), args[3].shape[-1],
                     int((out.view(torch.int32) != ref.view(torch.int32)).sum())))
        return out

    ekf.deskew_points = checked
    try:
        run(init_scan + 3)
    finally:
        ekf.deskew_points = kernel_pass
    print(f"LIO slice: deskew kernel against the plain pass on the path (points, trail "
          f"entries, coordinates that differ): {seen}")
    _require(len(seen) >= 2 and not any(d for _, _, d in seen),
             "LIO slice: the deskew kernel's points differ from the plain pass's on the path")
    return stats


def _runner_fields(out, fields) -> list:
    """One scan's pose and kept outputs, copied to the host at once."""
    return [out.pose.cpu().numpy()] + [float(getattr(out, f)) for f in fields]


def _assert_like_hand_loop(what, runner, hand, fields):
    """The runner's poses and metrics bit-equal to the hand loop's."""
    poses = np.stack(runner.poses)
    same = np.array_equal(poses, np.stack([h[0] for h in hand]))
    for rec, h in zip(runner.metrics.records, hand):
        same = same and all(rec[f] == v for f, v in zip(fields, h[1:]))
    print(f"{what}: poses and metrics bit-equal to the hand loop's (a copy a scan): {same}")
    _require(same, f"{what}: the deferred fetch disagrees with the hand loop")


def _maybe_rebuild_like_runner(m, cfg, i):
    """`OdometryRunner._maybe_rebuild`'s check, for the hand loops."""
    from lidar_imu_slam_tpu_torch.ops import voxel_map

    cap = cfg.map.capacity
    if i % 64 == 0 and i:
        tombs, cursor = int(m.tombstones), int(m.next_slot)
        if tombs > cap // 8 or (cursor > cap - cap // 4 and tombs > 0):
            return voxel_map.rebuild(m, cfg.map)
    return m


class _InlineExecutor:
    """A one-worker executor that runs each task at once on the calling
    thread (the runner without its prefetch thread)."""

    def __init__(self, max_workers=1):
        pass

    def submit(self, fn, *args):
        import concurrent.futures

        fut = concurrent.futures.Future()
        fut.set_result(fn(*args))
        return fut

    def shutdown(self, **kw):
        pass


def _pageable_to_device(arrays, device):
    """`preprocess.to_device` as a copy from pageable memory (the upload
    before the runner slice), for the comparison in the runner phase."""
    import torch

    return [torch.from_numpy(a).to(device) for a in arrays]


def _timed_run(make_runner, drive, launches=False):
    """One run of a fresh runner: wall seconds, host reads by call site
    (sync debug mode "warn" over the whole run, the worker thread's too)
    and, with `launches`, the kernel launches counted over the run."""
    import warnings

    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import _common

    runner = make_runner()
    torch.cuda.synchronize()
    if launches:
        _common.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            drive(runner)  # ends in the one copy of the run's outputs
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    counts = dict(_common.LAUNCHES) if launches else None
    sites = _sites(caught)
    return runner, wall, sites, counts


def _layer_timed(cls):
    """`cls` with the runner layer's host times recorded: `_pack` (pack,
    upload, preprocess, on the worker thread) and `_collect` (the one
    fetch at the end), host clock, no synchronize."""

    class Timed(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.pack_s, self.collect_s = [], []

        def _pack(self, msg):
            t0 = time.perf_counter()
            scan = super()._pack(msg)
            self.pack_s.append(time.perf_counter() - t0)
            return scan

        def _collect(self, *a):
            t0 = time.perf_counter()
            super()._collect(*a)
            self.collect_s.append(time.perf_counter() - t0)

    return Timed


def _pack_device_ms(runner, msg, reps: int = 3):
    """The card's time for `runner._pack(msg)` (upload + preprocess): the
    stream sleeps while the host queues `reps` packs; None when queueing
    outlasted half the sleep (then the events would time the host)."""
    import torch

    from lidar_imu_slam_tpu_torch.tools import probes as tp

    runner._pack(msg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(tp.SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        runner._pack(msg)
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return None if queued * 1e3 >= 0.5 * tp.SLEEP_MS else start.elapsed_time(end) / reps


def _layer_line(what, runner, wall, n, msg) -> str:
    """The runner layer's numbers (PERF.md §3): pack + upload + preprocess
    per scan on the worker (host) and on the card, the host time per scan
    outside the step (the wait for the prefetch and the loop's
    bookkeeping), the final fetch."""
    dev_ms = _pack_device_ms(runner, msg)
    outside = (wall - sum(runner.timer.samples) - sum(runner.collect_s)) / n
    return (f"{what} layer: pack + upload + preprocess {np.mean(runner.pack_s) * 1e3:.3f} ms "
            f"host (worker thread, p50 {np.median(runner.pack_s) * 1e3:.3f}), "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} device; outside the "
            f"step {outside * 1e3:.3f} ms a scan (host); the final fetch "
            f"{sum(runner.collect_s) * 1e3:.3f} ms for {n} scans (host)")


def _runner_line(what, runner, wall, sites, n) -> str:
    return (f"{what}: {n / wall:.2f} scans/s (host clock, the final fetch included); "
            f"StepTimer p50 {runner.timer.p50 * 1e3:.3f} ms p95 {runner.timer.p95 * 1e3:.3f} ms "
            f"(host clock per step, no sync); host reads per scan {sum(sites.values()) / n:.2f} "
            f"by call site {dict(sites.most_common(8))}")


def runner_phase(dev, cfg, msgs, gt, direct):
    """`OdometryRunner(cfg, device).run` over the 120 HDL-64E scan
    messages under the deployment's own config (in-step eviction and
    `auto_rebuild`): bit-equal to a hand loop that makes the same calls
    and copies each scan's outputs at once; ATE, scans/s, StepTimer p50 /
    p95, host reads by call site, launches (K2 / K3 once a scan, K1); then
    the same run with the upload from pageable memory, beside the direct
    loop's p50 of the slice phase."""
    from lidar_imu_slam_tpu_torch.host import runner as runner_mod
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import preprocess

    t_phase = time.perf_counter()
    fields = runner_mod.ODOMETRY_FIELDS

    def make():
        return _layer_timed(runner_mod.OdometryRunner)(cfg, device=dev)

    def drive(r):
        r.run(iter(msgs))

    make().run(iter(msgs[:3]))  # warm-up: the worker thread's first CUDA work
    runner, wall, sites, launches = _timed_run(make, drive, launches=True)
    n = len(runner.poses)
    poses = np.stack(runner.poses)
    _require(n == N_SCANS and np.isfinite(poses).all(), "runner: poses missing or not finite")
    ate = _ate(poses, gt, shift=0.5)
    print(_runner_line("runner", runner, wall, sites, n))
    print(_layer_line("runner", runner, wall, n, msgs[0]))
    print(f"runner: ATE {ate:.4f} m (mid-scan, limit {ATE_LIMIT_M}); launches {launches}")
    print(f"runner: the direct loop of the slice phase: p50 {direct['p50_ms']:.3f} ms "
          f"(CUDA events), {direct['scans_per_s']:.2f} scans/s")

    state = kiss_icp.init_state(cfg, dev)
    hand = []
    t0 = time.perf_counter()
    for i, m in enumerate(msgs):
        scan = preprocess.preprocess_scan(preprocess.pack_raw_scan(
            m["xyz"], time=m["time"], stamp=m["stamp"], max_points=cfg.lidar.max_points,
            device=dev), cfg.lidar)
        state, out = kiss_icp.register_frame_step(state, scan, cfg)
        hand.append(_runner_fields(out, fields))
        state = state._replace(map=_maybe_rebuild_like_runner(state.map, cfg, i))
    print(f"runner: the hand loop (the same calls on one thread, a copy a scan) "
          f"{n / (time.perf_counter() - t0):.2f} scans/s")
    _assert_like_hand_loop("runner", runner, hand, fields)

    # what the prefetch and the upload are worth here: the runner as it
    # is, with the upload from pageable memory, with the pack on the main
    # thread, and with the slice phase's config (no in-step eviction, no
    # compaction check); two turns, one run of each a turn
    body = cfg.replace(map=dataclasses.replace(cfg.map, auto_evict=False, auto_rebuild=False))
    variants = (("as it is", make, None, None),
                ("upload from pageable memory", make, "to_device", _pageable_to_device),
                ("pack on the main thread", make, "executor", _InlineExecutor),
                ("no in-step eviction or compaction check",
                 lambda: runner_mod.OdometryRunner(body, device=dev), None, None))
    turns = collections.defaultdict(list)
    for turn in range(2):
        for what, maker, swap, repl in variants:
            owner = preprocess if swap == "to_device" else runner_mod.concurrent.futures
            attr = "to_device" if swap == "to_device" else "ThreadPoolExecutor"
            kept = getattr(owner, attr)
            if swap:
                setattr(owner, attr, repl)
            try:
                other, wall_v, sites_v, _ = _timed_run(maker, drive)
            finally:
                setattr(owner, attr, kept)
            if turn == 0 and swap == "to_device":  # its upload's reads by call site
                print(_runner_line(f"runner ({what})", other, wall_v, sites_v, n))
            turns[what].append(f"{n / wall_v:.2f} scans/s, StepTimer p50 "
                               f"{other.timer.p50 * 1e3:.3f} ms, reads/scan "
                               f"{sum(sites_v.values()) / n:.2f}")
    for what, runs in turns.items():
        print(f"runner turns ({what}): " + " | ".join(runs))
    print(f"runner: phase {time.perf_counter() - t_phase:.1f} s")
    for name in ("fused_gn_carry", "pose_pre", "pose_post"):
        _require(launches[name] > 0, f"runner: kernel {name} never launched")
    _require(launches["pose_pre"] == N_SCANS and launches["pose_post"] == N_SCANS,
             "runner: pose kernels did not run once per scan")
    _require(ate <= ATE_LIMIT_M, f"runner: ATE {ate:.4f} m above {ATE_LIMIT_M}")
    return dict(reads_per_scan=sum(sites.values()) / n, pack_ms=float(np.mean(runner.pack_s)) * 1e3)


def _imu_rows(gt):
    """The 100 Hz IMU stream of the trajectory as (t, gyro, acc) rows, its
    times + 1 ms (off the scan boundaries, as bench.py:_bench_lio's
    packets)."""
    from lidar_imu_slam_tpu_torch.host import synthetic

    t, gyro, acc = synthetic.make_imu_stream(gt, 0.1, imu_rate=100.0)
    return np.column_stack([t + 1e-3, gyro, acc])


def lio_runner_phase(dev, cfg, msgs, gt, direct):
    """`LioRunner(lio_cfg, device).run_lio` over the same scan messages and
    the 100 Hz IMU stream as rows: bit-equal to a hand loop (the same
    synchronizer bucketing, a copy a scan); scan-end ATE, used_imu after
    static init, no IMU overflow, scans/s, StepTimer p50 / p95, host reads
    by call site, launches, beside the LIO slice's direct loop."""
    from lidar_imu_slam_tpu_torch.host import runner as runner_mod
    from lidar_imu_slam_tpu_torch.host.stream_sync import StreamSynchronizer
    from lidar_imu_slam_tpu_torch.models import lio
    from lidar_imu_slam_tpu_torch.ops import preprocess

    t_phase = time.perf_counter()
    cfg = lio_cfg(cfg)
    fields = runner_mod.LIO_FIELDS
    imu = _imu_rows(gt)

    def make():
        return _layer_timed(runner_mod.LioRunner)(cfg, device=dev)

    def drive(r):
        r.run_lio(iter(msgs), imu)

    runner, wall, sites, launches = _timed_run(make, drive, launches=True)
    n = len(runner.poses)
    poses = np.stack(runner.poses)
    _require(n == N_SCANS and np.isfinite(poses).all(), "LIO runner: poses missing or not finite")
    recs = runner.metrics.records
    inited = np.array([r["imu_initialized"] for r in recs]) > 0
    used = np.array([r["used_imu"] for r in recs]) > 0
    overflow = sum(r["imu_overflow"] for r in recs)
    init_scan = int(np.argmax(inited)) if inited.any() else -1
    ate = _ate(poses, gt, shift=1.0)
    print(_runner_line("LIO runner", runner, wall, sites, n))
    print(_layer_line("LIO runner", runner, wall, n, msgs[0]))
    print(f"LIO runner: ATE {ate:.4f} m (scan end, limit {LIO_ATE_LIMIT_M}); imu_initialized "
          f"from scan {init_scan}, used_imu on {int(used.sum())} scans, imu_overflow {overflow}; "
          f"launches {launches}")
    print(f"LIO runner: the direct loop of the LIO slice phase: p50 {direct['p50_ms']:.3f} ms "
          f"(CUDA events), {direct['scans_per_s']:.2f} scans/s")

    state = lio.init_state(cfg, dev)
    sync = StreamSynchronizer(cfg.imu)
    cap, cursor, hand = cfg.imu.max_samples_per_scan, 0, []
    t0 = time.perf_counter()
    for i, m in enumerate(msgs):
        t_end = runner_mod.LioRunner._host_t_end(m)
        if not sync.offset_set:
            sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
            cursor += 1
        sync.push_scan(m["stamp"])
        while cursor < len(imu) and imu[cursor, 0] - sync.time_offset <= t_end:
            sync.push_imu(imu[cursor, 0], imu[cursor, 1:4], imu[cursor, 4:7])
            cursor += 1
        take = sync.take_until(t_end, cap)
        scan = preprocess.preprocess_scan(preprocess.pack_raw_scan(
            m["xyz"], time=m["time"], stamp=m["stamp"], max_points=cfg.lidar.max_points,
            device=dev), cfg.lidar)
        packet = lio.pack_imu_packet(take[:, 0], take[:, 1:4], take[:, 4:7], cap, device=dev)
        state, out = lio.step_donated(state, scan, packet, cfg)
        hand.append(_runner_fields(out, fields))
        odo = state.odo._replace(map=_maybe_rebuild_like_runner(state.odo.map, cfg, i))
        state = state._replace(odo=odo)
    print(f"LIO runner: the hand loop (the same calls on one thread, a copy a scan) "
          f"{n / (time.perf_counter() - t0):.2f} scans/s")
    _assert_like_hand_loop("LIO runner", runner, hand, fields)
    print(f"LIO runner: phase {time.perf_counter() - t_phase:.1f} s")
    _require(init_scan >= 0, "LIO runner: the IMU static initialization never completed")
    _require(bool(used[init_scan + 1:].all()), "LIO runner: a scan after init skipped the IMU")
    _require(overflow == 0, f"LIO runner: {overflow} IMU samples dropped")
    _require(launches["pose_pre"] == N_SCANS and launches["pose_post"] == N_SCANS,
             "LIO runner: K2 / K3 did not run once per scan")
    _require(launches["fused_gn_carry"] > 0, "LIO runner: K1 never launched")
    _require(ate <= LIO_ATE_LIMIT_M, f"LIO runner: ATE {ate:.4f} m above {LIO_ATE_LIMIT_M}")


def _cli(args, tmp) -> tuple[dict, float]:
    """`python -m lidar_imu_slam_tpu_torch.cli ARGS` in a process of its
    own (from this checkout); its summary line and wall seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lidar_imu_slam_tpu_torch.cli", *args],
                          cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    _require(proc.returncode == 0, f"cli {' '.join(args)}: exit {proc.returncode}\n"
             f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def _cli_counted(args, dev) -> None:
    """`cli.main(ARGS, device)` in this process with host reads counted by
    call site (sync debug mode "warn"): scans/s on the host clock from the
    parse of the arguments to the summary line, and the summary's p50 /
    p95 step ms."""
    import contextlib
    import io
    import warnings

    import torch

    from lidar_imu_slam_tpu_torch import cli

    out = io.StringIO()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli.main(args, device=dev)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    _require(rc == 0, f"cli.main {' '.join(args)}: exit {rc}")
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    n = summary["scans"]
    sites = _sites(caught)
    print(f"cli {args[0]} {args[1]} in this process: {n / wall:.2f} scans/s (host clock, the "
          f"synthetic scans rendered on the way); p50 {summary['p50_step_ms']} ms p95 "
          f"{summary['p95_step_ms']} ms a step; host reads per scan {sum(sites.values()) / n:.2f} "
          f"by call site {dict(sites.most_common(8))}")


def cli_phase(dev, msgs, gt):
    """The CLI as its users start it, at full width (the `kitti` preset:
    131,072 points, a 2^18-slot map, the fast path): `--synthetic 40` with
    the trajectory, metrics and clouds written; then `--bag --lio` on a
    bag of the first 30 HDL-64E scans and their 100 Hz IMU
    (`tools/bag_writer.py`)."""
    import tempfile

    from lidar_imu_slam_tpu_torch.tools import bag_writer
    from lidar_imu_slam_tpu_torch.utils import cloud_io

    with tempfile.TemporaryDirectory() as tmp:
        summary, wall = _cli(["--synthetic", "40", "--out", "traj.tum", "--metrics-out",
                              "m.jsonl", "--save-clouds", "c", "--save-clouds-every", "10"], tmp)
        tum = open(os.path.join(tmp, "traj.tum")).read().splitlines()
        recs = open(os.path.join(tmp, "m.jsonl")).read().splitlines()
        plys = sorted(os.listdir(os.path.join(tmp, "c")))
        finite = all(np.isfinite(cloud_io.read_ply(os.path.join(tmp, "c", f))).all()
                     for f in plys)
        print(f"cli --synthetic 40: {wall:.1f} s with the process start; summary {summary}; "
              f"{len(tum)} TUM lines, {len(recs)} metrics records, {len(plys)} PLY files, all "
              f"finite: {finite}")
        _require(summary["scans"] == 40 and len(tum) == 40 and len(recs) == 40,
                 "cli --synthetic 40: not one pose and record a scan")
        _require(summary["ate_rmse_m"] <= ATE_LIMIT_M,
                 f"cli --synthetic 40: ATE {summary['ate_rmse_m']} m above {ATE_LIMIT_M}")
        _require(len(plys) == 9 and finite, "cli --synthetic 40: clouds missing or not finite")
        _cli_counted(["--synthetic", "40", "--out", os.path.join(tmp, "again.tum")], dev)

        n_bag = min(30, len(msgs))
        t0 = time.perf_counter()
        imu = _imu_rows(gt)
        bag_writer.write_bag(os.path.join(tmp, "drive.bag"), msgs[:n_bag],
                             imu[imu[:, 0] <= n_bag * 0.1])
        t_write = time.perf_counter() - t0
        summary, wall = _cli(["--bag", "drive.bag", "--lio", "--out", "bag.tum"], tmp)
        tum = open(os.path.join(tmp, "bag.tum")).read().splitlines()
        print(f"cli --bag --lio: bag of {n_bag} scans written in {t_write:.1f} s, "
              f"{os.path.getsize(os.path.join(tmp, 'drive.bag')) / 1e6:.1f} MB; the CLI "
              f"{wall:.1f} s with the process start and the bag's decoding; summary {summary}; "
              f"{len(tum)} TUM lines")
        _require(summary["scans"] == n_bag and len(tum) == n_bag,
                 "cli --bag --lio: not one pose a scan")


# ---------------------------------------------------------------------------
# phases 16-21: the loop-closure backend, the solvers, the oracle, the
# profiling helpers, the native packer and the CLI's --loop-closure
# ---------------------------------------------------------------------------

CIRCUIT_SCANS = 200  # phase 16: one closed circuit of HDL-64E scans
CIRCUIT_SPEED = 4.0  # m/s, dt 0.1: 80 m round a ~12.7 m radius
# BackendConfig's verify thresholds (0.3 m residual, 50 correspondences)
# verified no loop on this circuit on the card: the three candidates
# registered at 0.613-0.633 m rms over 5,408-5,727 correspondences, two
# samplings of the same surfaces ~1 m apart (PERF.md). Only those
# two fields change, to tests/test_online_backend.py's values.
VERIFY_OVERRIDE = dict(verify_max_residual=0.65, verify_min_correspondences=150)


def render_circuit():
    """Phase 16's drive: 200 rolling-shutter HDL-64E scans (2.5-80 m) on one
    closed circle, 4 m/s at dt 0.1 with a yaw rate of 2 pi / 199 a scan,
    centred in `make_world(seed=0, n_points=600_000, extent=(40, 40, 12))`
    (x in [-10, 40], y in [-40, 40]): host messages and the ground truth."""
    from lidar_imu_slam_tpu_torch.host import synthetic

    t0 = time.perf_counter()
    n = CIRCUIT_SCANS
    world = synthetic.make_world(seed=0, n_points=600_000, extent=(40.0, 40.0, 12.0))
    yaw_rate = 2 * np.pi / (n - 1)
    gt = synthetic.make_trajectory(n_poses=n, speed=CIRCUIT_SPEED, yaw_rate=yaw_rate,
                                   dt=0.1, ramp=1)
    radius = CIRCUIT_SPEED * 0.1 / yaw_rate
    gt[:, :3, 3] += np.array([15.0, -radius, 0.0])  # centre (15, 0)
    msgs = []
    for i in range(n):
        pts, rel = synthetic.render_scan_rolling(
            world, gt[i], gt[min(i + 1, n - 1)], 0.1, POINTS_PER_SCAN, 2.5, 80.0,
            noise=0.02, seed=1000 + i)
        msgs.append({"xyz": pts, "time": i * 0.1 + rel, "stamp": i * 0.1})
    print(f"backend: rendered the {n}-scan circuit (radius {radius:.2f} m, closing gap "
          f"{np.linalg.norm(gt[-1, :3, 3] - gt[0, :3, 3]):.3f} m) in "
          f"{time.perf_counter() - t0:.1f} s")
    return msgs, gt


def circuit_cfg(cfgmod, backend: bool = True):
    """`config.kitti_64beam()` (131,072 points, a 2^18-slot map with the f32
    slab, the fast path) with `BackendConfig(enabled=True)` at its defaults
    (512 keyframes, 2048 edges, `auto` -> cg, 64 CG / 10 LM iterations,
    chunk 8) but for the verify thresholds (`VERIFY_OVERRIDE`)."""
    cfg = cfgmod.kitti_64beam()
    if backend:
        cfg = cfg.replace(backend=cfgmod.BackendConfig(enabled=True, **VERIFY_OVERRIDE))
    return cfg


def _pose_diff(a, b) -> tuple[float, float]:
    """Max translation (m) and rotation (rad) difference of two pose stacks."""
    dt = float(np.abs(a[..., :3, 3] - b[..., :3, 3]).max())
    rel = np.swapaxes(a[..., :3, :3], -1, -2) @ b[..., :3, :3]
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    # arccos loses precision near 0: the skew part's norm is the sine
    skew = np.stack([rel[..., 2, 1] - rel[..., 1, 2], rel[..., 0, 2] - rel[..., 2, 0],
                     rel[..., 1, 0] - rel[..., 0, 1]], -1) / 2.0
    dr = float(np.arctan2(np.linalg.norm(skew, axis=-1), cos).max())
    return dt, dr


def _reads_of(fn):
    """fn()'s result and the host reads it made, by call site."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, _sites(caught)


def _graph_to(g, device):
    from lidar_imu_slam_tpu_torch.models import backend as backend_mod

    return backend_mod.PoseGraph(*(t.to(device) for t in g[:7]), num_nodes=g.num_nodes,
                                 num_edges=g.num_edges)


def backend_phase(dev, cfgmod, msgs, gt, runner_reads):
    """Phase 16: `OdometryRunner(circuit_cfg, device).run` over the circuit
    as host messages, beside the same runner without the backend. The raw
    poses bit-equal, K2 / K3 once a scan and K1 launched; at least one
    verified loop edge (j - i >= min_index_gap), `optimized_poses()`
    finite, mid-scan ATE of the corrected trajectory at most 1.05 x the
    raw one + 1e-6; host reads by call site, each optimize()'s and each
    verification's host time. Then the backend's last graph re-optimized
    with cg and dense on the card and on the CPU, twice on the card, and
    the reads of one optimize() counted."""
    import torch

    from lidar_imu_slam_tpu_torch.host import keyframes
    from lidar_imu_slam_tpu_torch.host import runner as runner_mod
    from lidar_imu_slam_tpu_torch.models import backend as backend_mod

    t_phase = time.perf_counter()
    cfg = circuit_cfg(cfgmod)
    bcfg = cfg.backend
    n = len(msgs)
    opt_s, verify_s, verified, graphs = [], [], [], []

    class TimedBackend(keyframes.OnlineBackend):
        def optimize(self):
            t0 = time.perf_counter()
            super().optimize()  # ends in the copy of the optimized poses
            opt_s.append(time.perf_counter() - t0)

    def timed_verify(*a, **kw):
        t0 = time.perf_counter()
        res = verify_pair(*a, **kw)  # the classic ICP: a host read an iteration
        verify_s.append(time.perf_counter() - t0)
        verified.append(res)  # read after the counted run
        return res

    def keep_graph(solver):
        def run(g, *a, **kw):
            out = solver(g, *a, **kw)
            graphs.append((solver.__name__, g, out))
            return out
        return run

    plain = runner_mod.OdometryRunner(circuit_cfg(cfgmod, backend=False), device=dev)
    t0 = time.perf_counter()
    plain.run(iter(msgs))
    wall_plain = time.perf_counter() - t0

    verify_pair = keyframes.verify_pair
    patched = ((runner_mod, "OnlineBackend", TimedBackend),
               (keyframes, "verify_pair", timed_verify),
               (backend_mod, "optimize_cg", keep_graph(backend_mod.optimize_cg)),
               (backend_mod, "optimize", keep_graph(backend_mod.optimize)))
    kept = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patched]
    try:
        for owner, attr, repl in patched:
            setattr(owner, attr, repl)
        runner, wall, sites, launches = _timed_run(
            lambda: runner_mod.OdometryRunner(cfg, device=dev), lambda r: r.run(iter(msgs)),
            launches=True)
    finally:
        for owner, attr, orig in kept:
            setattr(owner, attr, orig)

    be = runner.backend
    raw = np.stack(runner.poses)
    same = np.array_equal(raw, np.stack(plain.poses))
    opt = runner.optimized_poses()
    ate_raw, ate_opt = _ate(raw, gt, shift=0.5), _ate(opt, gt, shift=0.5)
    edges = [(i, j, be.kf_scan_idx[i], be.kf_scan_idx[j]) for i, j, _, _ in be.loop_edges]
    print(f"backend: {n} scans in {wall:.1f} s with the backend ({n / wall:.2f} scans/s, host "
          f"clock, the final optimize and fetch included), {wall_plain:.1f} s without "
          f"({n / wall_plain:.2f} scans/s); raw poses bit-equal to the run without the "
          f"backend: {same}")
    print(f"backend: keyframes {len(be.kf_poses)}, loop edges {len(edges)} (keyframe i, j; "
          f"scan i, j) {edges}, optimizations {be.num_optimizations}, thin events "
          f"{be.thin_events}, dropped keyframes {be.dropped_keyframes}, candidates verified "
          f"{len(verify_s)}")
    print(f"backend: ATE (mid-scan) raw {ate_raw:.4f} m, corrected {ate_opt:.4f} m (bar "
          f"{1.05 * ate_raw + 1e-6:.4f}); launches {launches}")
    print(f"backend: host reads per scan {sum(sites.values()) / n:.2f} (phase 13's runner: "
          f"{runner_reads:.2f}) by call site {dict(sites.most_common(10))}")
    print("backend: optimize() host ms " + " ".join(f"{s * 1e3:.1f}" for s in opt_s))
    print("backend: verification host ms " + " ".join(f"{s * 1e3:.1f}" for s in verify_s))
    print("backend: verifications (residual rms m, correspondences, GN iterations; accepted "
          f"under {bcfg.verify_max_residual} m with >= {bcfg.verify_min_correspondences}) "
          + " ".join(f"({float(r.residual_rms):.3f}, {int(r.num_correspondences)}, "
                     f"{int(r.iterations)})" for r in verified))
    _require(same, "backend: the backend changed the raw odometry poses")
    _require(launches["pose_pre"] == n and launches["pose_post"] == n,
             "backend: K2 / K3 did not run once a scan")
    _require(launches["fused_gn_carry"] > 0, "backend: K1 never launched")
    _require(len(edges) >= 1, "backend: no loop edge verified")
    _require(all(j - i >= bcfg.min_index_gap for i, j, _, _ in edges),
             "backend: a loop edge closer than min_index_gap")
    _require(np.isfinite(opt).all(), "backend: optimized_poses() not finite")
    _require(ate_opt <= 1.05 * ate_raw + 1e-6,
             f"backend: corrected ATE {ate_opt:.4f} m above 1.05 x raw {ate_raw:.4f} m")

    # the last graph the backend optimized, three more ways
    name, g, out = graphs[-1]
    _require(name == "optimize_cg", f"backend: the auto solver ran {name}, not cg")
    lm, cgi = bcfg.lm_iterations, bcfg.cg_iterations
    card = {"cg": out.poses.cpu().numpy()}
    card["dense"] = backend_mod.optimize(g, iterations=lm).poses.cpu().numpy()
    g_cpu = _graph_to(g, "cpu")
    t0 = time.perf_counter()
    cpu = {"cg": backend_mod.optimize_cg(g_cpu, iterations=lm, cg_iterations=cgi).poses.numpy()}
    t_cg = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu["dense"] = backend_mod.optimize(g_cpu, iterations=lm).poses.numpy()
    t_dense = time.perf_counter() - t0
    k = g.num_nodes
    for s in ("cg", "dense"):
        dt, dr = _pose_diff(card[s][:k], cpu[s][:k])
        print(f"backend: last graph ({k} nodes, {g.num_edges} edges) {s}: card vs CPU "
              f"{dt:.3e} m / {dr:.3e} rad (tol 1e-8)")
        _require(dt <= 1e-8 and dr <= 1e-8, f"backend: {s} on the card and the CPU disagree")
    dt, dr = _pose_diff(card["cg"][:k], card["dense"][:k])
    print(f"backend: last graph cg vs dense on the card {dt:.3e} m / {dr:.3e} rad; the CPU's "
          f"cg {t_cg:.2f} s, dense {t_dense:.2f} s (host clock)")
    again = {"cg": backend_mod.optimize_cg(g, iterations=lm, cg_iterations=cgi).poses.cpu().numpy(),
             "dense": backend_mod.optimize(g, iterations=lm).poses.cpu().numpy()}
    for s in ("cg", "dense"):
        eq = np.array_equal(again[s], card[s])
        diff = "" if eq else f"; max |d| {np.abs(again[s] - card[s]).max():.3e}"
        print(f"backend: last graph {s} twice on the card: bit-equal {eq}{diff}")
    for s, fn in (("cg", lambda: backend_mod.optimize_cg(g, iterations=lm, cg_iterations=cgi)),
                  ("dense", lambda: backend_mod.optimize(g, iterations=lm))):
        _, reads = _reads_of(lambda: fn().poses.cpu())
        print(f"backend: host reads of one {s} optimize() and the copy of its poses: "
              f"{sum(reads.values())} by call site {dict(reads)}")
    del graphs
    torch.cuda.synchronize()
    print(f"backend: phase {time.perf_counter() - t_phase:.1f} s")
    return cfg


def _circle_graph_np(n, radius=10.0, yaw_err=0.006):
    """A circle of n poses (truth) and its drifted odometry (a per-step yaw
    error), tests/test_backend_scale.py's construction."""
    gt = []
    for k in range(n):
        th = 2 * np.pi * k / (n - 1)
        T = np.eye(4)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * np.sin(th), radius * (1 - np.cos(th)), 0.0]
        gt.append(T)
    gt = np.stack(gt)
    drift = np.eye(4)
    cd, sd = np.cos(yaw_err), np.sin(yaw_err)
    drift[:3, :3] = [[cd, -sd, 0], [sd, cd, 0], [0, 0, 1]]
    drift[:3, 3] = [0.015, 0, 0]
    drifted = [gt[0]]
    for k in range(1, n):
        drifted.append(drifted[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)
    return gt, np.stack(drifted)


def solver_phase(dev):
    """Phase 17: the solvers at their sizes, on the card and on the CPU.
    Dense: a 128-keyframe loop (H 768 x 768 f64), true chain and loop
    measurements from a drifted start. cg: tests/test_backend_scale.py's
    500-node double loop in a 512 / 1024 graph with three loop edges.
    BackendConfig's iterations (10 LM, 64 CG). graph_error < 1e-6 on both
    devices, card and CPU poses within 1e-8; per call: host clock (ending in
    a synchronize), CUDA events, peak device memory, aten ops dispatched."""
    import torch

    from lidar_imu_slam_tpu_torch.models import backend as backend_mod

    gt, drifted = _circle_graph_np(128)
    graphs = {}
    g = backend_mod.from_chain(gt, 128, 256, device="cpu")
    g = backend_mod.add_edge(g, 0, 127, np.linalg.inv(gt[0]) @ gt[-1], 50.0)
    graphs["dense"] = g._replace(poses=torch.as_tensor(drifted))
    n = 500
    th = np.linspace(0, 4 * np.pi, n)
    poses = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    poses[:, 0, 3] = 30 * np.sin(th)
    poses[:, 1, 3] = 30 * (1 - np.cos(th))
    g = backend_mod.from_chain(poses, 512, 1024, device="cpu")
    for k in (10, 100, 200):
        g = backend_mod.add_edge(g, k, k + n // 2,
                                 np.linalg.inv(poses[k]) @ poses[k + n // 2], 5.0)
    graphs["cg"] = g
    solve = {"dense": lambda g: backend_mod.optimize(g, iterations=10),
             "cg": lambda g: backend_mod.optimize_cg(g, iterations=10, cg_iterations=64)}
    for name, g_cpu in graphs.items():
        g_dev = _graph_to(g_cpu, dev)
        e0 = float(backend_mod.graph_error(g_dev))
        solve[name](g_dev)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        host_ms, ev_ms = [], []
        for _ in range(3):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            out = solve[name](g_dev)
            ev1.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(ev0.elapsed_time(ev1))
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        t0 = time.perf_counter()
        out_cpu = solve[name](g_cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err_dev, err_cpu = float(backend_mod.graph_error(out)), float(
            backend_mod.graph_error(out_cpu))
        k = g_cpu.num_nodes
        dt, dr = _pose_diff(out.poses.cpu().numpy()[:k], out_cpu.poses.numpy()[:k])
        print(f"solver {name}: {k} nodes / {g_cpu.num_edges} edges (H {6 * g_cpu.poses.shape[0]}"
              f"^2 f64 for dense): card {np.median(host_ms):.1f} ms host clock, "
              f"{np.median(ev_ms):.1f} ms CUDA events (median of 3), peak {peak:.1f} MiB above "
              f"the inputs; CPU {cpu_ms:.1f} ms; graph_error {e0:.3e} -> {err_dev:.3e} card, "
              f"{err_cpu:.3e} CPU; card vs CPU {dt:.3e} m / {dr:.3e} rad")
        counter = _op_counter()
        with counter:
            solve[name](g_dev)
        print(f"solver {name}: aten ops dispatched by one solve {counter.ops} "
              f"({counter.compute} not views)")
        _require(err_dev < 1e-6 and err_cpu < 1e-6, f"solver {name}: graph_error not < 1e-6")
        _require(dt <= 1e-8 and dr <= 1e-8, f"solver {name}: card and CPU disagree")


def oracle_phase(dev):
    """Phase 18: tests/test_torch_classic.py::test_port_tracks_the_oracle's
    drive on the card through the classic f64 path, against the port's
    copy of the numpy oracle in `match_jax` mode, with its bars (scans 0-7
    under 1e-4 m / rad, max under 5e-2 m, median under 1e-3 m)."""
    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import preprocess
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.validation import oracle as oracle_mod

    t0 = time.perf_counter()
    cfg = cfgmod.PipelineConfig(
        lidar=cfgmod.LidarConfig(num_scan_lines=16, max_points=4096, min_range=1.0,
                                 max_range=40.0),
        map=cfgmod.MapConfig(voxel_size=1.0, max_range=40.0, capacity=1 << 14,
                             neighborhood=27),
        icp=cfgmod.IcpConfig(deskew=False, max_map_points=4096, max_source_points=2048,
                             max_iterations=100),
    )
    world = synthetic.make_world(seed=3, n_points=120_000, extent=(70.0, 24.0, 8.0))
    gt = synthetic.make_trajectory(n_poses=52, speed=2.0, yaw_rate=0.02, dt=0.1)
    ocfg = oracle_mod.OracleConfig.match_jax(
        voxel_size=cfg.map.voxel_size, max_range=cfg.map.max_range,
        max_points_per_voxel=cfg.map.max_points_per_voxel,
        initial_threshold=cfg.icp.initial_threshold, min_motion_th=cfg.icp.min_motion_th,
        max_iterations=cfg.icp.max_iterations,
        estimation_threshold=cfg.icp.estimation_threshold)
    ocfg.min_correspondences = cfg.icp.min_correspondences
    ocfg.max_step_norm = cfg.icp.max_step_norm
    ocfg.max_model_deviation = cfg.icp.max_model_deviation
    odo = oracle_mod.ReferenceOdometry(ocfg)
    state = kiss_icp.init_state(cfg, dev)
    _common.reset_launches()
    rot, trans = [], []
    for i, pose in enumerate(gt):
        pts = synthetic.render_scan(world, pose, 3000, 1.0, 40.0, noise=0.01, seed=100 + i)
        scan = preprocess.preprocess_scan(preprocess.pack_raw_scan(
            pts, stamp=i * 0.1, max_points=4096, device=dev), cfg.lidar)
        state, out = kiss_icp.register_frame_step(state, scan, cfg)
        P = out.pose.cpu().numpy()
        O = odo.register_frame(scan.xyz.cpu().numpy()[scan.mask.cpu().numpy()].astype(np.float64))
        D = oracle_mod.inv(P) @ O
        rot.append(np.linalg.norm(oracle_mod.so3_log(D[:3, :3])))
        trans.append(np.linalg.norm(D[:3, 3]))
    rot, trans = np.asarray(rot), np.asarray(trans)
    print(f"oracle: card (classic f64) vs the numpy oracle (match_jax), 52 scans: scans 0-7 "
          f"max {trans[:8].max():.3e} m / {rot[:8].max():.3e} rad (bar 1e-4), max "
          f"{trans.max():.3e} m (bar 5e-2), median {np.median(trans):.3e} m (bar 1e-3); "
          f"{time.perf_counter() - t0:.1f} s")
    _require(trans[:8].max() < 1e-4 and rot[:8].max() < 1e-4, "oracle: early scans disagree")
    _require(trans.max() < 5e-2 and np.median(trans) < 1e-3, "oracle: the drive disagrees")
    _require(not any(_common.LAUNCHES.values()), "oracle: the classic path launched a kernel")


def profiling_phase(dev, cfg, msgs):
    """Phase 19: `utils/profiling.device_trace` around three scans of the
    phase-16 runner (the backend on). The exported trace must name the fast
    path's kernels and the spans the port opens itself (`annotate` on the
    step's layers), each step's spans inside its `kiss_icp.step`; the span
    gate must read true under `emit_nvtx`, whose NVTX ranges are the
    spans' own `record_function` ranges."""
    import tempfile

    import torch

    from lidar_imu_slam_tpu_torch.host import runner as runner_mod
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn
    from lidar_imu_slam_tpu_torch.utils import profiling

    step_spans = ("kiss_icp.deskew", "voxel_map.downsample", "kiss_icp.source",
                  "icp.register", "icp.fetch", "icp.gn", "voxel_map.insert", "voxel_map.evict")
    spans = ("runner.run", "kiss_icp.step", "backend.optimize") + step_spans
    # K1's kernel at this preset's shape (8192 x 80: spread over clusters)
    nc = cfg.map.neighborhood * cfg.map.packed_width
    k1 = ("gn_spread_kernel" if icp_gn.device_shape(cfg.icp.max_source_points, nc, dev)[0] > 1
          else "gn_cluster_kernel")
    kernels = (k1, "pose_pre_kernel", "pose_post_kernel")
    with tempfile.TemporaryDirectory() as tmp:
        r = runner_mod.OdometryRunner(cfg, device=dev)
        t0 = time.perf_counter()
        with profiling.device_trace(tmp) as prof:
            with profiling.annotate("runner.run"):
                r.run(iter(msgs[:3]))
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "trace.json")) as f:
            trace = json.load(f)
        size = os.path.getsize(os.path.join(tmp, "trace.json"))
    events = trace.get("traceEvents", [])
    names = [e.get("name", "") for e in events]
    cats = collections.Counter(e.get("cat", "") for e in events)
    found = {k: sum(k in nm for nm in names) for k in kernels}
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges[e["name"]].append((e["ts"], e["ts"] + e.get("dur", 0)))
    found.update({k: len(ranges[k]) for k in spans + ("preprocess.scan",)})
    outside = {k: sum(not any(s0 <= s and e <= e0 for s0, e0 in ranges["kiss_icp.step"])
                      for s, e in ranges[k]) for k in step_spans}
    device_total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    with torch.autograd.profiler.emit_nvtx():
        nvtx_gate = bool(profiling._profiler_enabled())
    print(f"profiling: device_trace of 3 scans with the backend, {wall:.2f} s with the trace; "
          f"trace {size / 1e6:.1f} MB, {len(names)} events by category "
          f"{dict(cats.most_common(8))}; events naming each kernel / span {found}; "
          f"step spans outside a kiss_icp.step {outside}; self device time in key_averages "
          f"{device_total / 1e3:.3f} ms; span gate under emit_nvtx {nvtx_gate}")
    missing = [k for k in kernels + spans if found[k] == 0]
    _require(not missing, f"profiling: the trace names no {missing}")
    _require(not any(outside.values()), f"profiling: spans outside their step: {outside}")
    _require(found["icp.gn"] == found["icp.fetch"] and found["kiss_icp.step"] >= 3,
             "profiling: each ICP round's fetch and GN call need one span each")
    _require(nvtx_gate, "profiling: the span gate reads false under emit_nvtx")


def native_phase(dev, cfg, msgs, runner_pack_ms):
    """Phase 20: the native packer (`host/native.py`, built by g++ into the
    port's build directory) on three HDL-64E scans against the port's
    `preprocess_scan` on the card (masks equal, xyz within 1e-6, rel_t
    within tests/test_native.py's bar), `voxel_downsample_native`'s
    first-wins rule, and the
    pack's host time beside phase 13's runner pack."""
    from lidar_imu_slam_tpu_torch.host import native
    from lidar_imu_slam_tpu_torch.ops import preprocess

    t0 = time.perf_counter()
    _require(native.available(), "native: the scan packer did not build (g++)")
    print(f"native: built or found {os.path.relpath(native._LIB_PATH)} in "
          f"{time.perf_counter() - t0:.2f} s")
    pack_ms, worst_xyz, worst_rel = [], 0.0, 0.0
    for m in msgs[:3]:
        t0 = time.perf_counter()
        n_xyz, _, n_rel, n_mask, tb, te = native.pack_scan_native(
            m["xyz"], m["time"], None, m["stamp"], cfg.lidar)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        scan = preprocess.preprocess_scan(preprocess.pack_raw_scan(
            m["xyz"], time=m["time"], stamp=m["stamp"], max_points=cfg.lidar.max_points,
            device=dev), cfg.lidar)
        mask = scan.mask.cpu().numpy()
        _require(np.array_equal(n_mask, mask), "native: masks differ from preprocess_scan's")
        worst_xyz = max(worst_xyz, float(np.abs(n_xyz[mask] - scan.xyz.cpu().numpy()[mask]).max()))
        # tests/test_native.py's assert_allclose bar: 1e-9 plus 1e-7 relative
        # (the sorted path carries the time in f32, ~4e-9 s at 0.1 s, as in JAX)
        rel = scan.rel_t.cpu().numpy()[mask]
        worst_rel = max(worst_rel, float((np.abs(n_rel[mask] - rel) / (1e-9 + 1e-7 * np.abs(rel))).max()))
    xyz = np.array([[0.7, 0.7, 0.7], [0.1, 0.1, 0.1], [1.5, 0.1, 0.1]], np.float32)
    ds = native.voxel_downsample_native(xyz, 1.0, 8)
    print(f"native: 3 HDL-64E scans: masks equal, max |d xyz| {worst_xyz:.3e} (tol 1e-6), "
          f"rel_t at {worst_rel:.3f} of its bar (1e-9 + 1e-7 |rel_t|) against preprocess_scan "
          f"on the card; pack "
          f"host ms {' '.join(f'{t:.2f}' for t in pack_ms)} (the runner's pack + upload + "
          f"preprocess, phase 13: {runner_pack_ms:.3f} ms); voxel_downsample first wins: "
          f"{len(ds) == 2 and np.array_equal(ds[0], xyz[0])}")
    _require(worst_xyz <= 1e-6 and worst_rel <= 1.0, "native: the pack disagrees")
    _require(len(ds) == 2 and np.array_equal(ds[0], xyz[0]), "native: first-wins broken")


def cli_loop_closure_phase():
    """Phase 21: `--synthetic 40 --loop-closure` on the `kitti` preset: exit
    0 and `<out>.optimized` with 40 poses."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        summary, wall = _cli(["--synthetic", "40", "--loop-closure", "--out", "traj.tum"], tmp)
        raw = np.loadtxt(os.path.join(tmp, "traj.tum"))
        opt = np.loadtxt(os.path.join(tmp, "traj.tum.optimized"))
    print(f"cli --synthetic 40 --loop-closure: {wall:.1f} s with the process start; summary "
          f"{summary}; {len(opt)} optimized poses, max |d t| to the raw "
          f"{np.abs(opt[:, 1:4] - raw[:, 1:4]).max():.3e} m")
    _require(summary["scans"] == 40 and opt.shape == (40, 8) and np.isfinite(opt).all(),
             "cli --loop-closure: not 40 optimized poses")


# ---------------------------------------------------------------------------
# phase 22: multi-device (parallel/mesh.py, sharded_map.py, dryrun.py)
# ---------------------------------------------------------------------------

SHARDS = 4  # the deployment's 2^17-slot map split four ways
GRID_SCANS = 10  # the stream mesh and the combined grid
MESH_SCANS = 10
DRYRUN_DEVICES = 8  # __graft_entry__.dryrun_multichip(8), MULTICHIP_r05.json


def sharded_cfgs(cfgmod, points_per_scan: int):
    """The HDL-64E classic deployment (f32 slab) under batch_config with no
    deskew (the sharded path has none): the single-map control at its 2^17
    slots and the shard config at a quarter of them."""
    from lidar_imu_slam_tpu_torch.parallel import streams

    ctrl = streams.batch_config(bench_cfg(cfgmod, points_per_scan, gn_backend="xla"))
    ctrl = ctrl.replace(icp=dataclasses.replace(ctrl.icp, deskew=False))
    shard = ctrl.replace(map=dataclasses.replace(ctrl.map, capacity=ctrl.map.capacity // SHARDS))
    return ctrl, shard


def _sharded_drive(dev, cfg, scans, n_scans, counter=None, state=None):
    """`sharded_map.register_frame` over scans [0, n_scans) at world 1.
    Returns (state, poses (T, 4, 4) numpy, metrics per scan, ms per scan)."""
    import torch

    from lidar_imu_slam_tpu_torch.parallel import sharded_map

    state = sharded_map.init_state(cfg, SHARDS, dev) if state is None else state
    poses, metrics, events = [], [], []
    with _counting(counter):
        for i in range(n_scans):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, pose, m = sharded_map.register_frame(state, scans(i), cfg, SHARDS)
            ev[1].record()
            poses.append(pose)
            metrics.append(m)
            events.append(ev)
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in events])
    metrics = {k: torch.stack([m[k] for m in metrics]).cpu().numpy() for k in metrics[0]}
    return state, torch.stack(poses).cpu().numpy(), metrics, ms


def sharded_map_phase(dev, cfgmod, raws, gt, n_scans=N_SCANS, points=POINTS_PER_SCAN):
    """(a) the map sharded four ways at world 1 against the single-map
    control at 4x the capacity, both through the same config."""
    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan
    from lidar_imu_slam_tpu_torch.parallel import sharded_map

    ctrl_cfg, cfg = sharded_cfgs(cfgmod, points)

    def scans(i):
        return preprocess_scan(raws[i], cfg.lidar)

    t0 = time.perf_counter()
    warm, _, _, _ = _sharded_drive(dev, cfg, scans, 1)
    _no_sync(lambda: sharded_map.register_frame(warm, scans(1), cfg, SHARDS))
    print("sharded map: one register_frame ran under sync debug mode 'error'")
    del warm
    counts = _reads_and_ops(lambda n, counter: _sharded_drive(dev, cfg, scans, n, counter))
    _common.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    state, poses, metrics, ms = _sharded_drive(dev, cfg, scans, n_scans)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_common.LAUNCHES)

    ctrl = kiss_icp.init_state(ctrl_cfg, dev)
    ctrl_poses, ctrl_wdrops = [], []
    for i in range(n_scans):
        ctrl, out = kiss_icp.register_frame(ctrl, scans(i), ctrl_cfg)
        ctrl_poses.append(out.pose)
        ctrl_wdrops.append(out.window_drops)
    ctrl_poses = torch.stack(ctrl_poses).cpu().numpy()
    ctrl_wdrops = int(torch.stack(ctrl_wdrops).sum())
    ctrl_drops = int(ctrl.map.drops)
    per_shard = voxel_map.num_voxels(state.map).cpu().numpy()
    d = np.linalg.norm(poses[:, :3, 3] - ctrl_poses[:, :3, 3], axis=-1)
    ate, ate_ctrl = _ate(poses, gt), _ate(ctrl_poses, gt)
    print(f"sharded map: {SHARDS} shards x 2^{cfg.map.capacity.bit_length() - 1} slots against "
          f"the single map at 2^{ctrl_cfg.map.capacity.bit_length() - 1}, {n_scans} scans of "
          f"{points} points, {time.perf_counter() - t0:.1f} s")
    print(f"sharded map: max |d position| to the control {d.max():.3e} m (tol 1e-6); ATE "
          f"{ate:.4f} m, the control's {ate_ctrl:.4f} m (mid-scan)")
    print(f"sharded map: drops {int(metrics['drops'][-1])} (control {ctrl_drops}), window "
          f"drops {int(metrics['window_drops'].sum())} (control {ctrl_wdrops}); voxels per "
          f"shard {per_shard.tolist()} (total {int(metrics['map_voxels'][-1])}, control "
          f"{int(voxel_map.num_voxels(ctrl.map))}); launches {launches}")
    print(f"sharded map: p50 {np.percentile(ms, 50):.3f} ms  p95 {np.percentile(ms, 95):.3f} ms "
          f"a scan (CUDA events); peak memory {peak / 2**20:.1f} MiB")
    print(_reads_ops_line("sharded map", counts))
    _require(np.isfinite(poses).all(), "sharded map: non-finite pose")
    _require(int(metrics["drops"][-1]) == 0 and ctrl_drops == 0, "sharded map: drops")
    _require(int(metrics["window_drops"].sum()) == 0 and ctrl_wdrops == 0,
             "sharded map: window drops")
    _require(d.max() <= 1e-6, f"sharded map: {d.max():.3e} m from the control")
    _require((per_shard > 0).all() and per_shard.max() < 3 * per_shard.min(),
             f"sharded map: shards unbalanced {per_shard.tolist()}")
    _require(not any(launches.values()), "sharded map: a kernel launched on the plain path")
    return dict(cfg=cfg, poses=poses, ms_p50=float(np.percentile(ms, 50)), peak_bytes=peak)


def stream_mesh_phase(dev, cfg, raws, n_steps=MESH_SCANS, n_streams=STREAMS):
    """(b) phase 11's 8-stream deployment on the stream mesh at world 1:
    bit-equal to `batched_register_frame_step`, the metrics those of its
    outputs, K5 twice a step."""
    import torch

    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan, stack_raw_scans
    from lidar_imu_slam_tpu_torch.parallel import mesh, streams

    bcfg = streams.batch_config(cfg)
    last = len(raws) - 1

    def batch(i):
        return preprocess_scan(stack_raw_scans([raws[min(i + s, last)]
                                                for s in range(n_streams)]), bcfg.lidar)

    ref_states = streams.init_batched_state(bcfg, n_streams, dev)
    ref = []
    for i in range(n_steps):
        ref_states, out = streams.batched_register_frame_step(ref_states, batch(i), bcfg)
        ref.append((out.pose, out))

    m = mesh.stream_mesh(device=dev)
    step = mesh.sharded_multistream_step(m, bcfg)
    warm = streams.init_batched_state(bcfg, n_streams, dev)
    warm, _, _ = step(warm, batch(0))
    _no_sync(lambda: step(warm, mesh.shard_streams(batch(1), m)))
    print("stream mesh: one step ran under sync debug mode 'error'")
    del warm
    states = mesh.shard_streams(streams.init_batched_state(bcfg, n_streams, dev), m)
    _common.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = []
    for i in range(n_steps):
        states, poses, metrics = step(states, mesh.shard_streams(batch(i), m))
        got.append((poses, metrics))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_common.LAUNCHES)
    same = all(torch.equal(p, r[0]) for (p, _), r in zip(got, ref))
    metrics_equal = True
    for (_, gm), (_, out) in zip(got, ref):
        want = (out.residual_rms.sum() / n_streams,
                out.num_correspondences.to(torch.int64).sum(),
                out.icp_iterations.amax(),
                out.map_voxels.to(torch.float64).sum() / n_streams)
        metrics_equal &= all(torch.equal(a, b) for a, b in zip(gm, want))
    print(f"stream mesh: world 1, {n_streams} streams x {n_steps} steps, "
          f"{wall / n_steps * 1e3:.2f} ms a step (host clock); poses bit-equal to "
          f"batched_register_frame_step: {same}; GlobalMetrics equal to the outputs' "
          f"reduction: {metrics_equal}; last {dict(got[-1][1]._asdict())}; launches {launches}")
    _require(same, "stream mesh: poses differ from batched_register_frame_step")
    _require(metrics_equal, "stream mesh: GlobalMetrics differ from the outputs' reduction")
    expect = n_steps * bcfg.icp.batch_unroll_outer
    _require(launches["fused_gn_batched"] == expect,
             f"stream mesh: K5 launched {launches['fused_gn_batched']} times, not {expect}")
    for k in ("fused_gn_carry", "pose_pre", "pose_post", "fused_gn"):
        _require(launches[k] == 0, f"stream mesh: {k} launched")
    return launches["fused_gn_batched"]


def combined_grid_phase(dev, cfg, raws, sharded, n_scans=GRID_SCANS):
    """(c) 2 streams x 4 shards at world 1, stream s at step i on scan
    i + s, each stream held to the single sharded run on its scans."""
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan, stack_raw_scans
    from lidar_imu_slam_tpu_torch.parallel import sharded_map

    state = sharded_map.init_multi_state(cfg, 2, SHARDS, dev)
    t0 = time.perf_counter()
    poses = []
    for i in range(n_scans):
        scans = preprocess_scan(stack_raw_scans([raws[i], raws[i + 1]]), cfg.lidar)
        state, pose, _ = sharded_map.batched_register_frame(state, scans, cfg, SHARDS)
        poses.append(pose)
    poses = np.stack([p.cpu().numpy() for p in poses])
    wall = time.perf_counter() - t0
    one = {0: sharded[:n_scans]}
    _, one[1], _, _ = _sharded_drive(dev, cfg, lambda i: preprocess_scan(raws[i + 1], cfg.lidar),
                                     n_scans)
    d = max(float(np.abs(poses[:, s, :3, 3] - one[s][:, :3, 3]).max()) for s in (0, 1))
    print(f"combined grid: 2 streams x {SHARDS} shards at world 1, {n_scans} scans, "
          f"{wall / n_scans * 1e3:.2f} ms a step (host clock); max |d position| to the single "
          f"sharded runs {d:.3e} m (tol 1e-9)")
    _require(np.isfinite(poses).all() and d <= 1e-9, f"combined grid: {d:.3e} m off")


def _dryrun_same(what, got, ref):
    """A dry run's results against world 1 without a process group: poses
    bit-equal, integer metrics equal, f64 metrics within 1e-12 relative."""
    for key in ("poses", "sharded_pose", "combined_poses"):
        _require(np.array_equal(got[key], ref[key]), f"{what}: {key} differ from world 1")
    _require(got["sharded_metrics"] == ref["sharded_metrics"]
             and got["combined_voxels"] == ref["combined_voxels"],
             f"{what}: integer metrics differ from world 1")
    for k, v in ref["metrics"].items():
        _require(abs(got["metrics"][k] - v) <= 1e-12 * abs(v), f"{what}: metric {k} differs")


def processes_phase(dev):
    """(d) the dry run at the tiny config in processes: world 2 over gloo on
    one card, world 1 over NCCL, one rank per card over NCCL where there
    are cards for it; each against world 1 without a process group."""
    import torch

    from lidar_imu_slam_tpu_torch.parallel import dryrun

    def spawn(*args, **kw):
        try:
            return dryrun.spawn(*args, **kw)
        except (RuntimeError, TimeoutError) as e:  # a rank failed or hung
            raise SmokeFailure(f"dryrun: {e}") from e

    ref = dryrun.run(DRYRUN_DEVICES, dev, quiet=True)
    runs = [("gloo", 2, f"cuda:{dev.index or 0}"), ("nccl", 1, "cuda")]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        runs.append(("nccl", 4 if n_cards >= 4 else 2, "cuda"))
    else:
        print("dryrun: NCCL with one rank per card not run (1 card)")
    print(f"dryrun: world 1 without a process group: ms a step " +
          "  ".join(f"{k} {v / 2:.3f}" for k, v in ref["ms"].items()))
    for backend, world, device in runs:
        t0 = time.perf_counter()
        outs = spawn(world, dryrun.run, (DRYRUN_DEVICES, device, 0, True), backend=backend,
                     timeout_s=300)
        for r, out in enumerate(outs):
            _dryrun_same(f"dryrun {backend} world {world} rank {r}", out, ref)
        print(f"dryrun: backend {backend}, world {world}, {device}: bit-equal to world 1; "
              f"ms a step " + "  ".join(f"{k} {v / 2:.3f}" for k, v in outs[0]["ms"].items())
              + f"; {time.perf_counter() - t0:.1f} s with the processes' start")
    print(f"dryrun: counts {ref['metrics']['total_correspondences']} correspondences, "
          f"{ref['sharded_metrics']['map_voxels']} voxels / "
          f"{ref['sharded_metrics']['num_correspondences']}, combined {ref['combined_voxels']} "
          f"(JAX: 4080, 927 / 510, [927, 927], MULTICHIP_r05.json)")
    _require(ref["metrics"]["total_correspondences"] == 4080
             and ref["sharded_metrics"]["map_voxels"] == 927
             and ref["sharded_metrics"]["num_correspondences"] == 510
             and ref["combined_voxels"] == [927, 927], "dryrun: counts differ from JAX's")


def multi_device_phase(dev, cfgmod, cfg, raws, gt) -> int:
    """Phase 22. Returns K5's launches on the stream mesh."""
    t0 = time.perf_counter()
    sharded = sharded_map_phase(dev, cfgmod, raws, gt)
    k5 = stream_mesh_phase(dev, cfg, raws)
    combined_grid_phase(dev, sharded["cfg"], raws, sharded["poses"])
    processes_phase(dev)
    print(f"multi-device: phase {time.perf_counter() - t0:.1f} s")
    return k5


# ---------------------------------------------------------------------------
# phase 23: the dense solid-state deployment (config.livox_dense())
# ---------------------------------------------------------------------------

DENSE_SCANS = 60  # 24 m at 4 m/s, inside the world's 120 m
DENSE_CPU_SCANS = 6  # (b): tests/test_livox.py's drive, on the CPU as well
DENSE_K1_SCAN = 5  # (c): K1's inputs from this scan's first ICP round
DENSE_ERR_LIMIT_M = 0.3  # tests/test_livox.py's bar, here at every scan
DENSE_MIN_CORR = 1000  # tests/test_livox.py's bar, every scan after scan 0


def render_dense_drive(dev):
    """tests/test_livox.py's drive (world seed 2, 500,000 points in 120 x 30
    x 10 m; 4 m/s, yaw rate 0.01, dt 0.1) over DENSE_SCANS scans at the
    preset's full 262,144 points, without per-point time: the scans
    uploaded, the same scans as host messages {"xyz", "stamp"}, and the
    ground truth."""
    import torch

    from lidar_imu_slam_tpu_torch import config as cfgmod
    from lidar_imu_slam_tpu_torch.host import synthetic
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan

    lc = cfgmod.livox_dense().lidar
    t0 = time.perf_counter()
    world = synthetic.make_world(seed=2, n_points=500_000, extent=(120.0, 30.0, 10.0))
    gt = synthetic.make_trajectory(n_poses=DENSE_SCANS, speed=4.0, yaw_rate=0.01, dt=0.1)
    raws, msgs = [], []
    for i in range(DENSE_SCANS):
        pts = synthetic.render_scan(world, gt[i], lc.max_points, lc.min_range, lc.max_range,
                                    noise=0.02, seed=i)
        _require(len(pts) == lc.max_points,
                 f"dense: scan {i} rendered {len(pts)} points, not {lc.max_points}")
        msgs.append({"xyz": pts, "stamp": i * 0.1})
        raws.append(pack_raw_scan(pts, stamp=i * 0.1, max_points=lc.max_points, device=dev))
    torch.cuda.synchronize()
    print(f"dense: rendered and uploaded {DENSE_SCANS} scans of {lc.max_points} points in "
          f"{time.perf_counter() - t0:.1f} s")
    return raws, msgs, gt


def _dense_hand_loop(dev, cfg, raws, gt):
    """(a) `register_frame_step` on the uploaded scans, the runner's calls
    (in-step eviction and compaction check, `_maybe_rebuild`'s check) on
    one thread. Returns (the drive's numbers, a `_runner_fields` row a
    scan, K1's launches)."""
    import torch

    from lidar_imu_slam_tpu_torch.host import runner as runner_mod
    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops import voxel_map
    from lidar_imu_slam_tpu_torch.ops.kernels import _common
    from lidar_imu_slam_tpu_torch.ops.preprocess import preprocess_scan

    fields = runner_mod.ODOMETRY_FIELDS

    def run(n_scans, counter=None):
        state = kiss_icp.init_state(cfg, dev)
        kept, ms = [], []
        torch.cuda.synchronize()
        wall0 = time.perf_counter()
        with _counting(counter):
            for i in range(n_scans):
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                state, out = kiss_icp.register_frame_step(
                    state, preprocess_scan(raws[i], cfg.lidar), cfg)
                state = state._replace(map=_maybe_rebuild_like_runner(state.map, cfg, i))
                ev1.record()
                kept.append((out.pose, *(getattr(out, f) for f in fields)))  # copied after
                ms.append((ev0, ev1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
        hand = [[p.cpu().numpy()] + [float(v) for v in rest] for p, *rest in kept]
        return state, hand, wall, np.array([a.elapsed_time(b) for a, b in ms])

    run(3)  # warm-up on a throwaway state
    counts = _reads_and_ops(run)
    torch.cuda.reset_peak_memory_stats()
    _common.reset_launches()
    state, hand, wall, step_ms = run(DENSE_SCANS)
    launches = dict(_common.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20

    poses = np.stack([h[0] for h in hand])
    col = {f: np.array([h[1 + k] for h in hand]) for k, f in enumerate(fields)}
    _require(np.isfinite(poses).all(), "dense: non-finite pose")
    ref = np.linalg.inv(gt[0])[None] @ gt
    err = np.linalg.norm(poses[:, :3, 3] - ref[:, :3, 3], axis=-1)
    drops = int(state.map.drops)
    stats = dict(scans_per_s=DENSE_SCANS / wall, p50_ms=float(np.percentile(step_ms, 50)),
                 p95_ms=float(np.percentile(step_ms, 95)), max_err_m=float(err.max()),
                 ate_m=_ate(poses, gt, shift=0.5), ate_instant_m=_ate(poses, gt, shift=0.0),
                 peak_mib=peak, map_voxels=int(voxel_map.num_voxels(state.map)),
                 icp_iterations=float(col["icp_iterations"].mean()), **counts)
    print(f"dense (a): {stats['scans_per_s']:.2f} scans/s (host clock)  p50 "
          f"{stats['p50_ms']:.3f} ms  p95 {stats['p95_ms']:.3f} ms a scan (CUDA events, "
          f"preprocess + step)")
    print(f"dense (a): position error max {err.max():.4f} m (limit {DENSE_ERR_LIMIT_M}), last "
          f"{err[-1]:.4f} m; ATE {stats['ate_instant_m']:.4f} m at each scan's instant "
          f"(render_scan's convention), {stats['ate_m']:.4f} m with phase 7's mid-scan shift")
    print(f"dense (a): correspondences min {int(col['num_correspondences'][1:].min())} over "
          f"scans 1-{DENSE_SCANS - 1} (bar > {DENSE_MIN_CORR}); ICP iterations mean "
          f"{col['icp_iterations'].mean():.2f} max {int(col['icp_iterations'].max())}; window "
          f"drops {int(col['window_drops'].sum())}; map drops {drops}; tombstones "
          f"{int(state.map.tombstones)}; final map voxels {stats['map_voxels']}; peak memory "
          f"{peak:.1f} MiB")
    print(f"dense (a): launches K1 {launches['fused_gn_carry']} (over several clusters: "
          f"{launches['gn_spread']})  K2 {launches['pose_pre']}  K3 {launches['pose_post']}  "
          f"(all {launches})")
    print(_reads_ops_line("dense (a)", counts))
    _require(drops == 0 and not col["window_drops"].any(), "dense: drops or window drops")
    _require(bool((col["num_correspondences"][1:] > DENSE_MIN_CORR).all()),
             f"dense: a scan with {DENSE_MIN_CORR} correspondences or fewer")
    _require(err.max() < DENSE_ERR_LIMIT_M,
             f"dense: position error {err.max():.4f} m at or above {DENSE_ERR_LIMIT_M}")
    _require(launches["fused_gn_carry"] > 0, "dense: K1 never launched")
    _require(launches["gn_spread"] == launches["fused_gn_carry"],
             "dense: a K1 launch at 16,384 x 80 stayed on one cluster")
    _require(launches["pose_pre"] == DENSE_SCANS and launches["pose_post"] == DENSE_SCANS,
             "dense: K2 / K3 did not run once per scan")
    return stats, hand, launches["fused_gn_carry"]


def _dense_card_vs_cpu(dev, cfg, msgs, hand):
    """(b) The first DENSE_CPU_SCANS scans through the port on the card and
    on the CPU: scan 0's map bit-equal, poses within phase 6's 1e-4. The
    card run keeps the inputs of K1's first launch at scan DENSE_K1_SCAN.
    Returns those inputs."""
    import torch

    from lidar_imu_slam_tpu_torch.models import kiss_icp
    from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn
    from lidar_imu_slam_tpu_torch.ops.preprocess import pack_raw_scan, preprocess_scan

    launch, captured, scan_no = icp_gn.fused_gn_carry, [], [0]

    def capture(*args):
        if scan_no[0] == DENSE_K1_SCAN and not captured:
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return launch(*args)

    maps, poses = {}, {}
    t0 = time.perf_counter()
    for d in (dev, "cpu"):
        state = kiss_icp.init_state(cfg, d)
        poses[d] = []
        icp_gn.fused_gn_carry = capture if d == dev else launch
        try:
            for i, m in enumerate(msgs[:DENSE_CPU_SCANS]):
                scan_no[0] = i
                raw = pack_raw_scan(m["xyz"], stamp=m["stamp"], max_points=cfg.lidar.max_points,
                                    device=d)
                state, out = kiss_icp.register_frame_step(
                    state, preprocess_scan(raw, cfg.lidar), cfg)
                if i == 0:
                    maps[d] = [t.cpu().clone() for t in state.map]
                poses[d].append(out.pose.cpu().numpy())
        finally:
            icp_gn.fused_gn_carry = launch
    same0 = all(torch.equal(a, b) for a, b in zip(maps[dev], maps["cpu"]))
    worst = float(np.abs(np.stack(poses[dev]) - np.stack(poses["cpu"])).max())
    like_a = np.array_equal(np.stack(poses[dev]), np.stack([h[0] for h in hand[:DENSE_CPU_SCANS]]))
    print(f"dense (b): card (K1-K3) vs CPU (plain) over {DENSE_CPU_SCANS} scans: scan 0's map "
          f"bit-equal {same0}; max|d pose| {worst:.3e} (tol 1e-4); the card's poses bit-equal "
          f"to (a)'s: {like_a}; {time.perf_counter() - t0:.1f} s")
    _require(same0, "dense: scan 0's map differs between the card and the CPU")
    _require(worst <= 1e-4, "dense: card and CPU poses disagree")
    _require(len(captured) == 1, f"dense: no K1 launch captured at scan {DENSE_K1_SCAN}")
    return captured[0]


def _dense_k1(args) -> dict:
    """(c) K1 at the dense shape (16,384 queries x 80 slots) on one on-path
    launch's inputs, as phase 3 holds it at 4096 x 80, with its registers."""
    q, qmask, cand, scal, carry, inner = args
    n, nc = q.shape[1], cand.shape[1]
    _require((n, nc) == (16384, 80), f"dense: K1 at {n} x {nc}, not 16384 x 80")
    _spread_ptxas()
    k1 = _k1_check("dense K1", q, qmask, cand, scal, carry, inner, 3)
    _require(k1["groups"] > 1, "dense K1: one cluster, not spread over several")
    del k1["row"]
    return dict(k1, n=n, nc=nc)


def _dense_runner(dev, cfg, msgs, hand):
    """(d) `OdometryRunner(cfg, device).run` over the scans as host
    messages: bit-equal to (a)'s hand loop."""
    from lidar_imu_slam_tpu_torch.host import runner as runner_mod

    def make():
        return runner_mod.OdometryRunner(cfg, device=dev)

    make().run(iter(msgs[:3]))  # warm-up: the worker thread's first CUDA work
    runner, wall, sites, launches = _timed_run(make, lambda r: r.run(iter(msgs)), launches=True)
    n = len(runner.poses)
    _require(n == DENSE_SCANS, f"dense runner: {n} poses for {DENSE_SCANS} scans")
    print(_runner_line("dense (d) runner", runner, wall, sites, n) +
          f"; launches K1 {launches['fused_gn_carry']} K2 {launches['pose_pre']} "
          f"K3 {launches['pose_post']}")
    _assert_like_hand_loop("dense (d) runner", runner, hand, runner_mod.ODOMETRY_FIELDS)
    return dict(scans_per_s=n / wall, host_reads_per_scan=sum(sites.values()) / n)


def dense_phase(dev) -> dict:
    """Phase 23: the dense solid-state deployment (`config.livox_dense()`,
    BASELINE.json config 4) on the card. Returns its numbers (`k1`: K1 at
    the dense shape; `k1_launches`: K1's launches on the drive)."""
    from lidar_imu_slam_tpu_torch import config as cfgmod

    t0 = time.perf_counter()
    cfg = cfgmod.livox_dense()
    raws, msgs, gt = render_dense_drive(dev)
    stats, hand, k1_launches = _dense_hand_loop(dev, cfg, raws, gt)
    del raws
    k1 = _dense_k1(_dense_card_vs_cpu(dev, cfg, msgs, hand))
    runner = _dense_runner(dev, cfg, msgs, hand)
    print(f"dense: phase {time.perf_counter() - t0:.1f} s")
    return dict(stats, k1=dict(k1, launches=k1_launches), k1_ms=k1["ms"],
                spread=dict(name="gn_spread", route="cuda",
                            source="lidar_imu_slam_tpu_torch/csrc/icp_gn.cu",
                            replaces=f"{REFERENCE_PKG}/ops/pallas/icp_gn.py:383",
                            **{k: k1[k] for k in (
                                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "device_ms", "groups", "cluster", "per_cta", "smem",
                                "active_clusters", "device_ms_by_shape")},
                            library_ms=None, launches=k1_launches),
                k1_device_ms=k1["device_ms"], runner_scans_per_s=runner["scans_per_s"],
                runner_host_reads_per_scan=runner["host_reads_per_scan"])


def _build_kernels() -> None:
    """Build (or find) the kernel library and print ptxas' report."""
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


def _k6_proto_times(dev) -> dict:
    """K6 (4096 x 1,310,720) and gn_proto (4096 x 80 x 8) per call, device
    and host ms, through their public wrappers."""
    from lidar_imu_slam_tpu_torch.ops.kernels import probes as kp
    from lidar_imu_slam_tpu_torch.tools import probes as tp

    q, pool, _ = _k6_inputs(dev)
    times = {"nn_bruteforce": _k6_times(q, pool)}
    del q, pool
    x = tp.gn_inputs(dev)
    fn = lambda: kp.gn_proto(x["q"], x["qmask"], x["cand"], x["scal"], tp.N_INNER)  # noqa: E731
    times["gn_proto"] = dict(ms=_cuda_ms(fn, 100), device_ms=_device_ms(fn, 100),
                             host_ms=tp.host_ms(fn))
    return times


def measure(dev) -> dict:
    """`--measure`: K2's and K3's times (with K1's checks before them, as
    in the smoke run), K6's and gn_proto's times, then the fast and LIO
    slices and the dense drive (phase 23); returns their numbers."""
    from lidar_imu_slam_tpu_torch import config as cfgmod

    cfg = bench_cfg(cfgmod, POINTS_PER_SCAN)
    kernels = {k["name"]: {key: v for key, v in k.items() if key.endswith("ms")}
               for k in kernel_phase(dev, cfg) if k["name"] in ("pose_pre", "pose_post")}
    kernels.update(_k6_proto_times(dev))
    raws, _, gt = render_hdl_drive(dev)
    _, fast = slice_phase(dev, cfg, raws, gt)
    lio = lio_slice_phase(dev, cfg, raws, gt)
    del raws
    return dict(kernels=kernels, slice=fast, lio=lio, dense=dense_phase(dev))


MEASURE_KEYS = {  # what --turns sets side by side (K6 and gn_proto: ms, device, host)
    "kernels": ("ms", "device_ms", "host_ms", "floor_ms", "floor_host_ms", "pose_step_ms",
                "pose_step_device_ms", "pose_step_host_ms"),
    "slice": ("scans_per_s", "p50_ms", "ops_per_scan", "compute_ops_per_scan",
              "host_reads_per_scan", "ate_m"),
    "lio": ("scans_per_s", "p50_ms", "ops_per_scan", "compute_ops_per_scan",
            "host_reads_per_scan", "ate_m"),
    "dense": ("scans_per_s", "p50_ms", "k1_ms", "k1_device_ms"),
}


def turns(parent: str) -> int:
    """`--turns PARENT`: `--measure` on the checkout at PARENT and on this
    one in turns (parent, change, change, parent), each in a process of
    its own that builds its checkout's kernels; then the numbers side by
    side, the host reads by call site of the first of each."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for label, root in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                              capture_output=True, text=True, timeout=1200)
        print(f"== {label} ({root}): exit {proc.returncode}")
        print(proc.stdout + proc.stderr[-4000:])
        _require(proc.returncode == 0, f"--measure on {root} failed")
        tail = [ln for ln in proc.stdout.splitlines() if ln.startswith("MEASURE ")]
        runs.append((label, json.loads(tail[-1].removeprefix("MEASURE "))))
    print("turns: " + " / ".join(label for label, _ in runs))
    for part, keys in MEASURE_KEYS.items():
        for name in (runs[0][1]["kernels"] if part == "kernels" else (part,)):
            for key in keys:
                vals = [(r[part][name] if part == "kernels" else r[part]).get(key) for _, r in runs]
                if None in vals:
                    continue
                print(f"turns: {name} {key} " + " / ".join(f"{v:.4f}" for v in vals))
    for part in ("slice", "lio"):
        for label, r in (runs[0], runs[1]):
            print(f"turns: {part} host reads by call site ({label}) {r[part]['host_reads_by_site']}")
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / CUDA port on one GPU.")
    ap.add_argument("--measure", metavar="ROOT",
                    help="only K2 / K3 times and the fast, LIO and dense drives' numbers, of "
                         "the package in the checkout ROOT; the last line is MEASURE {json}")
    ap.add_argument("--turns", metavar="PARENT",
                    help="--measure on the checkout PARENT and on this one, in turns")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="only phase 22's dry run in processes (NCCL with one rank per "
                         "card where there are cards)")
    args = ap.parse_args(argv)
    if args.measure:
        sys.path.insert(0, os.path.abspath(args.measure))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda, sys.version.split()[0])
    card = _card_line()
    print(card)
    if args.turns:
        return turns(args.turns)
    if args.dryrun_only:
        processes_phase(dev)
        return 0

    from lidar_imu_slam_tpu_torch import config as cfgmod

    _build_kernels()
    if args.measure:
        print("MEASURE " + json.dumps(measure(dev)))
        return 0

    cfg = bench_cfg(cfgmod, POINTS_PER_SCAN)
    cfg64 = bench_cfg(cfgmod, POINTS_PER_SCAN, gn_backend="xla")
    kernels = kernel_phase(dev, cfg)
    pose_chain_cases_phase(dev)
    kernels += batched_kernel_phase(dev, cfg, cfgmod) + [fetch_kernel_phase(dev),
                                                         deskew_kernel_phase(dev),
                                                         nn_kernel_phase(dev)]
    probe_kernels, probe_launches = probe_phase(dev)
    kernels += probe_kernels
    small_drive_phase(dev)
    small_drive_phase(dev, packed_nn=False)
    small_classic_phase(dev)
    small_lio_phase(dev)
    raws, msgs, gt = render_hdl_drive(dev)
    launches, fast = slice_phase(dev, cfg, raws, gt)
    launches.update(probe_launches)
    dense = dense_phase(dev)  # phase 23
    kernels.append(dense["spread"])  # K1 over several clusters
    launches["gn_spread"] = dense["spread"]["launches"]  # phase 23's drive
    lio = lio_slice_phase(dev, cfg, raws, gt)
    launches["imu_deskew"] = lio["imu_deskew_launches"]
    state64, out64 = classic_slice_phase(dev, cfg64, raws, gt)
    launches["nn_bruteforce"] = nn_on_path_phase(dev, cfg64, state64, out64)
    del state64, out64
    # each kernel's launches come from the drive of its own path
    launches["fused_gn"] = small_batched_phase(dev)["fused_gn"]
    small_batched_phase(dev, packed_nn=False)
    launches["fused_gn_batched"] = multi_stream_phase(dev, cfg, raws, gt)["fused_gn_batched"]
    k5_mesh = multi_device_phase(dev, cfgmod, cfg, raws, gt)  # phase 22, on the same scans
    del raws
    monte_carlo_phase(dev, cfgmod)
    runner_nums = runner_phase(dev, cfg, msgs, gt, fast)
    lio_runner_phase(dev, cfg, msgs, gt, lio)
    cli_phase(dev, msgs, gt)
    del msgs
    circuit, circuit_gt = render_circuit()
    cfg_backend = backend_phase(dev, cfgmod, circuit, circuit_gt, runner_nums["reads_per_scan"])
    solver_phase(dev)
    oracle_phase(dev)
    profiling_phase(dev, cfg_backend, circuit)
    native_phase(dev, cfg_backend, circuit, runner_nums["pack_ms"])
    del circuit
    cli_loop_closure_phase()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "fused_gn_batched":
            k["launches_mesh"] = k5_mesh  # phase 22's stream mesh
        if k["name"] == "fused_gn_carry":
            k["dense"] = dense["k1"]  # phase 23: K1 at 16,384 x 80, its launches on that drive
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
    except (SmokeFailure, AssertionError) as e:  # AssertionError: pose_chain_cases.max_err
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
