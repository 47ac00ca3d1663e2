"""Batched multi-stream / Monte-Carlo odometry (counterpart of the JAX
package's `parallel/streams.py`).

The JAX package vmaps `register_frame` over a leading stream axis. Here
the axis is explicit: every leaf of the state carries a leading S (map
tables (S, C), (S, G), (S, C, Kp), scalars (S,), poses (S, 4, 4) f64), each
table the front view of one flat (S*G + 1,) buffer, and one call of
`models.kiss_icp.register_frame_classic` registers all S streams: batched
sorts and stream-offset gathers / scatters in plain torch, and per ICP
round one launch of kernel K5 (`fused_gn_batched`, one thread-block
cluster per stream) with gn_backend="pallas", or the f64 GN iterations of
`icp_registration_unrolled` with gn_backend="xla". No step reads the
device from the host.

The LiDAR-inertial form (`init_batched_lio_state`, `batched_lio_step`)
carries each stream's full filter (the 30-dim inner state and its pose
trail, f64) beside its odometry state and registers through the same
`register_core`; `perturb_imu` draws a Monte-Carlo ensemble's IMU noise.
`LioStepGraph` replays the LIO step of initialized streams as one CUDA
graph: the step is a few thousand small launches, more than the host can
enqueue far ahead of the card.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree

from ..config import PipelineConfig
from ..models import ekf, kiss_icp, lio
from ..ops.preprocess import Scan
from ..utils.profiling import _profiler_enabled


def batch_config(cfg: PipelineConfig, outer: int = 2, inner: int = 4) -> PipelineConfig:
    """Config for batched streams: fixed-unroll ICP (`outer` fetches x
    `inner` GN iterations, early-exit masking) instead of the data-dependent
    loop, and no conditional in-step compaction (batched capacity is sized
    with headroom; the host rebuilds between runs)."""
    return cfg.replace(
        icp=dataclasses.replace(cfg.icp, batch_unroll_outer=outer, batch_unroll_inner=inner),
        map=dataclasses.replace(cfg.map, auto_rebuild=False),
    )


def init_batched_state(cfg: PipelineConfig, num_streams: int,
                       device: torch.device | str = "cuda") -> kiss_icp.KissState:
    """S fresh states on a leading stream axis."""
    return kiss_icp.init_state(cfg, device, streams=num_streams)


def _check_batched(cfg: PipelineConfig) -> None:
    if cfg.icp.batch_unroll_outer <= 0:
        raise ValueError("batched streams run the fixed-unroll schedule: pass "
                         "batch_config(cfg) (batch_unroll_outer > 0)")


def batched_register_frame(states: kiss_icp.KissState, scans: Scan, cfg: PipelineConfig):
    """`register_frame` over the leading stream axis. Returns (states',
    outputs), every leaf with a leading S; `states` is left unchanged."""
    _check_batched(cfg)
    return kiss_icp.register_frame_classic(states, scans, cfg)


def batched_register_frame_step(states: kiss_icp.KissState, scans: Scan,
                                cfg: PipelineConfig):
    """`batched_register_frame` that updates the map tables of `states` in
    place (the JAX package's donated step): the caller must not reuse
    `states` after the call."""
    _check_batched(cfg)
    return kiss_icp.register_frame_classic(states, scans, cfg, inplace=True)


def perturb_scans(scan: Scan, generator: torch.Generator, num_streams: int,
                  noise_sigma: float) -> Scan:
    """Monte-Carlo helper: replicate one preprocessed scan across
    `num_streams` streams with iid N(0, noise_sigma^2) point noise on the
    valid points (padding stays untouched). The noise comes from
    `generator`, which must live on the scan's device."""
    xyz = scan.xyz
    if generator.device.type != xyz.device.type:
        raise ValueError(f"generator on {generator.device}, scan on {xyz.device}")
    noise = torch.randn((num_streams,) + tuple(xyz.shape), generator=generator,
                        dtype=xyz.dtype, device=xyz.device) * noise_sigma
    s = num_streams
    return Scan(
        xyz=xyz + noise * scan.mask[:, None],
        tau=scan.tau.expand((s,) + scan.tau.shape),
        rel_t=scan.rel_t.expand((s,) + scan.rel_t.shape),
        mask=scan.mask.expand((s,) + scan.mask.shape),
        t_begin=scan.t_begin.expand(s),
        t_end=scan.t_end.expand(s),
    )


def init_batched_lio_state(cfg: PipelineConfig, num_streams: int,
                           device: torch.device | str = "cuda") -> lio.LioState:
    """S fresh LIO states on a leading stream axis (map, filter, IMU
    initialization and the constant-velocity history of each stream)."""
    return lio.init_state(cfg, device, streams=num_streams)


def batched_lio_step(states: lio.LioState, scans: Scan, packets: ekf.ImuPacket,
                     cfg: PipelineConfig, init_samples: int = 0):
    """`lio.step` over the leading stream axis, updating the map tables of
    `states` in place (the caller must not reuse `states`); no host read.
    `packets` holds each stream's IMU samples of the scan (S, M, ...).

    `init_samples` is the caller's host-side count, a lower bound, of the
    IMU samples every stream's static initialization had consumed before
    this step (the valid samples of the packets it built): from
    `cfg.imu.max_init_count` on, every stream is initialized and the step
    runs the IMU branch alone; below it, both branches run and each stream
    takes its own. The step does not check the count (that would read the
    device): it is the caller's invariant. A count above what every stream
    consumed runs the IMU branch on a stream whose initialization is open,
    which then never seeds its filter. Returns (states', LioOutput), the outputs' leaves with a
    leading S but for `streams_initialized` and `streams_imu`."""
    _check_batched(cfg)
    ready = init_samples >= cfg.imu.max_init_count
    return lio.step_streams(states, scans, packets, cfg, imu_ready=ready, inplace=True)


def perturb_imu(packet: ekf.ImuPacket, generator: torch.Generator, num_streams: int,
                gyro_sigma: float, acc_sigma: float) -> ekf.ImuPacket:
    """Monte-Carlo helper: replicate one IMU packet (M samples) across
    `num_streams` streams with iid normal noise of `gyro_sigma` (rad/s) on
    each gyro and `acc_sigma` (m/s^2) on each accelerometer axis of the
    valid samples (padding stays untouched), drawn from `generator` (on the
    packet's device) as one (S, M, 6) f64 normal draw, gyro first."""
    g = packet.gyro
    if generator.device.type != g.device.type:
        raise ValueError(f"generator on {generator.device}, packet on {g.device}")
    s = num_streams
    noise = torch.randn((s,) + tuple(g.shape[:-1]) + (6,), generator=generator, dtype=g.dtype,
                        device=g.device) * packet.mask[:, None]
    return ekf.ImuPacket(
        time=packet.time.expand((s,) + packet.time.shape),
        gyro=g + noise[..., :3] * gyro_sigma,
        acc=packet.acc + noise[..., 3:] * acc_sigma,
        mask=packet.mask.expand((s,) + packet.mask.shape),
    )


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def _write_leaves(dst, src) -> None:
    """Copy every tensor of `src` into the tensor in the same place of `dst`
    (the same structure, shapes and dtypes), skipping those that already are
    that tensor (a map table updated in place). A source that shares memory
    with a tensor about to be written is read out first."""
    d, s = _pytree.tree_leaves(dst), _pytree.tree_leaves(src)
    if len(d) != len(s):
        raise ValueError(f"{len(s)} leaves into {len(d)}")
    pairs = [(a, b) for a, b in zip(d, s) if not _same(a, b)]
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise ValueError(f"{tuple(b.shape)} {b.dtype} into {tuple(a.shape)} {a.dtype}")
    written = {a.untyped_storage().data_ptr() for a, _ in pairs}
    pairs = [(a, b.clone() if b.untyped_storage().data_ptr() in written else b)
             for a, b in pairs]
    for a, b in pairs:
        a.copy_(b)


class LioStepGraph:
    """`batched_lio_step` of S streams whose static initializations are all
    done (the IMU branch alone), captured once as a CUDA graph and replayed:
    one graph launch a step in place of its few thousand kernel launches.

        graph = LioStepGraph(states, scans, packets, cfg)  # captures only
        states, out = graph(states, scans, packets)  # each step

    It is built from the live states (after at least one eager step of the
    IMU branch, which builds what the step caches on the card) and one
    step's scans and packets, which fix the shapes. Each call copies its
    scans and packets, and any state tensor that is not the graph's own (a
    caller that replaced one), into the graph's buffers and replays the
    step. The states it returns are the graph's (the same tensors every
    call, written in place); its outputs are the graph's too, and the next
    call writes over them: clone what is kept. While a profiler records,
    the call runs the same step eagerly on the same buffers (the kernels
    the graph holds), so that the step's spans hold its device work."""

    def __init__(self, states: lio.LioState, scans: Scan, packets: ekf.ImuPacket,
                 cfg: PipelineConfig):
        _check_batched(cfg)
        if states.ekf.m.device.type != "cuda":
            raise ValueError("a CUDA graph needs the states on a CUDA card")
        self.cfg = cfg
        self.states = states
        self.scans = _pytree.tree_map(torch.clone, scans)
        self.packets = _pytree.tree_map(torch.clone, packets)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the eager steps' cached blocks, for the graph's pool
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._step()

    def _step(self) -> lio.LioOutput:
        new, out = lio.step_streams(self.states, self.scans, self.packets, self.cfg,
                                    imu_ready=True, inplace=True)
        _write_leaves(self.states, new)
        return out

    def __call__(self, states: lio.LioState, scans: Scan, packets: ekf.ImuPacket):
        _write_leaves(self.states, states)
        _write_leaves(self.scans, scans)
        _write_leaves(self.packets, packets)
        if _profiler_enabled():
            return self.states, self._step()
        self.graph.replay()
        return self.states, self.out
