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
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import PipelineConfig
from ..models import kiss_icp
from ..ops.preprocess import Scan


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
