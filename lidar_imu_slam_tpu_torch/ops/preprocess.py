"""Static-shape LiDAR scan preprocessing (counterpart of
the JAX package's `ops/preprocess.py`; reference frame.cpp:101-193).

A padded raw scan goes through one device pipeline: range gate + NaN drop,
per-point relative time (constant-rotation fallback per ring when the scan
carries no timestamps), optional time sort. The documented deviations of
the JAX package are kept (tau spans [0, 1]; the first point is kept).

`time_source="auto"` chooses per scan between the timestamps and the
rotation model with `torch.where` on the device — both are computed, but
the host never waits for the device to decide.

Every field may carry leading stream dims (a stack of S raw scans, as the
batched path feeds them): the pipeline runs along the point axis, one scan
per row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import LidarConfig
from ..utils.profiling import annotate

_I64_MAX = 0x7FFFFFFFFFFFFFFF


class RawScan(NamedTuple):
    """Padded raw scan message.

    xyz:   (N, 3) f32 sensor frame
    time:  (N,)   f64 per-point absolute timestamp (s); <= 0 everywhere
           means "no per-point time" (reference frame.cpp:128)
    ring:  (N,)   i32 scan line index
    mask:  (N,)   bool, true for real (non-padding) points
    stamp: ()     f64 message header time (s)
    """

    xyz: torch.Tensor
    time: torch.Tensor
    ring: torch.Tensor
    mask: torch.Tensor
    stamp: torch.Tensor


class Scan(NamedTuple):
    """Preprocessed scan: range-gated, padded (time-sorted when configured).

    xyz (N, 3) f32, tau (N,) f32 in [0, 1], rel_t (N,) f64 seconds since
    scan start, mask (N,) bool, t_begin / t_end () f64 seconds.
    """

    xyz: torch.Tensor
    tau: torch.Tensor
    rel_t: torch.Tensor
    mask: torch.Tensor
    t_begin: torch.Tensor
    t_end: torch.Tensor


def rotation_model_rel_time(xyz, ring, mask, cfg: LidarConfig) -> torch.Tensor:
    """Per-point relative time (s) from the constant-rotation model
    (reference frame.cpp:159-182): the first valid point of each ring
    anchors the azimuth; time = ((yaw_fp - yaw) mod angle_limit) / rate."""
    n = xyz.shape[-2]
    lead = xyz.shape[:-2]
    lines = cfg.num_scan_lines
    yaw = torch.rad2deg(torch.atan2(xyz[..., 1], xyz[..., 0]))
    idx = torch.arange(n, dtype=torch.int32, device=xyz.device)
    ring_c = torch.clamp(ring, 0, lines - 1).long()
    # first valid index per (scan, ring): one scatter-min over the flat
    # (scans x rings) table
    offs = (torch.arange(int(np.prod(lead)), device=xyz.device) * lines).reshape(lead + (1,))
    first_idx = torch.full((int(np.prod(lead)) * lines,), n, dtype=torch.int32,
                           device=xyz.device)
    first_idx.scatter_reduce_(
        0,
        (torch.where(mask, ring_c, torch.full_like(ring_c, lines - 1)) + offs).reshape(-1),
        torch.where(mask, idx, torch.full_like(idx, n)).reshape(-1),
        reduce="amin",
    )
    first_idx = first_idx.reshape(lead + (lines,))
    yaw_pad = torch.cat([yaw, torch.zeros(lead + (1,), dtype=yaw.dtype, device=yaw.device)], -1)
    yaw_first = torch.gather(yaw_pad, -1, torch.clamp(first_idx, max=n).long())
    yaw_fp = torch.gather(yaw_first, -1, ring_c)
    scan_ang_vel = cfg.frame_rate * 360.0 / 1000.0  # deg per ms
    diff = torch.remainder(yaw_fp - yaw, cfg.angle_limit)
    return (diff / scan_ang_vel / 1000.0).to(torch.float64)


@annotate("preprocess.scan")
def preprocess_scan(raw: RawScan, cfg: LidarConfig) -> Scan:
    """Range gate, relative time, optional sort. Returns a full-scan `Scan`."""
    xyz = raw.xyz
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    d2 = x * x + y * y + z * z
    finite = torch.isfinite(x) & torch.isfinite(y) & torch.isfinite(z)
    gate = (d2 >= cfg.min_range**2) & (d2 <= cfg.max_range**2)
    mask = raw.mask & finite & gate
    stamp = raw.stamp[..., None]

    if cfg.time_source == "per_point":
        rel = raw.time - stamp
    elif cfg.time_source == "rotation_model":
        rel = rotation_model_rel_time(xyz, raw.ring, mask, cfg)
    else:
        has_time = torch.any(raw.mask & (raw.time > 0), dim=-1, keepdim=True)
        rel = torch.where(
            has_time, raw.time - stamp,
            rotation_model_rel_time(xyz, raw.ring, mask, cfg),
        )

    # anchor at the first valid point's relative time so rel_t >= 0
    inf = torch.full_like(rel, float("inf"))
    t0 = torch.amin(torch.where(mask, rel, inf), dim=-1, keepdim=True)
    t0 = torch.where(torch.isfinite(t0), t0, torch.zeros_like(t0))
    rel = rel - t0
    zero = torch.zeros_like(rel)
    t_begin = raw.stamp + t0[..., 0]

    if not cfg.sort_by_time:
        rel_s = torch.where(mask, rel, zero)
        t_span = torch.amax(rel_s, dim=-1)
        denom = torch.where(t_span > 0, t_span, torch.ones_like(t_span))
        return Scan(
            xyz=torch.where(mask[..., None], xyz, torch.zeros_like(xyz)).to(torch.float32),
            tau=(rel_s / denom[..., None]).to(torch.float32),
            rel_t=rel_s,
            mask=mask,
            t_begin=t_begin,
            t_end=t_begin + t_span,
        )

    # time sort as ONE int64 sort: the f32 bit pattern of a non-negative
    # float is order-preserving, the index in the low bits breaks ties by
    # sensor order (same key as the JAX package, so the same order)
    n = xyz.shape[-2]
    idx_bits = max(n - 1, 1).bit_length()
    t_bits = torch.clamp(rel, min=0.0).to(torch.float32).view(torch.int32).to(torch.int64)
    packed = (t_bits << idx_bits) | torch.arange(n, dtype=torch.int64, device=xyz.device)
    packed = torch.where(mask, packed, torch.full_like(packed, _I64_MAX))
    s = torch.sort(packed, dim=-1).values
    order = s & ((1 << idx_bits) - 1)
    mask_s = s < _I64_MAX
    xyz_o = torch.gather(xyz, -2, order[..., None].expand(order.shape + (3,)))
    xyz_s = torch.where(mask_s[..., None], xyz_o, torch.zeros_like(xyz)).to(torch.float32)
    rel_s = (s >> idx_bits).to(torch.int32).view(torch.float32).to(torch.float64)
    rel_s = torch.where(mask_s, rel_s, zero)
    t_span = torch.amax(rel_s, dim=-1)
    denom = torch.where(t_span > 0, t_span, torch.ones_like(t_span))
    return Scan(
        xyz=xyz_s,
        tau=(rel_s / denom[..., None]).to(torch.float32),
        rel_t=rel_s,
        mask=mask_s,
        t_begin=t_begin,
        t_end=t_begin + t_span,
    )


def segment_ids(scan: Scan, num_segments: int) -> torch.Tensor:
    """Equal-count segment index per sorted point (JAX preprocess.py:201;
    reference split_clouds, frame.cpp:53-99: cut when count hits
    (cut+1)*size/num_segments)."""
    rank = torch.cumsum(scan.mask.to(torch.int32), dim=-1) - 1
    valid = torch.clamp(torch.sum(scan.mask.to(torch.int32)), min=1)
    seg = torch.clamp((rank * num_segments) // valid, 0, num_segments - 1)
    return torch.where(scan.mask, seg, num_segments - 1).to(torch.int32)


def split_scan(scan: Scan, num_segments: int) -> list[Scan]:
    """Split a preprocessed scan into equal-count time segments (JAX
    preprocess.py:212; reference split_clouds, frame.cpp:53-99: each
    segment is processed as an independent frame with its own normalized
    timestamps).

    Returns a list of `Scan`s sharing the padded shape, each masking only its
    segment's points, with per-segment tau in [0, 1] and segment t_begin/t_end.
    """
    if num_segments <= 1:
        return [scan]
    seg = segment_ids(scan, num_segments)
    inf = torch.full_like(scan.rel_t, float("inf"))
    zero = torch.zeros_like(scan.rel_t)
    out = []
    for s in range(num_segments):
        m = scan.mask & (seg == s)
        t0 = torch.amin(torch.where(m, scan.rel_t, inf))
        t0 = torch.where(torch.isfinite(t0), t0, 0.0)
        rel = torch.where(m, scan.rel_t - t0, zero)
        span = torch.amax(torch.where(m, rel, zero))
        tau = (rel / torch.where(span > 0, span, 1.0)).to(torch.float32)
        out.append(Scan(
            xyz=scan.xyz,
            tau=tau,
            rel_t=rel,
            mask=m,
            t_begin=scan.t_begin + t0,
            t_end=scan.t_begin + t0 + torch.where(torch.any(m), span, 0.0),
        ))
    return out


def split_scan_compact(scan: Scan, num_segments: int) -> list[Scan]:
    """Equal-count frame split into COMPACT (ceil(N/k),)-shaped segments
    (JAX preprocess.py:246). The scan is time-sorted with padding at the
    tail, so each segment is a contiguous run of it: one window of static
    length ceil(N/k) at a start that stays on the device (an index gather
    at `arange + start`, JAX's `lax.dynamic_slice`); the step then runs at
    segment shape and costs ~1/k of a full step.

    Returns a list of k `Scan`s of shape (ceil(N/k),) with per-segment tau
    in [0, 1] and segment t_begin/t_end.
    """
    if num_segments <= 1:
        return [scan]
    n = scan.mask.shape[0]
    seg_len = -(-n // num_segments)  # ceil: count can exceed floor(n/k)
    v = torch.sum(scan.mask.to(torch.int64))
    idx = torch.arange(seg_len, device=scan.mask.device)
    zero = torch.zeros(seg_len, dtype=scan.rel_t.dtype, device=scan.rel_t.device)
    out = []
    for s in range(num_segments):
        start = (s * v) // num_segments
        count = ((s + 1) * v) // num_segments - start
        # the window is clamped to fit (as dynamic_slice clamps its start);
        # the segment's first point lies `off` into it
        real_start = torch.clamp(start, max=n - seg_len)
        off = start - real_start
        m = (idx >= off) & (idx < off + count)
        rows = idx + real_start
        xyz_s = torch.index_select(scan.xyz, 0, rows)
        rel_s = torch.index_select(scan.rel_t, 0, rows)
        first = torch.index_select(rel_s, 0, torch.clamp(off, 0, seg_len - 1).reshape(1))[0]
        t0 = torch.where(count > 0, first, 0.0)
        rel = torch.where(m, rel_s - t0, zero)
        span = torch.amax(torch.where(m, rel, zero))
        tau = (rel / torch.where(span > 0, span, 1.0)).to(torch.float32)
        out.append(Scan(
            xyz=torch.where(m[:, None], xyz_s, 0.0),
            tau=tau,
            rel_t=rel,
            mask=m,
            t_begin=scan.t_begin + t0,
            t_end=scan.t_begin + t0 + span,
        ))
    return out


def stack_raw_scans(raws) -> RawScan:
    """Stack raw scans (each as `pack_raw_scan` gives them) on a leading
    stream axis."""
    return RawScan(*(torch.stack(f) for f in zip(*raws)))


def to_device(arrays, device: torch.device | str) -> list[torch.Tensor]:
    """numpy arrays as tensors on `device`. On a CUDA device all of them go
    up in ONE copy: packed into a pinned staging buffer, copied with
    `non_blocking=True` and viewed back into their dtypes and shapes. A
    copy from pageable memory waits for the work queued before it on the
    stream (a host sync); this one does not, and PyTorch's pinned-memory
    cache reuses the staging buffer only after its copy has landed. On the
    CPU the arrays themselves, without a copy."""
    if torch.device(device).type == "cpu":
        return [torch.from_numpy(a) for a in arrays]
    offs, total = [], 0
    for a in arrays:
        offs.append(total)
        total += -(-a.nbytes // 16) * 16  # every view 16-byte aligned
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    host = staging.numpy()
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    dev = staging.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a).dtype).view(a.shape)
            for a, o in zip(arrays, offs)]


def pack_raw_scan(xyz, time=None, ring=None, stamp=0.0,
                  max_points: int | None = None,
                  device: torch.device | str = "cuda") -> RawScan:
    """Pad numpy-like arrays into a RawScan of tensors on `device` (one
    copy, `to_device`)."""
    xyz = np.asarray(xyz, dtype=np.float32)
    n = xyz.shape[0]
    cap = max_points if max_points is not None else n
    if n > cap:
        raise ValueError(f"scan has {n} points > capacity {cap}")

    def pad(a, fill, dtype):
        out = np.full((cap,) + a.shape[1:], fill, dtype=dtype)
        out[:n] = a
        return out

    t = np.zeros((n,), np.float64) if time is None else np.asarray(time, np.float64)
    r = np.zeros((n,), np.int32) if ring is None else np.asarray(ring, np.int32)
    mask = np.zeros((cap,), bool)
    mask[:n] = True
    return RawScan(*to_device(
        [pad(xyz, 0.0, np.float32), pad(t, 0.0, np.float64), pad(r, 0, np.int32), mask,
         np.asarray(stamp, np.float64)], device))
