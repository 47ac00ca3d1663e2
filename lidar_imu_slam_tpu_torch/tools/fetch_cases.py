"""Seeded inputs for the ICP candidate fetch
(`voxel_map.gather_candidate_planes_packed`): the cases on which the fetch
kernel (`csrc/candidate_fetch.cu`) must write the plain version's planes
bit for bit. The card tests (tests/test_torch_cuda_kernels.py) and
chip_smoke.py run every case through both; the CPU tests
(tests/test_torch_candidate_fetch.py) hold the cases' coverage with the
plain version.

`case(name, device, small=False)` returns (map, queries, qmask, MapConfig,
anchor). Each stream's map holds three clouds of uniform points in a box of
20 x 20 x 6 voxels (first point per half voxel each, so voxels fill up to
Kp lanes and some stay part-empty); its queries are map points moved up to
0.3 voxel (60%), uniform points in a box 8 voxels wider (20%: absent
voxels) and points
snapped to multiples of half a voxel, some an ulp off (20%: the voxel
index's division on an edge). The anchor is the masked queries' mean
rounded to f32 and held in f64, as `ops/icp._fused_round` passes it.

* batched_8192 / batched_16384: 4 streams at the batched deployments'
  per-stream source sizes (kitti_64beam, livox_dense), 1 m voxels, NB 8;
* single_stream: 2-D queries, no stream axis (K4's and K1's rounds);
* neighborhood_27: the 3 x 3 x 3 shell (the MapConfig default);
* nn_points_4: a packed slab of Kp = 4 lanes;
* odd_width_5: Kp = 5 (max_points_per_voxel 5), rows not 8-byte aligned;
* third_masked: a third of the queries masked out;
* empty_map: nothing inserted;
* anchor_f32: the anchor in f32 (the fused pair's rounds);
* far_negative: the scene around (300, -300, -3) m in 0.25 m voxels, so
  the wrapped keys wrap on every axis.
`small` cuts every case to at most 2 streams of 256 queries (CPU tests).
`deployment(name, device)` builds the fetch of a benchmark cell at full
size (`DEPLOYMENTS`) for chip_smoke.py's timings: its streams, queries and
neighbourhood, and a map as large as the cell's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as cfgmod
from ..ops import voxel_map

CASES = ("batched_8192", "batched_16384", "single_stream", "neighborhood_27", "nn_points_4",
         "odd_width_5", "third_masked", "empty_map", "anchor_f32", "far_negative")

BOX = np.array([20.0, 20.0, 6.0], np.float32)  # voxels


def _shape(name: str):
    """(streams or None, queries a stream, MapConfig, scene centre)."""
    kw = dict(voxel_size=1.0, max_range=100.0, capacity=1 << 15, neighborhood=8)
    centre = (0.0, 0.0, 0.0)
    streams, n = 2, 2048
    if name == "batched_8192":
        streams, n = 4, 8192
    elif name == "batched_16384":
        streams, n, kw["capacity"] = 4, 16384, 1 << 16
    elif name == "single_stream":
        streams, n = None, 4096
    elif name == "neighborhood_27":
        kw["neighborhood"] = 27
    elif name == "nn_points_4":
        kw["nn_points"] = 4
    elif name == "odd_width_5":
        kw["max_points_per_voxel"] = 5
    elif name == "third_masked":
        streams = 4
    elif name == "far_negative":
        kw.update(voxel_size=0.25, max_range=20.0)
        centre = (300.0, -300.0, -3.0)
    elif name not in CASES:
        raise ValueError(f"unknown fetch case {name!r}")
    return streams, n, cfgmod.MapConfig(**kw), np.array(centre, np.float32)


def _queries(rng, world, n, vs):
    """Moved map points, absent-voxel points and voxel-edge points."""
    lo, hi = world.min(0), world.max(0)
    n_move, n_far = (6 * n) // 10, (2 * n) // 10
    n_edge = n - n_move - n_far
    moved = world[rng.integers(0, len(world), n_move)] + rng.uniform(-0.3, 0.3, (n_move, 3)) * vs
    far = rng.uniform(lo - 4.0 * vs, hi + 4.0 * vs, (n_far, 3))
    edge = np.round(rng.uniform(lo, hi, (n_edge, 3)) / (0.5 * vs)) * (0.5 * vs)
    edge = edge.astype(np.float32)
    nudge = rng.integers(-1, 2, edge.shape)  # an ulp down, on the edge, an ulp up
    edge = np.where(nudge < 0, np.nextafter(edge, -np.inf),
                    np.where(nudge > 0, np.nextafter(edge, np.inf), edge))
    q = np.concatenate([moved.astype(np.float32), far.astype(np.float32), edge])
    return q[rng.permutation(n)].astype(np.float32)


def _make(cfg, streams, n, centre, seed, device, masked=False, empty=False, f32_anchor=False,
          box=BOX, per=None):
    """A map of three clouds of `per` points (default 4n) a stream in `box`
    (voxels) and n queries a stream (see above)."""
    rng = np.random.default_rng(seed)
    s = 1 if streams is None else streams
    per = 4 * n if per is None else per
    box = np.asarray(box, np.float32) * cfg.voxel_size
    clouds = [(rng.uniform(-0.5, 0.5, (s, per, 3)) * box + centre).astype(np.float32)
              for _ in range(3)]
    q = np.stack([_queries(rng, clouds[0][i], n, cfg.voxel_size) for i in range(s)])
    qm = rng.uniform(size=(s, n)) >= 1.0 / 3.0 if masked else np.ones((s, n), bool)

    lead = () if streams is None else (s,)
    m = voxel_map.create(cfg, device, streams=streams)
    if not empty:
        ones = torch.ones(lead + (per,), dtype=torch.bool, device=device)
        for c in clouds:
            pts = torch.from_numpy(c.reshape(lead + (per, 3))).to(device)
            g = voxel_map.fused_downsample(pts, ones, cfg.voxel_size, per)
            m = voxel_map.insert_grouped(m, g, cfg, inplace=True)
    queries = torch.from_numpy(q.reshape(lead + (n, 3))).to(device)
    qmask = torch.from_numpy(qm.reshape(lead + (n,))).to(device)
    w = qmask[..., None].to(torch.float64)
    anchor = (torch.sum(queries.to(torch.float64) * w, dim=-2)
              / torch.clamp(torch.sum(w, dim=-2), min=1.0)).to(torch.float32)
    return m, queries, qmask, cfg, anchor if f32_anchor else anchor.to(torch.float64)


def case(name: str, device, small: bool = False):
    """The case's (map, queries (..., N, 3) f32, qmask (..., N) bool,
    MapConfig, anchor (..., 3))."""
    streams, n, cfg, centre = _shape(name)
    if small:
        streams, n = (None if streams is None else min(streams, 2)), 256
    return _make(cfg, streams, n, centre, sum(map(ord, name)), device,
                 masked=name == "third_masked", empty=name == "empty_map",
                 f32_anchor=name == "anchor_f32")


# the benchmark's batched cells: (preset, streams, source points a stream,
# live voxels a stream after the cells' measured window, neighbourhood)
DEPLOYMENTS = {"hdl64": ("kitti_64beam", 128, 8192, 28_362, 8),
               "livox": ("livox_dense", 64, 16384, 90_900, 8),
               "hdl64_nb27": ("kitti_64beam", 128, 8192, 28_362, 27)}
SLAB = 3  # voxels: the map's height, a ground layer with low structure


def deployment(name: str, device):
    """The fetch of a batched cell at full size: its preset's MapConfig
    (without the f32 point slab, which the fetch does not read; NB as
    `DEPLOYMENTS` gives it), S streams x N queries in voxel-key order, as
    the source arrives (`first_point_per_voxel`), and per stream a map of
    about the cell's live voxels: a slab SLAB voxels high and square, its
    side set by the voxel count (97 / 174 m at 1 m voxels, within the 100 m
    range), filled by three clouds of two points a voxel each, so that the
    rows the fetch reads outgrow the card's L2 as the cell's do.
    (map, queries, qmask, MapConfig, anchor) as `case`."""
    preset, streams, n, live, nb = DEPLOYMENTS[name]
    cfg = dataclasses.replace(getattr(cfgmod, preset)().map, store_points=False,
                              neighborhood=nb)
    side = round(float(np.sqrt(live / SLAB)))
    box = np.array([side, side, SLAB], np.float32)
    m, q, qm, cfg, anchor = _make(cfg, streams, n, np.zeros(3, np.float32), streams, device,
                                  box=box, per=2 * side * side * SLAB)
    order = torch.argsort(voxel_map.pack_key(voxel_map.voxel_of(q, cfg.voxel_size)), dim=-1,
                          stable=True)
    return m, torch.gather(q, 1, order[..., None].expand(q.shape)).contiguous(), qm, cfg, anchor
