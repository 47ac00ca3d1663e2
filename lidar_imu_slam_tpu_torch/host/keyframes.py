"""Online keyframe backend (counterpart of the JAX package's
`host/keyframes.py`): loop closure and pose-graph optimization behind the
odometry runner.

  * keyframe selection by travelled distance / rotation against the last
    keyframe, fed from the runner in pose chunks (one host copy per
    `BackendConfig.chunk` scans; keypoints are copied only for the scans
    chosen as keyframes, in one copy a chunk),
  * periodic pose-graph optimization on the backend's device: odometry-
    chain edges from the RAW odometry poses + persisted ICP-verified loop-
    closure edges,
  * trajectory correction: every scan pose is re-anchored through its most
    recent keyframe's optimized pose.

The keypoints a step returns are its ICP source in the WORLD frame at the
scan's initial guess; `observe_chunk` takes them to the sensor frame with
the scan's FINAL pose, as JAX does (keyframes.py:88-91), so a stored cloud
is off by that scan's ICP correction.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..models import backend as backend_mod
from ..ops import icp as icp_ops
from ..ops import voxel_map
from ..ops.preprocess import to_device
from ..utils.profiling import annotate


def _log():
    return logging.getLogger(__name__)


def verify_pair(cloud_i, mask_i, cloud_j, mask_j, guess, map_cfg, max_corresp: float,
                device: torch.device | str):
    """Keyframe-to-keyframe ICP (JAX keyframes.py:154-181, there a jitted
    closure): cloud_j registered against a map of cloud_i under `guess`
    (T_i^-1 T_j), with the classic f64 `icp_registration`. Host arrays go
    up in one copy."""
    ci, mi, cj, mj, gs = to_device(
        [np.asarray(cloud_i, np.float32), np.asarray(mask_i, bool),
         np.asarray(cloud_j, np.float32), np.asarray(mask_j, bool),
         np.asarray(guess, np.float64)], device)
    m = voxel_map.create(map_cfg, device)
    m = voxel_map.insert(m, ci, mi, map_cfg)
    return icp_ops.icp_registration(m, cj, mj, gs, max_corresp, max_corresp / 3.0,
                                    map_cfg, 30, 1e-5)


class _Pending:
    """A keyframe cloud still on the device (fetched at the chunk's end)."""

    def __init__(self, cloud, mask, pose):
        self.cloud, self.mask, self.pose = cloud, mask, pose


class OnlineBackend:
    def __init__(self, cfg: PipelineConfig, device: torch.device | str = "cuda"):
        if not cfg.map.store_points:
            # neither package can verify a loop without it
            raise ValueError("loop verification runs the classic ICP, which needs the f32 "
                             "point slab: MapConfig(store_points=True)")
        self.cfg = cfg
        self.device = torch.device(device)
        b = cfg.backend
        self.bcfg = b
        # raw odometry keyframes (never overwritten by optimization — the
        # odometry-chain edges must stay the original measurements)
        self.kf_poses: list[np.ndarray] = []
        self.kf_scan_idx: list[int] = []
        self.kf_clouds: list[np.ndarray] = []  # sensor-frame f32 (N, 3)
        self.kf_cloud_masks: list[np.ndarray] = []
        # persisted verified loop edges: (i, j, T_i_j, weight)
        self.loop_edges: list[tuple] = []
        self._checked_pairs: set[tuple] = set()
        self.optimized: Optional[np.ndarray] = None  # (K, 4, 4)
        self._kf_at_last_opt = 0
        self.num_optimizations = 0
        self.thin_events = 0
        self.dropped_keyframes = 0
        self.dropped_loop_edges = 0
        # keyframe clouds are ~4k points: a small dedicated table
        self._verify_cfg = dataclasses.replace(cfg.map, capacity=1 << 13, neighborhood=27)

    # -- keyframe ingestion -------------------------------------------------

    def observe_chunk(self, scan_indices, poses, clouds, masks) -> None:
        """poses: (C, 4, 4) numpy chunk; clouds / masks: per-scan WORLD-frame
        keypoints (numpy or device tensors; a device chunk is copied to the
        host only for the selected keyframes, in one copy)."""
        for k, i in enumerate(scan_indices):
            pose = np.asarray(poses[k], np.float64)
            if self.kf_poses:
                rel = np.linalg.inv(self.kf_poses[-1]) @ pose
                dist = float(np.linalg.norm(rel[:3, 3]))
                ang = float(np.arccos(np.clip((np.trace(rel[:3, :3]) - 1.0) / 2.0, -1, 1)))
                if dist < self.bcfg.keyframe_dist and ang < self.bcfg.keyframe_rot:
                    continue
            if len(self.kf_poses) >= self.bcfg.max_keyframes:
                self._thin()
            if len(self.kf_poses) >= self.bcfg.max_keyframes:
                # thinning freed nothing (every old keyframe anchors a
                # verified loop edge) — drop the new keyframe, loudly
                self.dropped_keyframes += 1
                _log().warning(
                    "keyframe store full (%d) and fully loop-anchored; "
                    "dropping keyframe at scan %d (%d dropped so far)",
                    self.bcfg.max_keyframes, int(i), self.dropped_keyframes,
                )
                continue
            self.kf_poses.append(pose)
            self.kf_scan_idx.append(int(i))
            self.kf_clouds.append(_Pending(clouds[k], masks[k], pose))
            self.kf_cloud_masks.append(None)
        self._fetch_pending()
        if (len(self.kf_poses) - self._kf_at_last_opt >= self.bcfg.optimize_every
                and len(self.kf_poses) >= 3):
            self.optimize()

    def _fetch_pending(self) -> None:
        """The new keyframes' clouds to the host (one copy for those on the
        device), then to the SENSOR frame: loop verification registers
        cloud_j against cloud_i under the relative-pose guess."""
        slots = [s for s, c in enumerate(self.kf_clouds) if isinstance(c, _Pending)]
        by_len = {}  # device clouds by point count (frame splitting changes it)
        for s in slots:
            if isinstance(self.kf_clouds[s].cloud, torch.Tensor):
                by_len.setdefault(self.kf_clouds[s].cloud.shape[0], []).append(s)
        fetched = {}
        for group in by_len.values():
            pend = [self.kf_clouds[s] for s in group]
            host = torch.cat([torch.stack([p.cloud.float() for p in pend]),
                              torch.stack([p.mask.float() for p in pend])[..., None]],
                             dim=-1).cpu().numpy()  # (P, N, 4): xyz | mask
            for s, row in zip(group, host):
                fetched[s] = (row[:, :3], row[:, 3] > 0)
        for s in slots:
            p = self.kf_clouds[s]
            cloud, mask = fetched.get(s, (p.cloud, p.mask))
            cloud = np.asarray(cloud, np.float32)
            mask = np.asarray(mask)
            R, t = p.pose[:3, :3], p.pose[:3, 3]
            sensor = ((cloud.astype(np.float64) - t) @ R).astype(np.float32)
            self.kf_clouds[s] = np.where(mask[:, None], sensor, 0.0)
            self.kf_cloud_masks[s] = mask

    # -- capacity management --------------------------------------------------

    def _thin(self) -> None:
        """Halve the density of the OLDER half of the keyframe store:
        every second non-anchored old keyframe is dropped, loop-edge
        endpoints and the recent half are kept. Keyframe/loop-edge indices
        and the checked-pairs cache are remapped; `correct` keeps working
        because `kf_scan_idx` stays sorted."""
        n = len(self.kf_poses)
        anchored = set()
        for (i, j, _, _) in self.loop_edges:
            anchored.add(i)
            anchored.add(j)
        half = n // 2
        keep = [k for k in range(n) if k >= half or k in anchored or k % 2 == 0]
        if len(keep) == n:
            return
        remap = {old: new for new, old in enumerate(keep)}
        self.thin_events += 1
        self.dropped_keyframes += n - len(keep)
        _log().warning(
            "keyframe store reached %d: thinned oldest half %d -> %d "
            "keyframes (event %d)",
            n, half, sum(1 for k in keep if k < half), self.thin_events,
        )
        self.kf_poses = [self.kf_poses[k] for k in keep]
        self.kf_scan_idx = [self.kf_scan_idx[k] for k in keep]
        self.kf_clouds = [self.kf_clouds[k] for k in keep]
        self.kf_cloud_masks = [self.kf_cloud_masks[k] for k in keep]
        self.loop_edges = [(remap[i], remap[j], m, w) for (i, j, m, w) in self.loop_edges]
        self._checked_pairs = {
            (remap[i], remap[j]) for (i, j) in self._checked_pairs if i in remap and j in remap
        }
        if self.optimized is not None:
            self.optimized = self.optimized[[k for k in keep if k < len(self.optimized)]]
        self._kf_at_last_opt = sum(1 for k in keep if k < self._kf_at_last_opt)

    # -- optimization -------------------------------------------------------

    def _verify_loops(self, g) -> None:
        """ICP-verify proximity candidates; persist accepted edges."""
        cand = backend_mod.find_loop_candidates(
            g, self.bcfg.loop_radius, self.bcfg.min_index_gap, self.bcfg.max_candidates)
        cand = torch.stack([cand.idx_i, cand.idx_j, cand.mask.to(torch.int32)]).cpu().numpy()
        for c in range(int(cand[2].sum())):
            i, j = int(cand[0, c]), int(cand[1, c])
            if (i, j) in self._checked_pairs:
                continue
            self._checked_pairs.add((i, j))
            guess = np.linalg.inv(self.kf_poses[i]) @ self.kf_poses[j]
            res = verify_pair(self.kf_clouds[i], self.kf_cloud_masks[i], self.kf_clouds[j],
                              self.kf_cloud_masks[j], guess, self._verify_cfg,
                              self.bcfg.verify_max_corresp, self.device)
            # the pose, residual and count in one copy
            row = torch.cat([res.pose.reshape(16), res.residual_rms.reshape(1),
                             res.num_correspondences.to(torch.float64).reshape(1)]).cpu().numpy()
            if (row[16] < self.bcfg.verify_max_residual
                    and int(row[17]) >= self.bcfg.verify_min_correspondences):
                self.loop_edges.append((i, j, row[:16].reshape(4, 4), self.bcfg.loop_weight))

    @annotate("backend.optimize")
    def optimize(self) -> None:
        b = self.bcfg
        # edge capacity: chain edges are mandatory; newest loops win
        loop_budget = b.max_edges - (len(self.kf_poses) - 1)
        if len(self.loop_edges) > loop_budget:
            drop = len(self.loop_edges) - loop_budget
            self.dropped_loop_edges += drop
            _log().warning(
                "edge store full: dropping %d oldest loop edges "
                "(%d total dropped; raise BackendConfig.max_edges)",
                drop, self.dropped_loop_edges,
            )
            self.loop_edges = self.loop_edges[drop:]
        g = backend_mod.from_chain(np.stack(self.kf_poses), b.max_keyframes, b.max_edges,
                                   weight=b.odom_weight, device=self.device)
        # candidate search runs on current best estimates
        if self.optimized is not None and len(self.optimized) <= len(self.kf_poses):
            gp = np.broadcast_to(np.eye(4), g.poses.shape).copy()
            gp[: len(self.kf_poses)] = self.kf_poses
            gp[: len(self.optimized)] = self.optimized
            g = g._replace(poses=to_device([gp], self.device)[0])
        self._verify_loops(g)
        if self.loop_edges:
            meas = to_device([np.stack([m for (_, _, m, _) in self.loop_edges])], self.device)[0]
            for k, (i, j, _, w) in enumerate(self.loop_edges):
                g = backend_mod.add_edge(g, i, j, meas[k], w)
            use_cg = b.solver == "cg" or (b.solver == "auto" and b.max_keyframes > 128)
            if use_cg:
                g = backend_mod.optimize_cg(g, iterations=b.lm_iterations,
                                            cg_iterations=b.cg_iterations)
            else:
                g = backend_mod.optimize(g, iterations=b.lm_iterations)
            self.optimized = g.poses[: len(self.kf_poses)].cpu().numpy()
        else:
            self.optimized = np.stack(self.kf_poses)
        self._kf_at_last_opt = len(self.kf_poses)
        self.num_optimizations += 1

    # -- trajectory correction ---------------------------------------------

    def correct(self, poses: np.ndarray) -> np.ndarray:
        """Re-anchor every scan pose through its most recent keyframe:
        T_i' = opt[k(i)] @ raw_kf[k(i)]^-1 @ T_i."""
        if self.optimized is None or not self.kf_poses:
            return poses
        out = np.array(poses, np.float64, copy=True)
        kf_idx = np.asarray(self.kf_scan_idx)
        for s in range(len(out)):
            k = int(np.searchsorted(kf_idx, s, side="right")) - 1
            if k < 0:
                continue
            delta = self.optimized[k] @ np.linalg.inv(self.kf_poses[k])
            out[s] = lie_np_orthonormalize(delta @ out[s])
        return out


def lie_np_orthonormalize(T: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    out = T.copy()
    out[:3, :3] = Rotation.from_matrix(T[:3, :3]).as_matrix()
    return out
