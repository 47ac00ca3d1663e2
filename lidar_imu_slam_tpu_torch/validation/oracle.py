"""Independent plain-numpy oracle of the reference's *wired* odometry path
(the port's own copy of the JAX package's `validation/oracle.py`, kept
equal in behaviour: the port runs where JAX is not installed, and any
module of the JAX package imports it).

This reimplements, from the algorithm definitions, exactly the pipeline the
C++ reference ships end-to-end (reference src/odom_run.cpp:154-185 ->
src/sensors/lidar/icp.cpp:49-86):

  voxelize (double downsample, reference icp.cpp:126-135)
  + IQR range-outlier rejection      (reference icp.cpp:88-124)
  + adaptive sigma                   (reference threshold.cpp:16-29)
  + CV prediction                    (reference icp.cpp:146-154)
  + robust GN point-to-point ICP     (reference registration.cpp:43-130)
  + voxel-map update & eviction      (reference voxel_hash_map.cpp:12-62,
                                      132-171; voxel_block.cpp:68-118)

It shares NO code with the JAX pipeline (numpy + scipy only; its own SE(3)
helpers), so pose agreement between the two is genuine trajectory-level
parity evidence rather than self-consistency.

Every documented behavioral deviation of the JAX pipeline (PARITY.md) is a
toggle here, so tests can run the oracle in two modes:

  * ``OracleConfig.reference()``  — the raw reference behavior as shipped,
    including its own-voxel-first NN with the farthest-voxel fallback bug
    (max-heap ``top()``, reference voxel_hash_map.cpp:81-101).
  * ``OracleConfig.match_jax()``  — deviations toggled to the JAX pipeline's
    choices (true 27-neighborhood NN, world-frame f32 downsample grid at the
    motion guess, GN guards, whole-block scaled eviction), which must agree
    with models/kiss_icp.register_frame scan-by-scan to float tolerance.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IQR_TUKEY = 1.25  # reference common.hpp:15


# ---------------------------------------------------------------------------
# SE(3) helpers (independent of ops/lie.py; Sophus [v, w] twist convention)
# ---------------------------------------------------------------------------


def _hat(w):
    return np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )


def so3_exp(w):
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-10:
        return np.eye(3) + W + 0.5 * W @ W
    return (
        np.eye(3)
        + (np.sin(th) / th) * W
        + ((1.0 - np.cos(th)) / (th * th)) * W @ W
    )


def so3_log(R):
    # quaternion route (pi-robust), mirroring Sophus' SO3::log numerics
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(R).as_rotvec()


def _left_jacobian(w):
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-10:
        return np.eye(3) + 0.5 * W + W @ W / 6.0
    return (
        np.eye(3)
        + ((1.0 - np.cos(th)) / (th * th)) * W
        + ((th - np.sin(th)) / th**3) * W @ W
    )


def _left_jacobian_inv(w):
    th = np.linalg.norm(w)
    W = _hat(w)
    if th < 1e-10:
        return np.eye(3) - 0.5 * W + W @ W / 12.0
    half = 0.5 * th
    coeff = (1.0 - half * np.cos(half) / np.sin(half)) / (th * th)
    return np.eye(3) - 0.5 * W + coeff * W @ W


def se3_exp(xi):
    v, w = xi[:3], xi[3:]
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _left_jacobian(w) @ v
    return T


def se3_log(T):
    w = so3_log(T[:3, :3])
    v = _left_jacobian_inv(w) @ T[:3, 3]
    return np.concatenate([v, w])


def inv(T):
    R = T[:3, :3]
    out = np.eye(4)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def orthonormalize(T):
    """Quaternion round-trip of the rotation block (ops/lie.orthonormalize)."""
    from scipy.spatial.transform import Rotation

    out = T.copy()
    out[:3, :3] = Rotation.from_matrix(T[:3, :3]).as_matrix()
    return out


# ---------------------------------------------------------------------------
# Reference building blocks
# ---------------------------------------------------------------------------


def rigid_f32(R, t, p):
    """Elementwise f32 rigid transform, bit-matching ops/lie.rotate_points
    (which avoids the MXU's bf16 truncation). numpy's f32 matmul (BLAS sgemm)
    accumulates in a different order, so a matmul here would NOT bit-match."""
    R = R.astype(np.float32)
    t = t.astype(np.float32)
    p = p.astype(np.float32)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    rot = np.stack(
        [
            R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z,
        ],
        axis=-1,
    )
    return rot + t


def vox_indices(points, voxel_size, f32: bool):
    """Truncation-toward-zero voxel indices (reference
    calculation_helpers.cpp:142-147). With ``f32`` the division is done in
    float32, bit-matching the JAX pipeline's on-device math."""
    if f32:
        return (points.astype(np.float32) / np.float32(voxel_size)).astype(
            np.int32
        )
    return (points / voxel_size).astype(np.int64)


def iqr_bounds(values):
    """Tukey fences with the reference's median-of-halves IQR
    (reference common.hpp:18-64, icp.cpp:108-112)."""
    a = np.sort(np.asarray(values, np.float64))
    n = len(a)
    if n <= 1:
        q1, q3 = 0.0, (a[0] if n else 0.0)
    else:

        def med(start, size):
            half = size // 2
            if size % 2 == 0:
                return 0.5 * (a[start + half - 1] + a[start + half])
            return a[start + half]

        half = n // 2
        q1 = med(0, max(half, 1))
        q3_start = half + n % 2
        q3 = med(q3_start, max(n - q3_start, 1))
    iqr = q3 - q1
    return q1 - IQR_TUKEY * iqr, q3 + IQR_TUKEY * iqr


@dataclasses.dataclass
class OracleConfig:
    voxel_size: float = 1.0
    max_range: float = 100.0
    max_points_per_voxel: int = 10
    initial_threshold: float = 2.0
    min_motion_th: float = 0.1
    max_iterations: int = 500
    estimation_threshold: float = 1e-4

    # --- deviation toggles (False = raw reference, True = JAX pipeline) ----
    # PARITY.md #1: true nearest neighbor over the 3x3x3 shell vs the
    # reference's own-voxel-first + farthest-voxel max-heap fallback
    true_nn: bool = False
    # kiss_icp.register_frame deviation: downsample grids laid out in the
    # WORLD frame at the motion-model guess, in f32, instead of sensor frame
    # f64 (same density, shifted grid alignment)
    world_frame_downsample: bool = False
    # store/query map points in f32 (device layout) vs f64 Eigen
    f32_points: bool = False
    # GN robustness guards of ops/icp.py (ridge, min-correspondence freeze,
    # step clamp, scan-level divergence gate, per-scan orthonormalization)
    gn_guards: bool = False
    # PARITY.md #4/#12: evict whole far blocks at voxel_size-scaled index
    # distance vs the reference's per-point removal at raw index distance
    block_evict: bool = False
    # PARITY.md #11: candidates fetched once per outer round and reused until
    # the accumulated correction drifts beyond half a voxel (ops/icp.py
    # refetch_d2 / max_refetch), vs the reference's fresh per-iteration query
    cached_candidates: bool = False
    min_correspondences: int = 20
    max_step_norm: float = 2.0
    max_model_deviation: float = 10.0

    @classmethod
    def reference(cls, **kw) -> "OracleConfig":
        return cls(**kw)

    @classmethod
    def match_jax(cls, **kw) -> "OracleConfig":
        return cls(
            true_nn=True,
            world_frame_downsample=True,
            f32_points=True,
            gn_guards=True,
            block_evict=True,
            cached_candidates=True,
            **kw,
        )


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
_OWN = _OFFSETS.index((0, 0, 0))
_OFF_D2 = np.array([dx * dx + dy * dy + dz * dz for dx, dy, dz in _OFFSETS], np.float64)


class VoxelMap:
    """dict-of-lists voxel map with the reference's bounded blocks
    (reference voxel_hash_map.cpp, voxel_block.cpp). Blocks are also kept as
    a padded (B, K, 3) array rebuilt lazily per scan so the per-iteration NN
    sweep is vectorized numpy instead of a per-point Python loop."""

    def __init__(self, cfg: OracleConfig):
        self.cfg = cfg
        self.map: dict[tuple, list] = {}
        self._dirty = True
        self._rows: dict[tuple, int] = {}
        self._pts = None  # (B+1, K, 3); row B is the +inf padding row

    def __len__(self):
        return len(self.map)

    def _mark(self):
        self._dirty = True

    def _ensure_arrays(self):
        if not self._dirty:
            return
        cfg = self.cfg
        k = cfg.max_points_per_voxel
        dtype = np.float32 if cfg.f32_points else np.float64
        b = len(self.map)
        pts = np.full((b + 1, k, 3), np.inf, dtype)
        rows = {}
        for r, (v, blk) in enumerate(self.map.items()):
            rows[v] = r
            arr = np.asarray(blk, dtype)
            pts[r, : len(arr)] = arr
        self._rows, self._pts, self._dirty = rows, pts, False

    def _neighbor_rows(self, qvox):
        """(S, 27) block-row indices for each query's 3x3x3 shell (pad row
        where the voxel is absent)."""
        pad = len(self.map)
        get = self._rows.get
        out = np.empty((len(qvox), 27), np.int64)
        keys = [tuple(v) for v in qvox]
        for o, (dx, dy, dz) in enumerate(_OFFSETS):
            out[:, o] = [get((x + dx, y + dy, z + dz), pad) for x, y, z in keys]
        return out

    def fetch_candidates(self, q64):
        """Candidate blocks of each query's 3x3x3 shell at the CURRENT query
        positions (ops/voxel_map.gather_candidates analog): (S, 27*K, 3) in
        the mode's dtype, +inf rows where the voxel is absent."""
        cfg = self.cfg
        self._ensure_arrays()
        qv = vox_indices(q64, cfg.voxel_size, cfg.f32_points)
        rows = self._neighbor_rows(qv)
        k = cfg.max_points_per_voxel
        return self._pts[rows].reshape(len(q64), 27 * k, 3)

    @staticmethod
    def nn_from_candidates(cand, q64):
        """(tgt f64, d2 mode-precision, found) against cached candidates
        (ops/voxel_map.nn_from_candidates analog)."""
        q = q64.astype(cand.dtype)
        d2 = np.sum((cand - q[:, None, :]) ** 2, axis=-1)
        best = np.argmin(d2, axis=1)
        lanes = np.arange(len(q))
        bd2 = d2[lanes, best]
        found = np.isfinite(bd2)
        tgt = cand[lanes, best].astype(np.float64)
        tgt[~found] = 0.0
        return tgt, bd2, found

    def nn_batch(self, q64):
        """Batched NN per cfg.true_nn. q64: (S, 3) f64 query points.

        Returns (tgt (S, 3) f64, d2 (S,) in the mode's precision, found (S,)).
        """
        cfg = self.cfg
        self._ensure_arrays()
        k = cfg.max_points_per_voxel
        dtype = self._pts.dtype
        qv = vox_indices(q64, cfg.voxel_size, cfg.f32_points)
        rows = self._neighbor_rows(qv)  # (S, 27)
        q = q64.astype(dtype)

        if cfg.true_nn:
            cand = self._pts[rows].reshape(len(q), 27 * k, 3)  # (S, 27K, 3)
            d2 = np.sum((cand - q[:, None, :]) ** 2, axis=-1)
            best = np.argmin(d2, axis=1)
            bd2 = d2[np.arange(len(q)), best]
            found = np.isfinite(bd2)
            tgt = cand[np.arange(len(q)), best].astype(np.float64)
            tgt[~found] = 0.0
            return tgt, bd2, found

        # reference get_closest_neighbour (voxel_hash_map.cpp:64-102):
        # own voxel when present; else the present neighbor voxel with the
        # LARGEST voxel distance (the max-heap `top()` bug); Zero() sentinel
        # when the whole shell is empty
        pad = len(self.map)
        present = rows != pad
        own = present[:, _OWN]
        # pick per query: own voxel, else argmax of voxel distance among present
        score = np.where(present, _OFF_D2[None, :], -1.0)
        pick = np.where(own, _OWN, np.argmax(score, axis=1))
        blk = self._pts[rows[np.arange(len(q)), pick]]  # (S, K, 3)
        d2 = np.sum((blk - q[:, None, :]) ** 2, axis=-1)
        best = np.argmin(d2, axis=1)
        bd2 = d2[np.arange(len(q)), best]
        found = np.any(present, axis=1) & np.isfinite(bd2)
        tgt = blk[np.arange(len(q)), best].astype(np.float64)
        # Zero() sentinel for not-found, gated by the caller at ||q||^2
        tgt[~found] = 0.0
        bd2 = np.where(found, bd2, np.sum(q64 * q64, axis=1))
        return tgt, bd2, found

    def insert(self, points):
        """Append-if-not-full per voxel, sequential first-wins
        (reference voxel_hash_map.cpp:48-61, voxel_block.cpp:68-73)."""
        cfg = self.cfg
        vox = vox_indices(points, cfg.voxel_size, cfg.f32_points)
        for v, p in zip(map(tuple, vox), points):
            blk = self.map.setdefault(v, [])
            if len(blk) < cfg.max_points_per_voxel:
                blk.append(np.asarray(p))
        self._mark()

    def insert_grouped(self, points, head, key_points=None):
        """ops/voxel_map.insert_grouped semantics: groups are delimited by
        `head` (formed on the PRE-correction grouping); the whole group lands
        in the block keyed by its HEAD point's voxel — computed from
        `key_points` (the pre-correction points, kiss_icp's pre_keys) when
        given, else from `points`."""
        cfg = self.cfg
        kp = points if key_points is None else key_points
        i = 0
        n = len(points)
        while i < n:
            j = i + 1
            while j < n and not head[j]:
                j += 1
            key = tuple(
                vox_indices(kp[i][None, :], cfg.voxel_size, cfg.f32_points)[0]
            )
            blk = self.map.setdefault(key, [])
            for p in points[i:j]:
                if len(blk) >= cfg.max_points_per_voxel:
                    break
                blk.append(np.asarray(p))
            i = j
        self._mark()

    def evict_far(self, origin):
        cfg = self.cfg
        origin_vox = vox_indices(origin[None, :], cfg.voxel_size, cfg.f32_points)[0]
        if cfg.block_evict:
            # JAX pipeline: drop the whole block when the scaled voxel-index
            # distance exceeds max_range (ops/voxel_map.evict_far default)
            scale = cfg.voxel_size
            dead = [
                v
                for v in self.map
                if sum(((a - b) * scale) ** 2 for a, b in zip(v, origin_vox))
                > cfg.max_range**2
            ]
            for v in dead:
                del self.map[v]
            self._mark()
            return
        # reference: raw index distance vs meters (voxel_hash_map.cpp:160 —
        # units mix; exact only at voxel_size = 1), then per-point removal
        # (voxel_block.cpp:107-118), erase when emptied
        max_d2 = cfg.max_range**2
        dead = []
        for v, blk in self.map.items():
            if sum((a - b) ** 2 for a, b in zip(v, origin_vox)) > max_d2:
                kept = [
                    p
                    for p in blk
                    if np.sum((np.asarray(p, np.float64) - origin) ** 2) <= max_d2
                ]
                if kept:
                    self.map[v] = kept
                else:
                    dead.append(v)
        for v in dead:
            del self.map[v]
        self._mark()


# ---------------------------------------------------------------------------
# Downsampling
# ---------------------------------------------------------------------------


def voxel_downsample(points, voxel_size, f32: bool):
    """First point per voxel in input order (reference icp.cpp:9-30)."""
    vox = vox_indices(points, voxel_size, f32)
    seen = set()
    out = []
    for v, p in zip(map(tuple, vox), points):
        if v not in seen:
            seen.add(v)
            out.append(p)
    return np.asarray(out)


def fused_downsample_order(points_f32, voxel_size):
    """The JAX pipeline's fused grouped downsample (ops/voxel_map.
    fused_downsample): first point per 0.5*voxel cell, winner = lowest
    original index, output ordered by (coarse voxel lex, fine residual, idx).

    Returns (points (M, 3) f32 in that order, head (M,) bool marking the
    first point of each coarse (= map) voxel group).
    """
    p = points_f32.astype(np.float32)
    fine = (p / np.float32(0.5 * voxel_size)).astype(np.int32)
    coarse = (fine + ((fine >> 31) & 1)) >> 1  # trunc-toward-zero halving
    fres = fine - 2 * coarse + 1  # {0,1,2}
    idx = np.arange(len(p))
    fkey = (fres[:, 0] << 4) | (fres[:, 1] << 2) | fres[:, 2]
    order = np.lexsort((idx, fkey, coarse[:, 2], coarse[:, 1], coarse[:, 0]))
    fine_s = fine[order]
    keep = np.ones(len(order), bool)
    keep[1:] = np.any(fine_s[1:] != fine_s[:-1], axis=1)
    sel = order[keep]
    coarse_s = coarse[sel]
    head = np.ones(len(sel), bool)
    head[1:] = np.any(coarse_s[1:] != coarse_s[:-1], axis=1)
    return p[sel], head


def first_point_per_voxel_set(points, voxel_size, f32: bool):
    """ops/voxel_map.first_point_per_voxel semantics: winner per voxel =
    lowest input index (input order = the fused downsample order)."""
    vox = vox_indices(points, voxel_size, f32)
    seen = set()
    out = []
    for v, p in zip(map(tuple, vox), points):
        if v not in seen:
            seen.add(v)
            out.append(p)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Registration
# ---------------------------------------------------------------------------


def align_clouds(src, tgt, kernel_th, guards: bool):
    """One robust GN step (reference registration.cpp:43-92).

    src/tgt (M, 3) f64 correspondences. Returns the (4, 4) SE(3) increment.
    """
    if len(src) == 0:
        return np.eye(4)
    r = src - tgt
    res_sq = np.sum(r * r, axis=1)
    w = kernel_th**2 / (kernel_th + res_sq) ** 2

    sw = float(np.sum(w))
    ws = w[:, None] * src
    A = sw * np.eye(3)
    B = -_hat(np.sum(ws, axis=0))
    ss = np.einsum("n,ni,nj->ij", w, src, src)
    D = np.trace(ss) * np.eye(3) - ss
    JtWJ = np.block([[A, B], [B.T, D]])
    JtWr = np.concatenate([np.sum(w[:, None] * r, axis=0), np.sum(np.cross(ws, r), axis=0)])

    if guards:
        ridge = 1e-9 * (1.0 + np.max(np.abs(np.diagonal(JtWJ))))
        x = np.linalg.solve(JtWJ + ridge * np.eye(6), -JtWr)
        if sw <= 0 or not np.all(np.isfinite(x)):
            x = np.zeros(6)
    else:
        # the reference's LDLT on the raw (possibly singular) system
        x, *_ = np.linalg.lstsq(JtWJ, -JtWr, rcond=None)
    return se3_exp(x)


class ReferenceOdometry:
    """The wired per-scan pipeline (reference icp.cpp:58-86), toggleable
    between raw-reference and JAX-pipeline behavior. Feed sensor-frame valid
    points per scan; poses accumulate internally."""

    def __init__(self, cfg: OracleConfig):
        self.cfg = cfg
        self.map = VoxelMap(cfg)
        self.poses: list[np.ndarray] = []
        # adaptive threshold state (reference threshold.hpp:9-33)
        self.model_error_sq = 0.0
        self.num_samples = 0
        self.model_deviation = np.eye(4)

    # --- KISS-ICP helpers --------------------------------------------------

    def _has_moved(self):
        if not self.poses:
            return False
        motion = np.linalg.norm((inv(self.poses[0]) @ self.poses[-1])[:3, 3])
        return motion > 5.0 * self.cfg.min_motion_th

    def _adaptive_threshold(self):
        """reference icp.cpp:138-144 + threshold.cpp:16-29 (mutating)."""
        if not self._has_moved():
            return self.cfg.initial_threshold
        theta = np.linalg.norm(so3_log(self.model_deviation[:3, :3]))
        err = 2.0 * self.cfg.max_range * np.sin(theta / 2.0) + np.linalg.norm(
            self.model_deviation[:3, 3]
        )
        if err > self.cfg.min_motion_th:
            self.model_error_sq += err * err
            self.num_samples += 1
        if self.num_samples < 1:
            return self.cfg.initial_threshold
        return np.sqrt(self.model_error_sq / self.num_samples)

    def _prediction(self):
        if len(self.poses) < 2:
            return np.eye(4)
        return inv(self.poses[-2]) @ self.poses[-1]

    # --- ICP loop ------------------------------------------------------------

    def _icp(self, source_world64, init_guess, sigma):
        """source_world64: (S, 3) f64 points already at the guess pose (the
        JAX pipeline's world-frame convention: T_final = T_icp @ guess).
        Fresh correspondences every iteration (reference
        registration.cpp:108-126)."""
        cfg = self.cfg
        max_d2 = (3.0 * sigma) ** 2
        kernel = sigma / 3.0
        if len(self.map) == 0:
            return init_guess

        # mirrors ops/icp.py's hardcoded outer-fetch schedule
        refetch_d2 = (0.5 * cfg.voxel_size) ** 2
        max_refetch = 6

        def one_step(T_icp, world, tgt_all, d2_all, found):
            corr = (d2_all < max_d2) if not cfg.true_nn else (
                found & (d2_all < max_d2)
            )
            src, tgt = world[corr], tgt_all[corr]
            estimate = align_clouds(src, tgt, kernel, cfg.gn_guards)
            xi = se3_log(estimate)
            step = np.linalg.norm(xi)
            if cfg.gn_guards:
                ok = len(src) >= cfg.min_correspondences
                if not ok:
                    estimate = np.eye(4)
                elif step > cfg.max_step_norm:
                    estimate = se3_exp(xi * (cfg.max_step_norm / step))
                converged = (not ok) or (
                    min(step, cfg.max_step_norm) < cfg.estimation_threshold
                )
            else:
                converged = step < cfg.estimation_threshold
            return estimate @ T_icp, converged

        T_icp = np.eye(4)
        if cfg.cached_candidates:
            j, converged = 0, False
            for _ in range(max_refetch):
                if converged or j >= cfg.max_iterations:
                    break
                world = source_world64 @ T_icp[:3, :3].T + T_icp[:3, 3]
                cand = self.map.fetch_candidates(
                    world.astype(np.float32).astype(np.float64)
                    if cfg.f32_points
                    else world
                )
                anchor_t = T_icp[:3, 3].copy()
                stale = False
                while j < cfg.max_iterations and not converged and not stale:
                    world = source_world64 @ T_icp[:3, :3].T + T_icp[:3, 3]
                    tgt_all, d2_all, found = self.map.nn_from_candidates(
                        cand, world
                    )
                    T_icp, converged = one_step(
                        T_icp, world, tgt_all, d2_all, found
                    )
                    j += 1
                    drift = np.sum((T_icp[:3, 3] - anchor_t) ** 2)
                    stale = (not converged) and (drift > refetch_d2)
            return T_icp @ init_guess

        for _ in range(cfg.max_iterations):
            world = source_world64 @ T_icp[:3, :3].T + T_icp[:3, 3]
            q = (
                world.astype(np.float32).astype(np.float64)
                if cfg.f32_points
                else world
            )
            tgt_all, d2_all, found = self.map.nn_batch(q)
            # the raw reference gates the Zero() sentinel too
            # (voxel_hash_map.cpp:117-121); in true_nn mode not-found means
            # no candidate at all
            T_icp, converged = one_step(T_icp, world, tgt_all, d2_all, found)
            if converged:
                break
        return T_icp @ init_guess

    # --- per-scan step -------------------------------------------------------

    def register_frame(self, points):
        """points: (N, 3) f64 sensor-frame valid points. Returns the pose."""
        cfg = self.cfg
        last = self.poses[-1] if self.poses else np.eye(4)
        init_guess = last @ self._prediction()

        if cfg.world_frame_downsample:
            # JAX pipeline: transform to world @ guess in f32, THEN
            # downsample (kiss_icp.register_frame step 3) with the fused
            # grouped order; IQR ranges measured from the sensor origin
            Rg = init_guess[:3, :3].astype(np.float32)
            tg = init_guess[:3, 3].astype(np.float32)
            world32 = rigid_f32(Rg, tg, points)
            down, head = fused_downsample_order(world32, cfg.voxel_size)
            source = first_point_per_voxel_set(down, 1.5 * cfg.voxel_size, True)
            d_sq = np.sum((source - tg) ** 2, axis=1, dtype=np.float32)
            lo, hi = iqr_bounds(d_sq.astype(np.float64))
            source = source[(d_sq >= lo) & (d_sq <= hi)]
            sigma = self._adaptive_threshold()
            new_pose = self._icp(source.astype(np.float64), init_guess, sigma)
            if cfg.gn_guards:
                model_dev = inv(init_guess) @ new_pose
                if np.linalg.norm(model_dev[:3, 3]) > cfg.max_model_deviation:
                    new_pose, model_dev = init_guess, np.eye(4)
                new_pose = orthonormalize(new_pose)
            else:
                model_dev = inv(init_guess) @ new_pose
            self.model_deviation = model_dev
            # map insert: correct the world-frame downsample by the ICP delta
            # only, in f32 (kiss_icp.register_frame step 8)
            delta = new_pose @ inv(init_guess)
            ins = rigid_f32(delta[:3, :3], delta[:3, 3], down)
            self.map.insert_grouped(ins, head, key_points=down)
            self.map.evict_far(new_pose[:3, 3])
            self.poses.append(new_pose)
            return new_pose
        else:
            # raw reference: sensor-frame f64 downsample (icp.cpp:126-135)
            down = voxel_downsample(points, 0.5 * cfg.voxel_size, False)
            source = voxel_downsample(down, 1.5 * cfg.voxel_size, False)
            d_sq = np.sum(source * source, axis=1)
            lo, hi = iqr_bounds(d_sq)
            source = source[(d_sq >= lo) & (d_sq <= hi)]
            sigma = self._adaptive_threshold()
            src_world = source @ init_guess[:3, :3].T + init_guess[:3, 3]
            new_pose = self._icp(src_world, init_guess, sigma)
            self.model_deviation = inv(init_guess) @ new_pose
            ins = down @ new_pose[:3, :3].T + new_pose[:3, 3]

        self.map.insert(ins)
        self.map.evict_far(new_pose[:3, 3])
        self.poses.append(new_pose)
        return new_pose
