"""SO(3)/SE(3) math in PyTorch (counterpart of the JAX package's `ops/lie.py`).

Conventions as in the JAX package:
* SE(3) tangent vectors are [v(3), w(3)] — translation first (Sophus,
  reference src/utils/calculation_helpers.cpp:116-119).
* Poses are (..., 4, 4) homogeneous matrices, f64 on the ported path.

Only what the ported paths (and their tests) call is ported. Every
function takes leading batch dims, so a leading stream axis (S, ...) of
the batched path goes through the same code. The JAX package's while-loop-free f64 helpers (`se3_exp_poly`,
`_sincos_poly`, `matmul_nowhile`, `chol_solve_unrolled`) exist to lower f64
on a TPU and have no counterpart: the GPU computes f64 natively, so
`compose` is a plain matmul here and the EKF uses torch.sin / cos / exp
and torch.linalg.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix from a (..., 3) vector."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise cross product of (..., 3) tensors (broadcasting)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _safe_theta(w: torch.Tensor):
    sq = torch.sum(w * w, dim=-1)
    small = sq < _EPS
    safe = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    return sq, small, safe


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3) rotation matrix."""
    sq, small, safe = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    one = torch.ones_like(sq)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(safe) / safe)
    b = torch.where(
        small, 0.5 - sq / 24.0, (1.0 - torch.cos(safe)) / torch.where(small, one, sq)
    )
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V(w) such that se3_exp([v, w]) has translation V(w) @ v."""
    sq, small, theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    b = torch.where(small, 0.5 - sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    c = torch.where(
        small, 1.0 / 6.0 - sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta)
    )
    return _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    sq, small, theta = _safe_theta(w)
    W = hat(w)
    W2 = W @ W
    one = torch.ones_like(sq)
    half = torch.where(small, one, theta / 2.0)
    cot = torch.where(small, one, half / torch.tan(half))
    coeff = torch.where(
        small, 1.0 / 12.0 + sq / 720.0, (1.0 - cot) / torch.where(small, one, sq)
    )
    return _eye3_like(W) - 0.5 * W + coeff[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [v, w] -> (..., 4, 4) transform (Sophus convention)."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return make_transform(R, t)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (w, x, y, z) unit quaternion (Shepperd pivot)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    qw = torch.stack([tw, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, tx, m10 + m01, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m10 + m01, ty, m21 + m12], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m21 + m12, tz], dim=-1)

    def finish(qc, t):
        s = torch.sqrt(torch.clamp(t, min=_EPS))
        denom = torch.where(s < _EPS, torch.ones_like(s), 2.0 * s)
        return qc / denom[..., None]

    cands = torch.stack(
        [finish(qw, tw), finish(qx, tx), finish(qy, ty), finish(qz, tz)], dim=-2
    )
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.where(n < _EPS, torch.ones_like(n), n)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation vector (..., 3)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    vec = q[..., 1:]
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    n_sq = torch.sum(vec * vec, dim=-1)
    small = n_sq < _EPS
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(
        small, 2.0 / torch.where(w < _EPS, torch.ones_like(w), w), angle / n
    )
    return vec * scale[..., None]


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) rotation vector (pi-robust)."""
    return quat_log(rot_to_quat(R))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = (_so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    # a fill kernel: assigning a Python scalar to the 0-d view T[3, 3] of
    # a single pose copies it from the host, which waits for the device
    T[..., 3:, 3:].fill_(1.0)
    return T


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit-norm-assumed quaternion (w, x, y, z) -> (..., 3, 3) rotation
    (Eigen's toRotationMatrix formula, which does not normalize)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    one = torch.ones_like(w)
    return torch.stack(
        [
            torch.stack([one - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), one - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), one - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block of (..., 4, 4) poses back onto SO(3) by a
    quaternion round-trip (the classic path's renormalization, once per
    registered scan; the fast path's pose_post kernel uses a Newton step)."""
    return make_transform(quat_to_rot(rot_to_quat(T[..., :3, :3])), T[..., :3, 3])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) pose composition (native f64 matmul)."""
    return A @ B


def eye4(device, lead: tuple = ()) -> torch.Tensor:
    """The f64 identity pose expanded to (*lead, 4, 4) (a view: clone it
    before writing)."""
    return torch.eye(4, dtype=torch.float64, device=device).expand(lead + (4, 4))


def where_pose(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-stream select of (..., 4, 4) poses by a (...) condition."""
    return torch.where(cond[..., None, None], a, b)


def transform_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def rotate_points(R: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation applied to (..., 3) points, ELEMENTWISE in the
    points' dtype (9 multiply-adds per point; never a reduced-precision
    matmul on point geometry). For a cloud (S, N, 3) under per-stream
    rotations pass R[:, None] (S, 1, 3, 3)."""
    R = R.to(pts.dtype)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack(
        [
            R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z,
            R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z,
            R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z,
        ],
        dim=-1,
    )


def delta_pose(T_first: torch.Tensor, T_last: torch.Tensor) -> torch.Tensor:
    """log(T_first^-1 @ T_last) (reference calculation_helpers.cpp:99-102)."""
    return se3_log(transform_inverse(T_first) @ T_last)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z), for the EKF
# ---------------------------------------------------------------------------


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.where(n < _EPS, torch.ones_like(n), n)


def dquat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Analytic Jacobian of `quat_to_rot`: (..., 4, 3, 3), dR/dq_i stacked
    over i (the JAX package's documented replacement of the reference's
    perturbation hack, helper.hpp:19-33)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    zero = torch.zeros_like(w)

    def m(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    dw = m([[zero, -2 * z, 2 * y], [2 * z, zero, -2 * x], [-2 * y, 2 * x, zero]])
    dx = m([[zero, 2 * y, 2 * z], [2 * y, -4 * x, -2 * w], [2 * z, 2 * w, -4 * x]])
    dy = m([[-4 * y, 2 * x, 2 * w], [2 * x, zero, 2 * z], [-2 * w, 2 * z, -4 * y]])
    dz = m([[-4 * z, -2 * w, 2 * x], [2 * w, -4 * z, 2 * y], [2 * x, 2 * y, zero]])
    return torch.stack([dw, dx, dy, dz], dim=-3)


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating a onto b (Eigen FromTwoVectors; reference
    ekf.cpp:197), with an arbitrary orthogonal axis for antiparallel inputs.
    a and b broadcast against each other."""
    a, b = torch.broadcast_tensors(a, b)
    a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=_EPS)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=_EPS)
    c = torch.sum(a * b, dim=-1)
    axis = cross(a, b)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)  # built on the device
    ortho = cross(a, torch.where(torch.abs(a[..., 0:1]) < 0.9, eye[0], eye[1]))
    anti = c < -1.0 + 1e-9
    w = torch.sqrt(torch.clamp(0.5 * (1.0 + c), min=0.0))
    n = torch.linalg.norm(axis, dim=-1)
    one = torch.ones_like(n)
    s = torch.where(n < _EPS, one,
                    torch.sqrt(torch.clamp(0.5 * (1.0 - c), min=0.0)) / torch.where(n < _EPS, one, n))
    q = torch.cat([w[..., None], axis * s[..., None]], dim=-1)
    q_anti = torch.cat([torch.zeros_like(w[..., None]),
                        ortho / torch.clamp(torch.linalg.norm(ortho, dim=-1, keepdim=True),
                                            min=_EPS)], dim=-1)
    return quat_normalize(torch.where(anti[..., None], q_anti, q))


def quat_xi_matrix(w: torch.Tensor) -> torch.Tensor:
    """The 4x4 'S' structure of the reference EKF (ekf.cpp:471-484), with
    S(w)^2 = -|w|^2 I."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(w0)
    return torch.stack(
        [
            torch.stack([z, -w0, -w1, -w2], dim=-1),
            torch.stack([w0, z, -w2, w1], dim=-1),
            torch.stack([w1, w2, z, -w0], dim=-1),
            torch.stack([w2, -w1, w0, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(theta)/theta with the Taylor guard near 0."""
    small = theta * theta < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def quat_propagator(w: torch.Tensor, dt) -> torch.Tensor:
    """Closed-form A = exp(S(w) * (-dt/2)) (replaces Eigen's expm, reference
    ekf.cpp:266-267): cos(c|w|) I + sin(c|w|)/|w| S with c = -dt/2. `w`
    (..., 3), `dt` a float or a tensor broadcasting against w[..., 0]."""
    c = -0.5 * torch.as_tensor(dt, dtype=w.dtype, device=w.device)
    sq, small, norm_w = _safe_theta(w)
    safe_norm = torch.where(small, torch.zeros_like(norm_w), norm_w)
    a = torch.cos(safe_norm * torch.abs(c))
    b = _sinc(safe_norm * c) * c
    eye = torch.eye(4, dtype=w.dtype, device=w.device)
    return a[..., None, None] * eye + b[..., None, None] * quat_xi_matrix(w)
