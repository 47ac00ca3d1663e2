"""Pose-graph backend in PyTorch (counterpart of the JAX package's
`models/backend.py`): loop closure and map optimization, the capability
the reference promises (reference README.md:2) but does not ship.

  * a pose graph over keyframes as static-shape tensors (max_keyframes
    nodes, max_edges SE(3) constraints with masks), poses and
    measurements in f64;
  * every edge's 6-dim residual r = log(T_meas^-1 (X_i^-1 X_j)) and its two
    6x6 Jacobians in one batched forward-mode pass (dual numbers through
    `ops/lie`: exact, no hand-rolled blocks);
  * Levenberg-Marquardt on the scatter-assembled Gauss-Newton system with
    a Cholesky solve (`optimize`), or matrix-free block-Jacobi PCG
    (`optimize_cg`);
  * proximity loop-closure candidates with ICP verification against
    keyframe clouds.

The counts `num_nodes` / `num_edges` are host ints beside the tensors: an
update past capacity is dropped and still counted, as JAX drops an
out-of-range `.at[k].set`, without a host read. Scatter-adds use
`index_put_(accumulate=True)`, which on CUDA sorts the indices and adds
each target's values in that order (no float atomics). The LM and CG
loops are fixed-count Python loops whose decisions (accept, step sizes,
damping) stay on the device (`torch.where`): no host read inside them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import icp as icp_ops
from ..ops import lie, voxel_map
from ..ops.preprocess import to_device

F64 = torch.float64
I32 = torch.int32


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) f64 current estimates
    node_mask: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor  # (E,) i32
    edge_j: torch.Tensor  # (E,) i32
    edge_meas: torch.Tensor  # (E, 4, 4) f64 measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) f64 scalar information weight
    edge_mask: torch.Tensor  # (E,) bool
    num_nodes: int  # host count (may exceed K: updates past capacity drop)
    num_edges: int


def _eye4(n: int, device) -> torch.Tensor:
    return torch.eye(4, dtype=F64, device=device).expand(n, 4, 4).clone()


def create(max_keyframes: int, max_edges: int,
           device: torch.device | str = "cuda") -> PoseGraph:
    return PoseGraph(
        poses=_eye4(max_keyframes, device),
        node_mask=torch.zeros(max_keyframes, dtype=torch.bool, device=device),
        edge_i=torch.zeros(max_edges, dtype=I32, device=device),
        edge_j=torch.zeros(max_edges, dtype=I32, device=device),
        edge_meas=_eye4(max_edges, device),
        edge_weight=torch.zeros(max_edges, dtype=F64, device=device),
        edge_mask=torch.zeros(max_edges, dtype=torch.bool, device=device),
        num_nodes=0,
        num_edges=0,
    )


def _set(t: torch.Tensor, k: int, value) -> torch.Tensor:
    """A copy of `t` with row k set to `value` (a tensor is copied on the
    device; a Python scalar is filled, never copied from the host)."""
    out = t.clone()
    if isinstance(value, torch.Tensor):
        out[k].copy_(value)
    elif isinstance(value, np.ndarray) and value.ndim:
        out[k].copy_(torch.as_tensor(value, dtype=t.dtype))
    else:
        out[k:k + 1].fill_(np.asarray(value).item())
    return out


def add_node(g: PoseGraph, pose) -> PoseGraph:
    k = g.num_nodes
    if k >= g.poses.shape[0]:  # JAX drops the out-of-range set, still counts
        return g._replace(num_nodes=k + 1)
    return g._replace(
        poses=_set(g.poses, k, pose),
        node_mask=_set(g.node_mask, k, True),
        num_nodes=k + 1,
    )


def add_edge(g: PoseGraph, i, j, meas, weight=1.0) -> PoseGraph:
    e = g.num_edges
    if e >= g.edge_i.shape[0]:
        return g._replace(num_edges=e + 1)
    return g._replace(
        edge_i=_set(g.edge_i, e, i),
        edge_j=_set(g.edge_j, e, j),
        edge_meas=_set(g.edge_meas, e, meas),
        edge_weight=_set(g.edge_weight, e, weight),
        edge_mask=_set(g.edge_mask, e, True),
        num_edges=e + 1,
    )


def add_odometry_chain(g: PoseGraph, poses, weight=1.0) -> PoseGraph:
    """Bulk-load a trajectory: nodes + consecutive relative-pose edges."""
    poses = torch.as_tensor(poses, dtype=F64, device=g.poses.device)
    for idx in range(poses.shape[0]):
        g = add_node(g, poses[idx])
        if idx > 0:
            meas = lie.transform_inverse(poses[idx - 1]) @ poses[idx]
            g = add_edge(g, idx - 1, idx, meas, weight)
    return g


def from_chain(poses_np, max_keyframes: int, max_edges: int, weight: float = 1.0,
               device: torch.device | str = "cuda") -> PoseGraph:
    """A PoseGraph from a host-side (K, 4, 4) pose chain, assembled in numpy
    and uploaded in one copy (`ops/preprocess.to_device`)."""
    poses_np = np.asarray(poses_np, np.float64)
    k = poses_np.shape[0]
    if not 0 < k <= max_keyframes or k - 1 > max_edges:
        raise ValueError(f"{k} poses do not fit {max_keyframes} nodes / {max_edges} edges")

    poses = np.broadcast_to(np.eye(4), (max_keyframes, 4, 4)).copy()
    poses[:k] = poses_np
    node_mask = np.zeros(max_keyframes, bool)
    node_mask[:k] = True
    meas = np.broadcast_to(np.eye(4), (max_edges, 4, 4)).copy()
    if k > 1:
        meas[: k - 1] = np.linalg.inv(poses_np[:-1]) @ poses_np[1:]
    edge_i = np.zeros(max_edges, np.int32)
    edge_j = np.zeros(max_edges, np.int32)
    edge_i[: k - 1] = np.arange(k - 1)
    edge_j[: k - 1] = np.arange(1, k)
    edge_w = np.zeros(max_edges)
    edge_w[: k - 1] = weight
    edge_mask = np.zeros(max_edges, bool)
    edge_mask[: k - 1] = True
    tensors = to_device([poses, node_mask, edge_i, edge_j, meas, edge_w, edge_mask], device)
    return PoseGraph(*tensors, num_nodes=k, num_edges=k - 1)


def _edge_residual(xi_i, xi_j, pose_i, pose_j, meas):
    """r = log(meas^-1 (X_i exp(xi_i))^-1 (X_j exp(xi_j))) — local twists;
    every argument has a leading batch of edges."""
    Xi = pose_i @ lie.se3_exp(xi_i)
    Xj = pose_j @ lie.se3_exp(xi_j)
    return lie.se3_log(lie.transform_inverse(meas) @ lie.transform_inverse(Xi) @ Xj)


def _sqrt_weight(g: PoseGraph) -> torch.Tensor:
    return torch.sqrt(torch.where(g.edge_mask, g.edge_weight, torch.zeros_like(g.edge_weight)))


def _edge_residuals(g: PoseGraph) -> torch.Tensor:
    """Weighted residuals (E, 6) at the current poses."""
    e = g.edge_i.shape[0]
    zero = torch.zeros((e, 6), dtype=F64, device=g.poses.device)
    r = _edge_residual(zero, zero, g.poses[g.edge_i], g.poses[g.edge_j], g.edge_meas)
    return r * _sqrt_weight(g)[:, None]


def _edge_terms(g: PoseGraph):
    """Weighted residuals (E, 6) and Jacobians Ji, Jj (E, 6, 6) at the
    linearization point xi = 0: one forward-mode pass over 12 tangent
    directions a edge (6 for xi_i, then 6 for xi_j)."""
    e = g.edge_i.shape[0]
    dev = g.poses.device
    eye6 = torch.eye(6, dtype=F64, device=dev)
    zero = torch.zeros((12, e, 6), dtype=F64, device=dev)
    tangent_i = torch.zeros_like(zero)
    tangent_i[:6] = eye6[:, None, :]
    tangent_j = torch.zeros_like(zero)
    tangent_j[6:] = eye6[:, None, :]
    with fwAD.dual_level():
        xi_i = fwAD.make_dual(zero, tangent_i)
        xi_j = fwAD.make_dual(zero.clone(), tangent_j)
        out = _edge_residual(xi_i, xi_j, g.poses[g.edge_i], g.poses[g.edge_j], g.edge_meas)
        r, dr = fwAD.unpack_dual(out)
    sw = _sqrt_weight(g)
    J = dr.permute(1, 2, 0) * sw[:, None, None]  # (E, 6 residual rows, 12)
    return r[0] * sw[:, None], J[..., :6], J[..., 6:]


def _assemble(g: PoseGraph, r, Ji, Jj, damping):
    """Scatter-add the GN normal equations H dx = -b over node blocks."""
    k = g.poses.shape[0]
    dim = 6 * k
    dev = g.poses.device
    H = torch.zeros((dim, dim), dtype=F64, device=dev)
    b = torch.zeros((dim,), dtype=F64, device=dev)

    bi = g.edge_i.long() * 6
    bj = g.edge_j.long() * 6

    def blocks(J1, J2):
        return torch.einsum("eai,eaj->eij", J1, J2)

    Hii, Hjj = blocks(Ji, Ji), blocks(Jj, Jj)
    Hij = blocks(Ji, Jj)
    bi_vec = torch.einsum("eai,ea->ei", Ji, r)
    bj_vec = torch.einsum("eai,ea->ei", Jj, r)

    rows = torch.arange(6, device=dev)

    def scatter_block(base_r, base_c, blk):
        idx_r = (base_r[:, None, None] + rows[None, :, None]).expand(blk.shape)
        idx_c = (base_c[:, None, None] + rows[None, None, :]).expand(blk.shape)
        H.index_put_((idx_r, idx_c), blk, accumulate=True)

    scatter_block(bi, bi, Hii)
    scatter_block(bj, bj, Hjj)
    scatter_block(bi, bj, Hij)
    scatter_block(bj, bi, Hij.transpose(1, 2))
    b.index_put_((bi[:, None] + rows[None, :],), bi_vec, accumulate=True)
    b.index_put_((bj[:, None] + rows[None, :],), bj_vec, accumulate=True)

    # gauge fix: strong prior on node 0; inactive nodes pinned too
    active = torch.repeat_interleave(g.node_mask, 6)
    anchor = torch.arange(dim, device=dev) < 6
    prior = (anchor | ~active).to(F64) * 1e12
    H = H + torch.diag(prior + damping + 1e-12)
    return H, b


def _lm_update(g: PoseGraph, r, new_poses, ok, lam):
    """The monotone accept: the step stands where the cost fell (and,
    with `ok`, the solve succeeded); damping halves, else grows x4."""
    c_old = torch.sum(r * r)
    r_new = _edge_residuals(g._replace(poses=new_poses))
    accept = (torch.sum(r_new * r_new) < c_old) & ok
    poses = torch.where(accept, new_poses, g.poses)
    lam = torch.where(accept, lam * 0.5, lam * 4.0)
    return g._replace(poses=poses), lam


def optimize(g: PoseGraph, iterations: int = 10, damping: float = 1e-6) -> PoseGraph:
    """Levenberg-Marquardt over the pose graph: a fixed number of steps,
    each accepted only if the total error fell.

    On a matrix that is not positive definite JAX's Cholesky returns NaN,
    so its step's cost compares False and the step is rejected;
    `cholesky_ex` reports the failure in `info` instead (no raise, no
    host read), and the step is rejected where `info != 0`."""
    lam = torch.full((), damping, dtype=F64, device=g.poses.device)
    for _ in range(iterations):
        r, Ji, Jj = _edge_terms(g)
        H, b = _assemble(g, r, Ji, Jj, lam)
        L, info = torch.linalg.cholesky_ex(H)
        y = torch.linalg.solve_triangular(L, -b[:, None], upper=False)
        dx = torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0].reshape(-1, 6)
        new_poses = g.poses @ lie.se3_exp(dx)
        g, lam = _lm_update(g, r, new_poses, info == 0, lam)
    return g


# ---------------------------------------------------------------------------
# Matrix-free PCG solver (KITTI-length graphs)
# ---------------------------------------------------------------------------
#
# The dense path assembles the full (6K, 6K) Hessian: O(K^2) memory and an
# O(K^3) solve. A pose graph is a chain plus a few loop edges, so this
# path never materializes H: it applies it from the edge list inside a
# block-Jacobi-preconditioned conjugate-gradient loop. Gauge fixing is by
# projection (node 0 and inactive nodes are frozen out of the Krylov
# space), not the dense path's 1e12 prior, which would ruin CG's
# conditioning.


def _scatter_nodes(g: PoseGraph, k: int, vi, vj) -> torch.Tensor:
    """Per-node sums of per-edge values: vi added at edge_i, then vj at
    edge_j; vi, vj (E, ...) -> (k, ...)."""
    y = torch.zeros((k,) + vi.shape[1:], dtype=F64, device=vi.device)
    y.index_put_((g.edge_i.long(),), vi, accumulate=True)
    y.index_put_((g.edge_j.long(),), vj, accumulate=True)
    return y


def _apply_H(g: PoseGraph, Ji, Jj, free, lam, x):
    """y = (J^T J + lam I) x restricted to free nodes; x, y: (K, 6) f64.
    Ji / Jj carry sqrt(edge weight), so masked edges (weight 0) add zeros
    at their index-0 endpoints."""
    x = torch.where(free[:, None], x, 0.0)
    ax = (torch.einsum("eai,ei->ea", Ji, x[g.edge_i.long()])
          + torch.einsum("eai,ei->ea", Jj, x[g.edge_j.long()]))
    y = _scatter_nodes(g, x.shape[0], torch.einsum("eai,ea->ei", Ji, ax),
                       torch.einsum("eai,ea->ei", Jj, ax))
    return torch.where(free[:, None], y + lam * x, 0.0)


def _block_jacobi_inv(g: PoseGraph, Ji, Jj, free, lam):
    """Inverse 6x6 diagonal blocks of (J^T J + lam I): (K, 6, 6) f64, by a
    batched Cholesky (frozen nodes get identity blocks)."""
    k = g.poses.shape[0]
    diag = _scatter_nodes(g, k, torch.einsum("eai,eaj->eij", Ji, Ji),
                          torch.einsum("eai,eaj->eij", Jj, Jj))
    eye6 = torch.eye(6, dtype=F64, device=diag.device)
    diag = diag + (lam + 1e-9) * eye6[None]
    diag = torch.where(free[:, None, None], diag, eye6[None])
    L, _ = torch.linalg.cholesky_ex(diag)
    return torch.cholesky_inverse(L)


def _pcg(g: PoseGraph, Ji, Jj, free, lam, b, n_iters: int):
    """Block-Jacobi PCG for (J^T J + lam I) dx = b on the free nodes."""
    Minv = _block_jacobi_inv(g, Ji, Jj, free, lam)
    b = torch.where(free[:, None], b, 0.0)

    def prec(r):
        return torch.einsum("kij,kj->ki", Minv, r)

    def dot(a, c):
        return torch.sum(a * c)

    x = torch.zeros_like(b)
    r = b  # x0 = 0
    p = prec(r)
    rz = dot(r, p)
    for _ in range(n_iters):
        Hp = _apply_H(g, Ji, Jj, free, lam, p)
        denom = dot(p, Hp)
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-300), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = prec(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-300), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def optimize_cg(g: PoseGraph, iterations: int = 10, cg_iterations: int = 64,
                damping: float = 1e-6) -> PoseGraph:
    """Levenberg-Marquardt with the matrix-free PCG inner solve: the same
    monotone accept as `optimize`, O(E * cg_iterations) a step and O(K)
    memory."""
    k = g.poses.shape[0]
    dev = g.poses.device
    free = g.node_mask & (torch.arange(k, device=dev) != 0)
    lam = torch.full((), damping, dtype=F64, device=dev)
    for _ in range(iterations):
        r, Ji, Jj = _edge_terms(g)
        b = -_scatter_nodes(g, k, torch.einsum("eai,ea->ei", Ji, r),
                            torch.einsum("eai,ea->ei", Jj, r))
        dx = _pcg(g, Ji, Jj, free, lam, b, cg_iterations)
        new_poses = g.poses @ lie.se3_exp(dx)
        g, lam = _lm_update(g, r, new_poses, True, lam)
    return g


def graph_error(g: PoseGraph) -> torch.Tensor:
    r = _edge_residuals(g)
    return torch.sum(r * r)


# ---------------------------------------------------------------------------
# Loop closure
# ---------------------------------------------------------------------------


class LoopCandidates(NamedTuple):
    idx_i: torch.Tensor  # (C,) i32
    idx_j: torch.Tensor  # (C,) i32
    dist: torch.Tensor  # (C,) f64
    mask: torch.Tensor  # (C,) bool


def find_loop_candidates(g: PoseGraph, radius: float, min_index_gap: int,
                         max_candidates: int) -> LoopCandidates:
    """Proximity candidates: node pairs whose positions re-approach after a
    long index gap — the 'revisit' signature. Dense (K, K) masked distance
    matrix, the closest C pairs; a stable sort, so equal distances keep
    their row-major order as JAX's `argsort` does."""
    t = g.poses[:, :3, 3]
    # vector_norm: a correctly rounded square root on the CPU too (the CPU
    # torch.sqrt can round sqrt(2) down, which breaks exact distance ties)
    d = torch.linalg.vector_norm(t[:, None, :] - t[None, :, :], dim=-1)
    k = t.shape[0]
    ii = torch.arange(k, device=t.device)[:, None]
    jj = torch.arange(k, device=t.device)[None, :]
    valid = (g.node_mask[:, None] & g.node_mask[None, :]
             & ((jj - ii) > min_index_gap) & (d < radius))
    score = torch.where(valid, d, torch.inf).reshape(-1)
    order = torch.argsort(score, stable=True)[:max_candidates]
    return LoopCandidates(
        idx_i=torch.div(order, k, rounding_mode="floor").to(I32),
        idx_j=(order % k).to(I32),
        dist=score[order],
        mask=torch.isfinite(score[order]),
    )


def verify_and_add_loops(g: PoseGraph, candidates: LoopCandidates, keyframe_clouds,
                         keyframe_cloud_masks, map_cfg, max_corresp_dist: float = 1.0,
                         max_residual: float = 0.3, weight: float = 1.0) -> PoseGraph:
    """ICP-verify each candidate pair (register cloud_j against a map of
    cloud_i under the relative-pose guess); accept if the residual is small
    and more than 50 points correspond. `keyframe_clouds` (K, N, 3) f32 and
    `keyframe_cloud_masks` (K, N) are tensors on the graph's device. A
    host-driven loop: candidates are few, and each verification is the
    classic ICP (a host read per GN iteration)."""
    dev = g.poses.device
    cand = torch.stack([candidates.idx_i, candidates.idx_j,
                        candidates.mask.to(I32)]).cpu().numpy()
    for c in range(int(cand[2].sum())):
        i, j = int(cand[0, c]), int(cand[1, c])
        m = voxel_map.create(map_cfg, dev)
        m = voxel_map.insert(m, keyframe_clouds[i], keyframe_cloud_masks[i], map_cfg)
        guess = lie.transform_inverse(g.poses[i]) @ g.poses[j]
        res = icp_ops.icp_registration(
            m, keyframe_clouds[j], keyframe_cloud_masks[j], guess,
            max_corresp_dist, max_corresp_dist / 3.0, map_cfg, 30, 1e-5,
        )
        rms, n_corr = torch.stack([res.residual_rms, res.num_correspondences.to(F64)]).tolist()
        if rms < max_residual and n_corr > 50:
            g = add_edge(g, i, j, res.pose, weight)
    return g
