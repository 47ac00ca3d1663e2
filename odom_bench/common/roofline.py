"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit) and the least-time arithmetic of `chip_smoke.py:_bound_ms` /
`_nbytes`, copied so the yardstick stays with the benchmark."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: every byte once at the memory
    rate, or the f32 operations at the non-tensor-core peak, the longer
    of the two, and which one it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def gn_launch_bound_s(streams: int, queries: int, candidates: int, inner: int) -> tuple[float, str]:
    """One batched GN launch (K5) at the cell's shapes: it reads the
    queries (3 f32), their mask (f32), the candidate planes (3 f32 a
    candidate a query) and 8 f64 scalars a stream, and writes a 16-f64 row
    a stream; every iteration of the fixed schedule costs a query 8 f32
    operations a candidate (its squared distance and the running minimum)
    and 40 for its transform, residual and weight. The count follows the
    schedule and the shapes, not what the kernel reports."""
    s, n, nc = streams, queries, candidates
    n_bytes = s * (3 * n * 4 + n * 4 + 3 * nc * n * 4 + 8 * 8 + 16 * 8)
    n_ops = float(inner) * s * n * (8.0 * nc + 40.0)
    return bound_s(n_bytes, n_ops)
