"""Masked order statistics (counterpart of the JAX package's `ops/stats.py`,
reference include/common.hpp:18-64).

IQR by the reference's "median of halves" on padded arrays with validity
masks: invalid entries sort to +inf and indices come from the valid count.
Everything stays on the device (no host sync). Statistics run along the
last axis, so leading stream dims (S, N) are independent rows.
"""

from __future__ import annotations

import torch

IQR_TUKEY = 1.25  # reference common.hpp:15 (IQR_TUCHEY)


def _take_clip(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[..., clip(i)] per row: a (..., N), i (...)."""
    return torch.gather(a, -1, torch.clamp(i, 0, a.shape[-1] - 1)[..., None])[..., 0]


def _median_of_sorted_range(a, start, size):
    """Median of a[..., start : start+size] for sorted rows of `a`; size >= 1."""
    half = size // 2
    mid = _take_clip(a, start + half)
    lo = _take_clip(a, start + torch.clamp(half - 1, min=0))
    return torch.where(size % 2 == 0, 0.5 * (lo + mid), mid)


def masked_iqr(values: torch.Tensor, mask: torch.Tensor):
    """(q1, q3, iqr) of `values[mask]` with reference median-of-halves
    semantics; a single valid entry gives (0, v, v) (common.hpp:50-52)."""
    a = torch.sort(torch.where(mask, values, torch.full_like(values, float("inf"))),
                   dim=-1).values
    n = torch.sum(mask, dim=-1).to(torch.int64)
    half = n // 2
    q1 = _median_of_sorted_range(a, torch.zeros_like(n), torch.clamp(half, min=1))
    q3_start = half + n % 2
    q3 = _median_of_sorted_range(a, q3_start, torch.clamp(n - q3_start, min=1))
    single = n <= 1
    v0 = a[..., 0]
    q1 = torch.where(single, torch.zeros_like(v0), q1)
    q3 = torch.where(single, v0, q3)
    return q1, q3, q3 - q1


def iqr_inlier_mask(values: torch.Tensor, mask: torch.Tensor,
                    k: float = IQR_TUKEY) -> torch.Tensor:
    """Tukey-fence inlier mask (reference icp.cpp:88-124): low <= v <= high."""
    q1, q3, iqr = masked_iqr(values, mask)
    low, high = (q1 - k * iqr)[..., None], (q3 + k * iqr)[..., None]
    return mask & (values >= low) & (values <= high)
