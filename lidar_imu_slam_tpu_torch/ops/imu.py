"""IMU preprocessing and static initialization (counterpart of the JAX
package's `ops/imu.py`; reference src/sensors/imu/frame.cpp).

  * NED/ENU axis remap of raw acceleration (imu/frame.cpp:21-30)
  * static initialization over `max_init_count` samples: running mean and
    variance of acc and gyro (imu/frame.cpp:72-118), gravity estimate

The JAX `lax.scan` over a packet's samples is a Python loop over the
packet's <= M samples with the same recursion and the same masking, so the
running statistics agree to rounding. The loop runs only while the
initialization is open: `models/lio.step` skips it once `done` is set,
where the JAX recursion is a no-op. The state and the packet may carry a
leading stream axis (`init_state(device, streams=S)`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GRAVITY, ImuConfig

F64 = torch.float64


def remap_axes(acc: torch.Tensor, coordinate: str) -> torch.Tensor:
    """NED keeps (x, y, z); ENU remaps to (y, x, -z) (imu/frame.cpp:21-30)."""
    if coordinate == "enu":
        return torch.stack([acc[..., 1], acc[..., 0], -acc[..., 2]], dim=-1)
    return acc


class ImuInitState(NamedTuple):
    count: torch.Tensor  # () i32 — samples consumed (init_iter_num)
    mean_acc: torch.Tensor  # (3,) f64
    mean_gyro: torch.Tensor  # (3,) f64
    cov_acc: torch.Tensor  # (3,) f64 diagonal
    cov_gyro: torch.Tensor  # (3,) f64 diagonal
    done: torch.Tensor  # () bool


def init_state(device: torch.device | str = "cuda", streams: int | None = None) -> ImuInitState:
    """A fresh state; with `streams`, S fresh states on a leading axis."""
    lead = () if streams is None else (streams,)
    return ImuInitState(
        count=torch.zeros(lead, dtype=torch.int32, device=device),
        mean_acc=torch.zeros(lead + (3,), dtype=F64, device=device),
        mean_gyro=torch.zeros(lead + (3,), dtype=F64, device=device),
        cov_acc=torch.zeros(lead + (3,), dtype=F64, device=device),
        cov_gyro=torch.zeros(lead + (3,), dtype=F64, device=device),
        done=torch.zeros(lead, dtype=torch.bool, device=device),
    )


def accumulate(state: ImuInitState, gyro, acc, mask, cfg: ImuConfig) -> ImuInitState:
    """Consume a padded packet of samples (gyro / acc (..., M, 3) f64, mask
    (..., M)) with the reference's running mean / variance recursion
    (imu/frame.cpp:94-111):

      mean += (x - mean) / N
      cov   = cov (N-1)/N + (x - mean)^2 (N-1)/N^2
    """
    count, mean_acc, mean_gyro = state.count, state.mean_acc, state.mean_gyro
    cov_acc, cov_gyro = state.cov_acc, state.cov_gyro
    for i in range(mask.shape[-1]):
        take = mask[..., i] & ~state.done
        tv = take[..., None]
        n = count + 1
        nf = n.to(F64)[..., None]
        a, g = acc[..., i, :], gyro[..., i, :]
        ma = mean_acc + (a - mean_acc) / nf
        mg = mean_gyro + (g - mean_gyro) / nf
        ca = cov_acc * (nf - 1.0) / nf + (a - ma) ** 2 * (nf - 1.0) / nf**2
        cg = cov_gyro * (nf - 1.0) / nf + (g - mg) ** 2 * (nf - 1.0) / nf**2
        count = torch.where(take, n, count)
        mean_acc = torch.where(tv, ma, mean_acc)
        mean_gyro = torch.where(tv, mg, mean_gyro)
        cov_acc = torch.where(tv, ca, cov_acc)
        cov_gyro = torch.where(tv, cg, cov_gyro)
    done = count >= cfg.max_init_count
    # on completion the acc covariance is rescaled to unit gravity
    # (imu/frame.cpp:131)
    scale = (GRAVITY / torch.linalg.norm(mean_acc, dim=-1, keepdim=True)) ** 2
    cov_acc = torch.where((done & ~state.done)[..., None], cov_acc * scale, cov_acc)
    return ImuInitState(count, mean_acc, mean_gyro, cov_acc, cov_gyro, done)


def gravity_estimate(state: ImuInitState) -> torch.Tensor:
    """calc_grav = -mean_acc / |mean_acc| * g (imu/frame.cpp:114)."""
    return -state.mean_acc / torch.linalg.norm(state.mean_acc, dim=-1, keepdim=True) * GRAVITY
