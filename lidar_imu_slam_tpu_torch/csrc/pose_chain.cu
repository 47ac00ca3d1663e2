// Per-scan pose bookkeeping of the lidar-only fast path: kernels K2
// (pose_pre) and K3 (pose_post).
//
// Replaces: the JAX package's ops/pallas/pose_chain.py:pose_pre (body
// _pre_kernel) and pose_chain.py:pose_post (body _post_kernel).
//
// What bounds it on the card: nothing but latency. Each kernel is a chain
// of ~100-300 dependent f64 scalar operations on a few hundred bytes of
// pose state; one thread does all of it (<<<1, 1>>>). The point of the
// kernels is not arithmetic speed but keeping the per-scan pose math on
// the device: ~70 tiny tensor operations become one launch each before and
// after ICP, and the host never reads a pose to decide anything.
//
// Design: f64 throughout. The TPU kernels carried f32 rotations and
// float-float translations because the TPU has no f64; the H100 has native
// f64, so the state tensors are read directly (no hi/lo split) and one f64
// row is written. Row layouts keep the TPU kernels' slot order minus the
// "lo" slots:
//
//   pose_pre row (32 doubles):
//     [0:9] guess R  [9:12] guess t  [12] sigma  [13] moved  [14] thr_sse'
//     [15] thr_n'  [16] |w|  [17:20] k  [20:23] v  [23:26] w x v
//     [26:29] w x (w x v)  [29:32] unused (0)
//   pose_post row (48 doubles):
//     [0:9] new pose R (orthonormalized)  [9:12] new pose t  [12] diverged
//     [13:22] delta R  [22:25] delta t  [25:41] model_deviation' (4x4
//     row-major)  [41:48] unused (0)
//
// Built without fast math: exact sqrt, atan2, sin, cos.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ void load_rot(const double* T, double R[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = T[4 * i + j];
}

__device__ void matmul3(const double A[3][3], const double B[3][3],
                        double C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

// C = A^T B
__device__ void matmul3_tn(const double A[3][3], const double B[3][3],
                           double C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[0][i] * B[0][j] + A[1][i] * B[1][j] + A[2][i] * B[2][j];
}

// C = A B^T
__device__ void matmul3_nt(const double A[3][3], const double B[3][3],
                           double C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[j][0] + A[i][1] * B[j][1] + A[i][2] * B[j][2];
}

__device__ void matvec3(const double A[3][3], const double v[3], double o[3]) {
  for (int i = 0; i < 3; ++i)
    o[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

// o = A^T v
__device__ void matvec3_t(const double A[3][3], const double v[3], double o[3]) {
  for (int i = 0; i < 3; ++i)
    o[i] = A[0][i] * v[0] + A[1][i] * v[1] + A[2][i] * v[2];
}

__device__ void cross3(const double a[3], const double b[3], double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ double clamp1(double x) { return fmin(fmax(x, -1.0), 1.0); }

__global__ void pose_pre_kernel(const double* __restrict__ pose,
                                const double* __restrict__ pose_prev,
                                const double* __restrict__ first_pose,
                                const double* __restrict__ thr_sse,
                                const double* __restrict__ model_dev,
                                const int* __restrict__ num_poses,
                                const int* __restrict__ thr_n,
                                double min_motion_th, double initial_threshold,
                                double max_range, int deskew_on,
                                double* __restrict__ out) {
  const int np = *num_poses;
  double Rc[3][3], Rp[3][3], Rf[3][3];
  load_rot(pose, Rc);
  load_rot(pose_prev, Rp);
  load_rot(first_pose, Rf);
  const double tc[3] = {pose[3], pose[7], pose[11]};
  const double tp[3] = {pose_prev[3], pose_prev[7], pose_prev[11]};
  const double tf[3] = {first_pose[3], first_pose[7], first_pose[11]};

  // relative pose rel = pose_prev^-1 pose
  double R_rel[3][3], t_rel[3];
  matmul3_tn(Rp, Rc, R_rel);
  const double d[3] = {tc[0] - tp[0], tc[1] - tp[1], tc[2] - tp[2]};
  matvec3_t(Rp, d, t_rel);

  // constant-velocity prediction and guess (reference icp.cpp:146-154)
  const bool has2 = np >= 2, has1 = np >= 1;
  double R_pred[3][3], t_pred[3], R_last[3][3], t_last[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const double eye = i == j ? 1.0 : 0.0;
      R_pred[i][j] = has2 ? R_rel[i][j] : eye;
      R_last[i][j] = has1 ? Rc[i][j] : eye;
    }
    t_pred[i] = has2 ? t_rel[i] : 0.0;
    t_last[i] = has1 ? tc[i] : 0.0;
  }
  double R_g[3][3], rt[3];
  matmul3(R_last, R_pred, R_g);
  matvec3(R_last, t_pred, rt);

  // has_moved (reference icp.cpp:156-163)
  const double df[3] = {tc[0] - tf[0], tc[1] - tf[1], tc[2] - tf[2]};
  double mrel[3];
  matvec3_t(Rf, df, mrel);
  const double m2 = mrel[0] * mrel[0] + mrel[1] * mrel[1] + mrel[2] * mrel[2];
  const double mth = 5.0 * min_motion_th;
  const bool moved = has1 && (m2 > mth * mth);

  // adaptive threshold (reference threshold.cpp:5-29)
  const double c_md =
      clamp1(0.5 * (model_dev[0] + model_dev[5] + model_dev[10] - 1.0));
  const double sin_half = sqrt(fmax(0.5 * (1.0 - c_md), 0.0));
  const double t_md2 = model_dev[3] * model_dev[3] +
                       model_dev[7] * model_dev[7] +
                       model_dev[11] * model_dev[11];
  const double err = 2.0 * max_range * sin_half + sqrt(t_md2);
  const bool acc = moved && (err > min_motion_th);
  const double sse = *thr_sse + (acc ? err * err : 0.0);
  const int n_new = *thr_n + (acc ? 1 : 0);
  const double sigma = (moved && n_new >= 1)
                           ? sqrt(sse / (double)(n_new > 1 ? n_new : 1))
                           : initial_threshold;

  // deskew twist xi = log(rel) as the pieces deskew_from_scalars consumes;
  // all zero when gated (num_poses <= 2 or deskew off)
  double wn_o = 0.0, kx[3] = {0, 0, 0}, v[3] = {0, 0, 0};
  double wxv[3] = {0, 0, 0}, wwxv[3] = {0, 0, 0};
  if (deskew_on) {
    const double s_vec[3] = {0.5 * (R_rel[2][1] - R_rel[1][2]),
                             0.5 * (R_rel[0][2] - R_rel[2][0]),
                             0.5 * (R_rel[1][0] - R_rel[0][1])};
    const double c = clamp1(0.5 * (R_rel[0][0] + R_rel[1][1] + R_rel[2][2] - 1.0));
    const double sn = sqrt(fmax(
        s_vec[0] * s_vec[0] + s_vec[1] * s_vec[1] + s_vec[2] * s_vec[2], 0.0));
    const double th = atan2(sn, c);
    const bool small = sn < 1e-6;
    const double scale = small ? 1.0 + sn * sn / 6.0 : th / sn;
    const double w[3] = {s_vec[0] * scale, s_vec[1] * scale, s_vec[2] * scale};
    const double th2 = th * th, half = 0.5 * th;
    const double coeff =
        small ? 1.0 / 12.0 + th2 / 720.0 : (1.0 - half * cos(half) / sin(half)) / th2;
    double wt[3], wwt[3];
    cross3(w, t_rel, wt);
    cross3(w, wt, wwt);
    const double g = (np > 2 && sn > 0.0) ? 1.0 : 0.0;
    double wg[3];
    for (int i = 0; i < 3; ++i) {
      v[i] = (t_rel[i] - 0.5 * wt[i] + coeff * wwt[i]) * g;
      kx[i] = (small ? 0.0 : s_vec[i] / sn) * g;
      wg[i] = w[i] * g;
    }
    wn_o = th * g;
    cross3(wg, v, wxv);
    cross3(wg, wxv, wwxv);
  }

  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[3 * i + j] = R_g[i][j];
  for (int i = 0; i < 3; ++i) out[9 + i] = t_last[i] + rt[i];
  out[12] = sigma;
  out[13] = moved ? 1.0 : 0.0;
  out[14] = sse;
  out[15] = (double)n_new;
  out[16] = wn_o;
  for (int i = 0; i < 3; ++i) {
    out[17 + i] = kx[i];
    out[20 + i] = v[i];
    out[23 + i] = wxv[i];
    out[26 + i] = wwxv[i];
    out[29 + i] = 0.0;
  }
}

__global__ void pose_post_kernel(const double* __restrict__ corr,
                                 const double* __restrict__ guess,
                                 double max_model_deviation,
                                 double* __restrict__ out) {
  // corr: [R 9 | t 3] (the ICP result); guess: [R 9 | t 3 | ...]
  // (the pose_pre row)
  double Rc[3][3], Rg[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Rc[i][j] = corr[3 * i + j];
      Rg[i][j] = guess[3 * i + j];
    }
  const double tc[3] = {corr[9], corr[10], corr[11]};
  const double tg[3] = {guess[9], guess[10], guess[11]};

  // pose_icp = correction @ guess
  double R_icp[3][3], t_icp[3];
  matmul3(Rc, Rg, R_icp);
  matvec3(Rc, tg, t_icp);
  for (int i = 0; i < 3; ++i) t_icp[i] += tc[i];

  // model deviation = guess^-1 @ pose_icp (reference icp.cpp:78-79)
  double R_dev[3][3], t_dev[3];
  matmul3_tn(Rg, R_icp, R_dev);
  const double dt[3] = {t_icp[0] - tg[0], t_icp[1] - tg[1], t_icp[2] - tg[2]};
  matvec3_t(Rg, dt, t_dev);

  // divergence gate: fall back to the motion prediction
  const double dev2 = t_dev[0] * t_dev[0] + t_dev[1] * t_dev[1] + t_dev[2] * t_dev[2];
  const bool div = dev2 > max_model_deviation * max_model_deviation;
  double R_s[3][3], t_s[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R_s[i][j] = div ? Rg[i][j] : R_icp[i][j];
    t_s[i] = div ? tg[i] : t_icp[i];
  }

  // one Newton orthonormalization step R (1.5 I - 0.5 R^T R)
  double E[3][3], C[3][3], R_o[3][3];
  matmul3_tn(R_s, R_s, E);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] = (i == j ? 1.5 : 0.0) - 0.5 * E[i][j];
  matmul3(R_s, C, R_o);

  // map-correction delta = new_pose @ guess^-1 (reference icp.cpp:81)
  double R_d[3][3], rdg[3];
  matmul3_nt(R_o, Rg, R_d);
  matvec3(R_d, tg, rdg);

  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = R_o[i][j];
      out[13 + 3 * i + j] = R_d[i][j];
      out[25 + 4 * i + j] = div ? (i == j ? 1.0 : 0.0) : R_dev[i][j];
    }
  for (int i = 0; i < 3; ++i) {
    out[9 + i] = t_s[i];
    out[22 + i] = t_s[i] - rdg[i];
    out[25 + 4 * i + 3] = div ? 0.0 : t_dev[i];
    out[37 + i] = 0.0;
  }
  out[12] = div ? 1.0 : 0.0;
  out[40] = 1.0;
  for (int i = 41; i < 48; ++i) out[i] = 0.0;
}

}  // namespace

extern "C" int lis_pose_pre(void* pose, void* pose_prev, void* first_pose,
                            void* thr_sse, void* model_dev, void* num_poses,
                            void* thr_n, double min_motion_th,
                            double initial_threshold, double max_range,
                            int deskew_on, void* out, void* stream) {
  pose_pre_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(pose), static_cast<const double*>(pose_prev),
      static_cast<const double*>(first_pose), static_cast<const double*>(thr_sse),
      static_cast<const double*>(model_dev), static_cast<const int*>(num_poses),
      static_cast<const int*>(thr_n), min_motion_th, initial_threshold,
      max_range, deskew_on, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lis_pose_post(void* corr, void* guess, double max_model_deviation,
                             void* out, void* stream) {
  pose_post_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(corr), static_cast<const double*>(guess),
      max_model_deviation, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
