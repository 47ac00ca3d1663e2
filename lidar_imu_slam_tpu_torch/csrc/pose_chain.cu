// Per-scan pose bookkeeping of the lidar-only fast path: kernels K2
// (pose_pre) and K3 (pose_post).
//
// Replaces: the JAX package's ops/pallas/pose_chain.py:pose_pre (body
// _pre_kernel) and pose_chain.py:pose_post (body _post_kernel).
//
// What bounds it on the card: latency, and the launch. Each kernel is a
// chain of ~100-300 dependent f64 operations on a few hundred bytes of
// pose state; a one-block launch alone takes ~2 us. The point of the
// kernels is keeping the per-scan pose math on the device: the tiny tensor
// operations before and after ICP become one launch each, and the host
// never reads a pose to decide anything. K3 also writes the next state's
// pose bookkeeping (new pose, pose_prev', first_pose', num_poses',
// model_deviation', the f32 map delta), which XLA fuses into the TPU's
// jitted step and which would otherwise be a dozen small launches.
//
// Design: one warp a kernel (<<<1, 32>>>). The lanes load the inputs
// together (16-byte loads where a pointer is 16-byte aligned, else 8-byte
// ones) into shared memory and compute the 3x3 products and 3-vectors one
// entry a lane (a 3x4 [R | t] block on 12 lanes: the t column is the same
// dot product against the translation); where a lane needs a whole column
// or matrix of a product it computes it itself rather than wait at another
// warp sync (K3: three syncs in all). The scalar chains (the adaptive
// threshold, the has-moved test, the deskew twist's atan2 and one sincos,
// the divergence test) run on every lane alike, so that the warp never
// splits and the compiler interleaves the chains. Each output row leaves
// with one coalesced store by the lanes. Every entry keeps the order of
// operations of the f64 formulas below (those of a single-thread version),
// so the plain versions agree to ~1e-15.
//
// f64 throughout. The TPU kernels carried f32 rotations and float-float
// translations because the TPU has no f64; the H100 has native f64, so the
// state tensors are read directly (no hi/lo split). Output layouts keep the
// TPU kernels' slot order minus the "lo" slots:
//
//   pose_pre: out (32,) f64 row
//     [0:9] guess R  [9:12] guess t  [12] sigma  [13] moved  [14] thr_sse'
//     [15] thr_n'  [16] |w|  [17:20] k  [20:23] v  [23:26] w x v
//     [26:29] w x (w x v)  [29:32] 0
//   and out_n () i32 thr_n'.
//   pose_post: out (112,) f64 = (7, 4, 4):
//     [0:48] the row: [0:9] new pose R (orthonormalized)  [9:12] new pose t
//       [12] diverged  [13:22] delta R  [22:25] delta t  [25:41]
//       model_deviation' (4x4 row-major)  [41:48] 0
//     [48:64] new pose  [64:80] pose_prev'  [80:96] first_pose'
//     [96:112] model_deviation' (each 4x4 row-major, 16-byte aligned)
//   out_n () i32 num_poses'; out_f (12,) f32 delta R (3x3), delta t.
//
// Built without fast math: exact sqrt, atan2, sin, cos.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// dst[2k], dst[2k + 1] = src[2k], src[2k + 1]: one 16-byte load where src
// is 16-byte aligned, else two 8-byte loads
__device__ __forceinline__ void load_pair(const double* __restrict__ src, int k,
                                          double* dst) {
  if (aligned16(src)) {
    const double2 v = reinterpret_cast<const double2*>(src)[k];
    dst[2 * k] = v.x;
    dst[2 * k + 1] = v.y;
  } else {
    dst[2 * k] = src[2 * k];
    dst[2 * k + 1] = src[2 * k + 1];
  }
}

__device__ __forceinline__ double clamp1(double x) { return fmin(fmax(x, -1.0), 1.0); }

__device__ __forceinline__ void cross3(const double a[3], const double b[3], double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// ---------------------------------------------------------------------------
// K2 pose_pre
// ---------------------------------------------------------------------------

struct PreShared {
  double m[4][16];  // pose, pose_prev, first_pose, model_dev (4x4 row-major)
  double rel[12];   // [R_rel | t_rel] (3x4 row-major): pose_prev^-1 pose
  double mrel[3];   // first_pose^-1 pose's translation
  double row[kLanes];
};

__global__ void __launch_bounds__(kLanes)
pose_pre_kernel(const double* __restrict__ pose, const double* __restrict__ pose_prev,
                const double* __restrict__ first_pose, const double* __restrict__ thr_sse,
                const double* __restrict__ model_dev, const int* __restrict__ num_poses,
                const int* __restrict__ thr_n, double min_motion_th,
                double initial_threshold, double max_range, int deskew_on,
                double* __restrict__ out, int* __restrict__ out_n) {
  __shared__ PreShared s;
  const int lane = threadIdx.x;
  {  // lanes 8q .. 8q + 7 load matrix q
    const int q = lane >> 3;
    const double* src = q == 0 ? pose : q == 1 ? pose_prev : q == 2 ? first_pose : model_dev;
    load_pair(src, lane & 7, s.m[q]);
  }
  const int np = *num_poses;
  const double sse0 = *thr_sse;
  const int n0 = *thr_n;
  __syncwarp();
  const double* Tc = s.m[0];
  const double* Tf = s.m[2];
  const double* Md = s.m[3];

  // lanes 0-11: rel = pose_prev^-1 pose (reference icp.cpp:146-154); lanes
  // 12-14: the has-moved translation first_pose^-1 pose (icp.cpp:156-163).
  // Entry (i, j) of A^T [Rc | tc - tA], A = pose_prev or first_pose.
  if (lane < 15) {
    const double* A = lane < 12 ? s.m[1] : Tf;
    const int i = lane < 12 ? lane >> 2 : lane - 12;
    const int j = lane < 12 ? lane & 3 : 3;
    double b[3];
    for (int k = 0; k < 3; ++k) b[k] = j < 3 ? Tc[4 * k + j] : Tc[4 * k + 3] - A[4 * k + 3];
    const double v = A[i] * b[0] + A[4 + i] * b[1] + A[8 + i] * b[2];
    if (lane < 12) {
      s.rel[lane] = v;
    } else {
      s.mrel[i] = v;
    }
  }
  // adaptive threshold's model error (reference threshold.cpp:5-12), on
  // every lane: it needs nothing of the products
  const double c_md = clamp1(0.5 * (Md[0] + Md[5] + Md[10] - 1.0));
  const double sin_half = sqrt(fmax(0.5 * (1.0 - c_md), 0.0));
  const double t_md2 = Md[3] * Md[3] + Md[7] * Md[7] + Md[11] * Md[11];
  const double err = 2.0 * max_range * sin_half + sqrt(t_md2);
  __syncwarp();

  // lanes 0-11: the guess [R_g | t_g] = last (x) prediction, with the
  // constant-velocity prediction rel when 2 poses exist, else identity,
  // and the last pose when 1 exists, else identity
  const bool has2 = np >= 2, has1 = np >= 1;
  if (lane < 12) {
    const int i = lane >> 2, j = lane & 3;
    double a[3], b[3];
    for (int k = 0; k < 3; ++k) {
      a[k] = has1 ? Tc[4 * i + k] : (i == k ? 1.0 : 0.0);
      b[k] = has2 ? s.rel[4 * k + j] : (k == j ? 1.0 : 0.0);
    }
    const double v = a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
    if (j < 3) {
      s.row[3 * i + j] = v;
    } else {
      s.row[9 + i] = (has1 ? Tc[4 * i + 3] : 0.0) + v;
    }
  }

  // has_moved and the threshold accumulators (threshold.cpp:16-29)
  const double* mrel = s.mrel;
  const double m2 = mrel[0] * mrel[0] + mrel[1] * mrel[1] + mrel[2] * mrel[2];
  const double mth = 5.0 * min_motion_th;
  const bool moved = has1 && (m2 > mth * mth);
  const bool acc = moved && (err > min_motion_th);
  const double sse = sse0 + (acc ? err * err : 0.0);
  const int n_new = n0 + (acc ? 1 : 0);
  const double sigma = (moved && n_new >= 1)
                           ? sqrt(sse / (double)(n_new > 1 ? n_new : 1))
                           : initial_threshold;

  // deskew twist xi = log(rel) as the pieces deskew_from_scalars consumes;
  // all zero when gated (num_poses <= 2 or deskew off)
  double wn_o = 0.0, kx[3] = {0, 0, 0}, v[3] = {0, 0, 0};
  double wxv[3] = {0, 0, 0}, wwxv[3] = {0, 0, 0};
  if (deskew_on) {
    const double* R = s.rel;  // R_rel (i, j) at R[4 i + j], t_rel i at R[4 i + 3]
    const double t_rel[3] = {R[3], R[7], R[11]};
    const double s_vec[3] = {0.5 * (R[9] - R[6]), 0.5 * (R[2] - R[8]), 0.5 * (R[4] - R[1])};
    const double c = clamp1(0.5 * (R[0] + R[5] + R[10] - 1.0));
    const double sn = sqrt(fmax(
        s_vec[0] * s_vec[0] + s_vec[1] * s_vec[1] + s_vec[2] * s_vec[2], 0.0));
    const double th = atan2(sn, c);
    const bool small = sn < 1e-6;
    const double scale = small ? 1.0 + sn * sn / 6.0 : th / sn;
    const double w[3] = {s_vec[0] * scale, s_vec[1] * scale, s_vec[2] * scale};
    const double th2 = th * th, half = 0.5 * th;
    double coeff = 1.0 / 12.0 + th2 / 720.0;
    if (!small) {
      double sh, ch;
      sincos(half, &sh, &ch);
      coeff = (1.0 - half * ch / sh) / th2;
    }
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
  if (lane == 0) {
    s.row[12] = sigma;
    s.row[13] = moved ? 1.0 : 0.0;
    s.row[14] = sse;
    s.row[15] = (double)n_new;
    s.row[16] = wn_o;
    for (int i = 0; i < 3; ++i) {
      s.row[17 + i] = kx[i];
      s.row[20 + i] = v[i];
      s.row[23 + i] = wxv[i];
      s.row[26 + i] = wwxv[i];
      s.row[29 + i] = 0.0;
    }
    *out_n = n_new;
  }
  __syncwarp();
  out[lane] = s.row[lane];
}

// ---------------------------------------------------------------------------
// K3 pose_post
// ---------------------------------------------------------------------------

struct PostShared {
  double corr[12];   // [R 9 | t 3] the ICP correction
  double guess[12];  // [R 9 | t 3] the guess
  double icp[12];    // [R_icp | t_icp] (3x4): correction (x) guess
  double dev[12];    // [R_dev | t_dev] (3x4): guess^-1 (x) pose_icp
  double out[112];   // the (7, 4, 4) output, rows 0-3 and 6 (4, 5 go direct)
};

__global__ void __launch_bounds__(kLanes)
pose_post_kernel(const double* __restrict__ corr, const double* __restrict__ guess,
                 const double* __restrict__ pose, const double* __restrict__ first_pose,
                 const int* __restrict__ num_poses, double max_model_deviation,
                 double* __restrict__ out, int* __restrict__ out_n,
                 float* __restrict__ out_f) {
  __shared__ PostShared s;
  const int lane = threadIdx.x;
  // lanes 0-5 load the correction, 6-11 the guess; every lane one entry of
  // pose (lanes 0-15) or first_pose (16-31), kept for pose_prev' and
  // first_pose'
  if (lane < 12) load_pair(lane < 6 ? corr : guess, lane % 6, lane < 6 ? s.corr : s.guess);
  const double mine = lane < 16 ? pose[lane] : first_pose[lane - 16];
  const int np = *num_poses;
  __syncwarp();
  const double* Rc = s.corr;  // (i, j) at [3 i + j], t at [9 + i]
  const double* Rg = s.guess;
  const int i = lane >> 2, j = lane & 3;  // lanes 0-11: entry (i, j) of a 3x4 block

  // pose_icp = correction (x) guess, and the model deviation guess^-1 (x)
  // pose_icp (reference icp.cpp:78-79): lane (i, j) computes column j of
  // pose_icp itself (the dot products that column's lanes compute), keeps
  // entry (i, j) and takes entry (i, j) of the deviation
  if (lane < 12) {
    double b[3];
    for (int r = 0; r < 3; ++r) b[r] = j < 3 ? Rg[3 * r + j] : Rg[9 + r];
    double col[3];
    for (int k = 0; k < 3; ++k) {
      col[k] = Rc[3 * k] * b[0] + Rc[3 * k + 1] * b[1] + Rc[3 * k + 2] * b[2];
      if (j == 3) col[k] += Rc[9 + k];
    }
    // (selects, not col[i]: a lane-dependent index would put col in memory)
    s.icp[lane] = i == 0 ? col[0] : i == 1 ? col[1] : col[2];
    for (int k = 0; k < 3; ++k) b[k] = j < 3 ? col[k] : col[k] - Rg[9 + k];
    s.dev[lane] = Rg[i] * b[0] + Rg[3 + i] * b[1] + Rg[6 + i] * b[2];
  }
  __syncwarp();

  // divergence gate: fall back to the motion prediction (every lane)
  const double* td = s.dev;  // t_dev i at [4 i + 3]
  const double dev2 = td[3] * td[3] + td[7] * td[7] + td[11] * td[11];
  const bool div = dev2 > max_model_deviation * max_model_deviation;
  // R_s (i, j) and t_s i: the guess when diverged, else pose_icp
  auto rs = [&](int r, int q) { return div ? Rg[3 * r + q] : s.icp[4 * r + q]; };
  auto ts = [&](int r) { return div ? Rg[9 + r] : s.icp[4 * r + 3]; };

  // model_deviation' (identity when diverged) into row [25:41] and [96:112]
  if (lane < 16) {
    const int r = lane >> 2, q = lane & 3;
    const double eye = r == q ? 1.0 : 0.0;
    const double md = r == 3 ? eye : div ? eye : s.dev[lane];
    s.out[25 + lane] = md;
    s.out[96 + lane] = md;
  }
  // lanes 0-11: the new pose [R_o | t_s] and the map-correction delta
  // new_pose (x) guess^-1 = [R_d | t_s - R_d t_g] (reference icp.cpp:81)
  if (lane < 12) {
    // one Newton orthonormalization step R_o = R_s (1.5 I - 0.5 R_s^T R_s),
    // every lane the whole of C = 1.5 I - 0.5 R_s^T R_s, then its row of R_o
    double c[9];
    for (int k = 0; k < 3; ++k)
      for (int q = 0; q < 3; ++q) {
        const double e = rs(0, k) * rs(0, q) + rs(1, k) * rs(1, q) + rs(2, k) * rs(2, q);
        c[3 * k + q] = (k == q ? 1.5 : 0.0) - 0.5 * e;
      }
    double ro[3];  // row i of R_o
    for (int q = 0; q < 3; ++q)
      ro[q] = rs(i, 0) * c[q] + rs(i, 1) * c[3 + q] + rs(i, 2) * c[6 + q];
    double rd[3];  // row i of R_d = R_o R_g^T
    for (int q = 0; q < 3; ++q)
      rd[q] = ro[0] * Rg[3 * q] + ro[1] * Rg[3 * q + 1] + ro[2] * Rg[3 * q + 2];
    if (j < 3) {  // (selects, not ro[j]: a lane-dependent index would put ro in memory)
      const double roj = j == 0 ? ro[0] : j == 1 ? ro[1] : ro[2];
      s.out[3 * i + j] = roj;
      s.out[13 + 3 * i + j] = j == 0 ? rd[0] : j == 1 ? rd[1] : rd[2];
      s.out[48 + 4 * i + j] = roj;
    } else {
      const double rdg = rd[0] * Rg[9] + rd[1] * Rg[10] + rd[2] * Rg[11];
      s.out[9 + i] = ts(i);
      s.out[22 + i] = ts(i) - rdg;
      s.out[48 + 4 * i + 3] = ts(i);
    }
  } else if (lane < 16) {  // the new pose's last row
    s.out[48 + lane] = lane == 15 ? 1.0 : 0.0;
  } else if (lane < 23) {
    s.out[41 + lane - 16] = 0.0;
  } else if (lane == 23) {
    s.out[12] = div ? 1.0 : 0.0;
  }
  __syncwarp();

  out[lane] = s.out[lane];
  out[32 + lane] = s.out[32 + lane];
  // pose_prev' and first_pose': the new pose on the first scan
  out[64 + lane] = np == 0 ? s.out[48 + (lane & 15)] : mine;
  if (lane < 16) out[96 + lane] = s.out[96 + lane];
  if (lane < 12) out_f[lane] = (float)s.out[13 + lane];
  if (lane == 0) *out_n = np + 1;
}

}  // namespace

extern "C" int lis_pose_pre(void* pose, void* pose_prev, void* first_pose, void* thr_sse,
                            void* model_dev, void* num_poses, void* thr_n,
                            double min_motion_th, double initial_threshold, double max_range,
                            int deskew_on, void* out, void* out_n, void* stream) {
  pose_pre_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(pose), static_cast<const double*>(pose_prev),
      static_cast<const double*>(first_pose), static_cast<const double*>(thr_sse),
      static_cast<const double*>(model_dev), static_cast<const int*>(num_poses),
      static_cast<const int*>(thr_n), min_motion_th, initial_threshold, max_range, deskew_on,
      static_cast<double*>(out), static_cast<int*>(out_n));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lis_pose_post(void* corr, void* guess, void* pose, void* first_pose,
                             void* num_poses, double max_model_deviation, void* out,
                             void* out_n, void* out_f, void* stream) {
  pose_post_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(corr), static_cast<const double*>(guess),
      static_cast<const double*>(pose), static_cast<const double*>(first_pose),
      static_cast<const int*>(num_poses), max_model_deviation, static_cast<double*>(out),
      static_cast<int*>(out_n), static_cast<float*>(out_f));
  return static_cast<int>(cudaGetLastError());
}
