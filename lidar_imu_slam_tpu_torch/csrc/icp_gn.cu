// Fused robust Gauss-Newton ICP rounds: kernels K1 (fused_gn_carry), K4
// (fused_gn) and K5 (fused_gn_batched).
//
// Replaces: the JAX package's ops/pallas/icp_gn.py:fused_gn_carry (body
// _kernel_carry over _gn_iterations(track_m=True)), fused_gn (body _kernel)
// and fused_gn_batched (body _kernel_batched, gridded over streams).
//
// One launch runs n_inner point-to-point GN iterations against a fixed
// candidate set — the TPU kernels' one-dispatch-per-ICP-round contract.
// K1 then de-centres the accumulated correction by the anchor and composes
// it with the carried world pose. K4 and K5 share K1's block loop
// (gn_iterations) and write the centred correction: K5 runs one block per
// stream, each with its own scalars; K4 is its launch with one stream.
// Per iteration:
//   * every query transformed by the current correction (f32),
//   * nearest of its NC candidate slots (f32 running min; +inf = empty),
//   * gate d^2 < max_d2, Geman-McClure weight kth^2 / (kth + r^2)^2,
//   * 18 weighted sums accumulated in f64 per thread, reduced over the
//     block (warp shuffles, then one warp over the per-warp partials),
//   * thread 0: Jacobi-preconditioned 6x6 normal equations with a
//     1e-6 * max-diagonal ridge, unrolled Cholesky, step clamp, Rodrigues
//     exp + left Jacobian, left-compose, convergence / staleness — all f64 —
//     and broadcast of the new correction through shared memory.
//
// What bounds it on the card: reading the candidates. At the main-path
// shape (N = 4096 queries, NC = 80 slots) one iteration reads 3 x 80 x 4096
// f32 = 3.9 MB, from L2 after the first iteration, through ONE SM; the
// block-wide reduction and the serial f64 solve add a few microseconds of
// latency per iteration. This first cut is one block: simple and right,
// using a hundredth of the card. Spreading queries over many blocks with a
// second reduction pass (or a cluster reduction) is later work.
//
// K4 / K5 at their deployment shapes: 8 streams x 4096 queries x 80 slots
// (8 blocks, each K1's work) and 256 streams x 512 queries x 16 slots (256
// blocks of one query per thread: the card is filled, and each block's
// candidates, 98 KB, stay in L1/L2 across iterations).
//
// Layout: q (3, N) f32 centred queries; qmask (N,) f32; cand (3, NC, N) f32
// centred candidates (neighbouring threads read neighbouring queries of
// one slot: coalesced); scal (8,) f64 [kernel_th, max_d2, est_th,
// min_corr, max_step, stale_d2, -, -]; carry (15,) f64 [R 9 | t 3 |
// anchor 3]. Output (16,) f64: [R 9 | t 3 | n_corr | rms | iters | flags],
// flags = converged + 2 * stale, (R, t) = T_delta @ T_carry in the world.
// K5 takes the same per stream with a leading S (q (S, 3, N), qmask (S, N),
// cand (S, 3, NC, N), scal (S, 8)) and writes (S, 16) rows whose (R, t)
// is the centred correction itself.
//
// Built without fast math: +inf candidates, exact sqrt / sin / cos.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 18;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

struct GnState {
  double R[9];
  double t[3];
  double conv, stale, ncorr, rms, iters;
};

// One GN update from the reduced sums (thread 0 only).
__device__ void gn_update(const double* S, GnState& g, double min_corr,
                          double max_step, double est_th, double stale_d2) {
  const bool active = g.conv < 0.5 && g.stale < 0.5;
  const double sw = S[0], Sx = S[1], Sy = S[2], Sz = S[3];
  const double sxx = S[4], syy = S[5], szz = S[6];
  const double sxy = S[7], sxz = S[8], syz = S[9];
  const double g0 = S[10], g1 = S[11], g2 = S[12];
  const double g3 = S[13], g4 = S[14], g5 = S[15];
  const double ncorr = S[16];
  const double rms = sqrt(S[17] / fmax(ncorr, 1.0));

  // Jacobi preconditioning: D = diag(1,1,1,1/s,1/s,1/s), s = RMS coordinate
  const double s2 = (sxx + syy + szz) / fmax(sw, 1e-20);
  const double is = 1.0 / sqrt(fmax(s2, 1e-12));
  const double is2 = is * is;
  double A[6][6] = {
      {sw, 0, 0, 0, Sz * is, -Sy * is},
      {0, sw, 0, -Sz * is, 0, Sx * is},
      {0, 0, sw, Sy * is, -Sx * is, 0},
      {0, -Sz * is, Sy * is, (syy + szz) * is2, -sxy * is2, -sxz * is2},
      {Sz * is, 0, -Sx * is, -sxy * is2, (sxx + szz) * is2, -syz * is2},
      {-Sy * is, Sx * is, 0, -sxz * is2, -syz * is2, (sxx + syy) * is2}};
  const double b[6] = {-g0, -g1, -g2, -g3 * is, -g4 * is, -g5 * is};
  const double dmax = fmax(fmax(A[0][0], A[3][3]), fmax(A[4][4], A[5][5]));
  const double ridge = 1e-6 * fmax(dmax, 1e-12);

  double L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double d = A[j][j] + ridge;
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = sqrt(fmax(d, 1e-25));
    const double inv = 1.0 / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      double acc = A[i][j];
      for (int k = 0; k < j; ++k) acc -= L[i][k] * L[j][k];
      L[i][j] = acc * inv;
    }
  }
  double y[6], xi[6];
  for (int i = 0; i < 6; ++i) {
    double acc = b[i];
    for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
    y[i] = acc / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    double acc = y[i];
    for (int k = i + 1; k < 6; ++k) acc -= L[k][i] * xi[k];
    xi[i] = acc / L[i][i];
  }
  double vx = xi[0], vy = xi[1], vz = xi[2];
  double ox = xi[3] * is, oy = xi[4] * is, oz = xi[5] * is;

  const bool ok = ncorr >= min_corr;
  const double step = sqrt(vx * vx + vy * vy + vz * vz + ox * ox + oy * oy + oz * oz);
  const double clamp = step > max_step ? max_step / fmax(step, 1e-20) : 1.0;
  const double scale = (active && ok) ? clamp : 0.0;
  vx *= scale; vy *= scale; vz *= scale;
  ox *= scale; oy *= scale; oz *= scale;

  // Rodrigues R = I + a W + b2 W^2 and left Jacobian V = I + b2 W + c3 W^2
  const double sq = ox * ox + oy * oy + oz * oz;
  const double th = sqrt(fmax(sq, 1e-30));
  const bool small = sq < 1e-12;
  const double safe_sq = fmax(sq, 1e-30);
  const double a = small ? 1.0 - sq / 6.0 : sin(th) / th;
  const double b2 = small ? 0.5 - sq / 24.0 : (1.0 - cos(th)) / safe_sq;
  const double c3 = small ? 1.0 / 6.0 : (1.0 - a) / safe_sq;
  const double E[3][3] = {
      {1.0 + b2 * (ox * ox - sq), a * -oz + b2 * ox * oy, a * oy + b2 * ox * oz},
      {a * oz + b2 * ox * oy, 1.0 + b2 * (oy * oy - sq), a * -ox + b2 * oy * oz},
      {a * -oy + b2 * ox * oz, a * ox + b2 * oy * oz, 1.0 + b2 * (oz * oz - sq)}};
  const double V[3][3] = {
      {1.0 + c3 * (ox * ox - sq), b2 * -oz + c3 * ox * oy, b2 * oy + c3 * ox * oz},
      {b2 * oz + c3 * ox * oy, 1.0 + c3 * (oy * oy - sq), b2 * -ox + c3 * oy * oz},
      {b2 * -oy + c3 * ox * oz, b2 * ox + c3 * oy * oz, 1.0 + c3 * (oz * oz - sq)}};
  double Rn[9], tn[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Rn[3 * i + j] = E[i][0] * g.R[j] + E[i][1] * g.R[3 + j] + E[i][2] * g.R[6 + j];
    tn[i] = E[i][0] * g.t[0] + E[i][1] * g.t[1] + E[i][2] * g.t[2] +
            (V[i][0] * vx + V[i][1] * vy + V[i][2] * vz);
  }
  for (int i = 0; i < 9; ++i) g.R[i] = Rn[i];
  for (int i = 0; i < 3; ++i) g.t[i] = tn[i];

  if (active) {
    g.ncorr = ncorr;
    g.rms = rms;
    g.iters += 1.0;
    if (!ok || fmin(step, max_step) < est_th) g.conv = 1.0;
  }
  const double drift2 = tn[0] * tn[0] + tn[1] * tn[1] + tn[2] * tn[2];
  if (g.conv < 0.5 && drift2 > stale_d2) g.stale = 1.0;
}

// Per-block workspace of the GN loop.
struct GnShared {
  double part[kWarps][kSums];
  double tot[kSums];
  GnState g;
};

// n_inner robust GN iterations of one block over its queries (see the
// header comment); leaves the centred correction and the counters in sh.g.
// Shared by K1 (one block, carry epilogue) and K4 / K5 (one block per
// stream, centred output).
__device__ __forceinline__ void gn_iterations(const float* __restrict__ q,
                                              const float* __restrict__ qmask,
                                              const float* __restrict__ cand,
                                              const double* __restrict__ scal, int n,
                                              int nc, int n_inner, GnShared& sh) {
  GnState& g = sh.g;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float kth = static_cast<float>(scal[0]);
  const float maxd2 = static_cast<float>(scal[1]);
  if (tid == 0) {
    for (int i = 0; i < 9; ++i) g.R[i] = (i % 4 == 0) ? 1.0 : 0.0;
    g.t[0] = g.t[1] = g.t[2] = 0.0;
    g.conv = g.stale = g.ncorr = g.rms = g.iters = 0.0;
  }
  __syncthreads();

  const float* qx = q;
  const float* qy = q + n;
  const float* qz = q + 2 * (size_t)n;
  const size_t plane = (size_t)nc * n;

  for (int it = 0; it < n_inner; ++it) {
    // a frozen state (converged or stale) changes nothing further
    if (g.conv >= 0.5 || g.stale >= 0.5) break;
    const float r00 = (float)g.R[0], r01 = (float)g.R[1], r02 = (float)g.R[2];
    const float r10 = (float)g.R[3], r11 = (float)g.R[4], r12 = (float)g.R[5];
    const float r20 = (float)g.R[6], r21 = (float)g.R[7], r22 = (float)g.R[8];
    const float t0 = (float)g.t[0], t1 = (float)g.t[1], t2 = (float)g.t[2];

    double acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

    for (int i = tid; i < n; i += kThreads) {
      const float x = qx[i], y = qy[i], z = qz[i];
      const float wx = r00 * x + r01 * y + r02 * z + t0;
      const float wy = r10 * x + r11 * y + r12 * z + t1;
      const float wz = r20 * x + r21 * y + r22 * z + t2;
      float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
      for (int j = 0; j < nc; ++j) {
        const size_t o = (size_t)j * n + i;
        const float cx = cand[o], cy = cand[plane + o], cz = cand[2 * plane + o];
        const float dx = cx - wx, dy = cy - wy, dz = cz - wz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (d2 < best) { best = d2; bx = cx; by = cy; bz = cz; }
      }
      if (qmask[i] > 0.5f && best < maxd2) {
        const float rx = wx - bx, ry = wy - by, rz = wz - bz;
        const float res2 = rx * rx + ry * ry + rz * rz;
        const float den = kth + res2;
        const double w = (double)((kth * kth) / (den * den));
        const double sx = wx, sy = wy, sz = wz;
        const double rxd = rx, ryd = ry, rzd = rz;
        const double wsx = w * sx, wsy = w * sy, wsz = w * sz;
        acc[0] += w;
        acc[1] += wsx; acc[2] += wsy; acc[3] += wsz;
        acc[4] += wsx * sx; acc[5] += wsy * sy; acc[6] += wsz * sz;
        acc[7] += wsx * sy; acc[8] += wsx * sz; acc[9] += wsy * sz;
        acc[10] += w * rxd; acc[11] += w * ryd; acc[12] += w * rzd;
        acc[13] += wsy * rzd - wsz * ryd;
        acc[14] += wsz * rxd - wsx * rzd;
        acc[15] += wsx * ryd - wsy * rxd;
        acc[16] += 1.0;
        acc[17] += (double)best;
      }
    }

#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const double v = warp_sum(acc[k]);
      if (lane == 0) sh.part[warp][k] = v;
    }
    __syncthreads();
    if (warp == 0) {
      for (int k = 0; k < kSums; ++k) {
        const double v = warp_sum(lane < kWarps ? sh.part[lane][k] : 0.0);
        if (lane == 0) sh.tot[k] = v;
      }
    }
    __syncthreads();
    if (tid == 0)
      gn_update(sh.tot, g, scal[3], scal[4], scal[2], scal[5]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fused_gn_carry_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                      const float* __restrict__ cand, const double* __restrict__ scal,
                      const double* __restrict__ carry, int n, int nc, int n_inner,
                      double* __restrict__ out) {
  __shared__ GnShared sh;
  const GnState& g = sh.g;
  const int tid = threadIdx.x;
  gn_iterations(q, qmask, cand, scal, n, nc, n_inner, sh);

  if (tid == 0) {
    // de-centre: T_world = Trans(a) T_centred Trans(-a), so
    // t_world = t + (I - R) a; then compose with the carried pose
    const double* Rc = carry;
    const double* tc = carry + 9;
    const double* an = carry + 12;
    for (int i = 0; i < 3; ++i) {
      double twd = g.t[i];
      for (int j = 0; j < 3; ++j) twd += ((i == j ? 1.0 : 0.0) - g.R[3 * i + j]) * an[j];
      for (int j = 0; j < 3; ++j)
        out[3 * i + j] = g.R[3 * i] * Rc[j] + g.R[3 * i + 1] * Rc[3 + j] +
                         g.R[3 * i + 2] * Rc[6 + j];
      out[9 + i] = g.R[3 * i] * tc[0] + g.R[3 * i + 1] * tc[1] +
                   g.R[3 * i + 2] * tc[2] + twd;
    }
    out[12] = g.ncorr;
    out[13] = g.rms;
    out[14] = g.iters;
    out[15] = g.conv + 2.0 * g.stale;
  }
}

// K4 / K5: one block per stream (blockIdx.x = s), each running the GN loop
// on its own queries, candidates and scalars; the centred correction is
// written out as is (the caller de-centres and composes in f64).
__global__ void __launch_bounds__(kThreads)
fused_gn_batched_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                        const float* __restrict__ cand, const double* __restrict__ scal,
                        int n, int nc, int n_inner, double* __restrict__ out) {
  __shared__ GnShared sh;
  const GnState& g = sh.g;
  const size_t s = blockIdx.x;
  gn_iterations(q + s * 3 * (size_t)n, qmask + s * (size_t)n,
                cand + s * 3 * (size_t)nc * n, scal + s * 8, n, nc, n_inner, sh);
  if (threadIdx.x == 0) {
    double* o = out + s * 16;
    for (int i = 0; i < 9; ++i) o[i] = g.R[i];
    for (int i = 0; i < 3; ++i) o[9 + i] = g.t[i];
    o[12] = g.ncorr;
    o[13] = g.rms;
    o[14] = g.iters;
    o[15] = g.conv + 2.0 * g.stale;
  }
}

}  // namespace

extern "C" int lis_fused_gn_batched(void* q, void* qmask, void* cand, void* scal,
                                    int n, int nc, int n_inner, int streams,
                                    void* out, void* stream) {
  fused_gn_batched_kernel<<<streams, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qmask),
      static_cast<const float*>(cand), static_cast<const double*>(scal), n, nc,
      n_inner, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lis_fused_gn_carry(void* q, void* qmask, void* cand, void* scal,
                                  void* carry, int n, int nc, int n_inner,
                                  void* out, void* stream) {
  fused_gn_carry_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qmask),
      static_cast<const float*>(cand), static_cast<const double*>(scal),
      static_cast<const double*>(carry), n, nc, n_inner,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
