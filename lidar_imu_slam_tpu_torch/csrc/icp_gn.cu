// Fused robust Gauss-Newton ICP rounds: kernels K1 (fused_gn_carry), K4
// (fused_gn) and K5 (fused_gn_batched), one cluster kernel for all three.
//
// Replaces: the JAX package's ops/pallas/icp_gn.py:fused_gn_carry (body
// _kernel_carry over _gn_iterations(track_m=True)), fused_gn (body _kernel)
// and fused_gn_batched (body _kernel_batched, gridded over streams).
//
// One launch runs n_inner point-to-point GN iterations against a fixed
// candidate set — the TPU kernels' one-dispatch-per-ICP-round contract.
// Per iteration:
//   * every query transformed by the current correction (f32),
//   * nearest of its NC candidate slots (f32 running min; +inf = empty;
//     the first slot wins a tie),
//   * gate d^2 < max_d2, Geman-McClure weight kth^2 / (kth + r^2)^2,
//   * 18 weighted sums accumulated in f64 per thread,
//   * one f64 solve on one thread: Jacobi-preconditioned 6x6 normal
//     equations with a 1e-6 * max-diagonal ridge, unrolled Cholesky, step
//     clamp, Rodrigues exp + left Jacobian, left-compose, convergence /
//     staleness.
// K1 then de-centres the correction by the anchor and composes it with the
// carried world pose; K4 and K5 write the centred correction (K4 is K5's
// launch with one stream).
//
// What bounds it on the card. At the main-path shape (N = 4096 queries,
// NC = 80 slots) an iteration reads 3 x 80 x 4096 f32 = 3.9 MB of
// candidates, from L2 after the first (the card's L2 holds 50 MB). One SM
// draws about 100 GB/s from L2, so a single block per stream spends ~35 us
// an iteration on those reads. The byte bound (every input read once: 1.2
// us for K1) is out of reach for another reason: every iteration ends in a
// serial f64 solve that the next one needs, so the floor is n_inner x (the
// solve + two cluster barriers), a few microseconds each.
//
// Design: each stream is a thread-block cluster of C CTAs (grid S x C,
// cluster dims (C, 1, 1); C and the queries per CTA come from
// ops/kernels/icp_gn.py:launch_shape, about 256 x 80 query-slot pairs a
// CTA, C <= 16). CTA rank r takes queries
// [r * per_cta, (r + 1) * per_cta), so the candidate reads spread over C
// SMs. Per iteration each CTA reduces its 18 f64 sums (warp shuffles, then
// one warp over the per-warp partials) and writes them into rank 0's
// shared memory through distributed shared memory. After a cluster
// barrier, rank 0 adds the C partials in rank order (a fixed order, no
// atomics: repeated launches give bit-equal rows), solves on one thread
// and writes the new state into every rank's shared memory; a second
// barrier releases the cluster. Every CTA then tests the same flags and
// leaves the loop in the same iteration, and rank 0 writes the row. The
// candidates stay in global memory / L2 in the coalesced (3, NC, N)
// layout: a CTA's slice (245 KB at 256 queries x 80 slots) does not fit
// in shared memory.
//
// Layout: q (3, N) f32 centred queries; qmask (N,) f32; cand (3, NC, N) f32
// centred candidates (neighbouring threads read neighbouring queries of
// one slot: coalesced); scal (8,) f64 [kernel_th, max_d2, est_th,
// min_corr, max_step, stale_d2, -, -]; carry (15,) f64 [R 9 | t 3 |
// anchor 3], or null. Output (16,) f64: [R 9 | t 3 | n_corr | rms | iters |
// flags], flags = converged + 2 * stale; with a carry (K1), (R, t) =
// T_delta @ T_carry in the world, without one (K4 / K5) the centred
// correction itself. Streams add a leading S to every array (q (S, 3, N),
// qmask (S, N), cand (S, 3, NC, N), scal (S, 8), carry (S, 15), out (S,
// 16)); K1 and K4 are launches with S = 1.
//
// Built without fast math: +inf candidates, exact sqrt / sin / cos.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 18;
constexpr int kMaxCluster = 16;  // MAX_CLUSTER in ops/kernels/icp_gn.py

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

struct GnState {
  double R[9];
  double t[3];
  double conv, stale, ncorr, rms, iters;
};

// One GN update from the reduced sums (one thread).
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

constexpr int kStateWords = sizeof(GnState) / sizeof(double);

// Per-CTA workspace of the GN loop.
struct GnShared {
  double warp_part[kWarps][kSums];
  double part[kMaxCluster][kSums];  // rank 0: the cluster's CTA sums, by rank
  double tot[kSums];
  GnState g;
};

// One stream per cluster (see the header comment): n_inner robust GN
// iterations over the stream's queries, CTA rank r on its slice; rank 0
// solves and writes the row (K1's carry epilogue when carry is not null).
__global__ void __launch_bounds__(kThreads)
gn_cluster_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                  const float* __restrict__ cand, const double* __restrict__ scal,
                  const double* __restrict__ carry, int n, int nc, int n_inner,
                  int per_cta, double* __restrict__ out) {
  __shared__ GnShared sh;
  GnState& g = sh.g;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const size_t s = blockIdx.x / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  q += s * 3 * (size_t)n;
  qmask += s * (size_t)n;
  cand += s * 3 * (size_t)nc * n;
  scal += s * 8;
  const int lo = rank * per_cta;
  const int hi = min(n, lo + per_cta);
  const float kth = static_cast<float>(scal[0]);
  const float maxd2 = static_cast<float>(scal[1]);
  const float* qx = q;
  const float* qy = q + n;
  const float* qz = q + 2 * (size_t)n;
  const size_t plane = (size_t)nc * n;
  double* part0 = cluster.map_shared_rank(&sh.part[0][0], 0);

  if (tid == 0) {
    for (int i = 0; i < 9; ++i) g.R[i] = (i % 4 == 0) ? 1.0 : 0.0;
    g.t[0] = g.t[1] = g.t[2] = 0.0;
    g.conv = g.stale = g.ncorr = g.rms = g.iters = 0.0;
  }
  // every CTA of the cluster runs, with its state set, before any access to
  // another CTA's shared memory
  cluster.sync();

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

    for (int i = lo + tid; i < hi; i += kThreads) {
      const float x = qx[i], y = qy[i], z = qz[i];
      const float wx = r00 * x + r01 * y + r02 * z + t0;
      const float wy = r10 * x + r11 * y + r12 * z + t1;
      const float wz = r20 * x + r21 * y + r22 * z + t2;
      float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll 4
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

    // this CTA's sums, into rank 0's slot for this rank
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const double v = warp_sum(acc[k]);
      if (lane == 0) sh.warp_part[warp][k] = v;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        const double v = warp_sum(lane < kWarps ? sh.warp_part[lane][k] : 0.0);
        if (lane == 0) part0[rank * kSums + k] = v;
      }
    }
    cluster.sync();  // rank 0 holds the cluster's partials

    if (rank == 0) {
      if (tid < kSums) {
        double v = 0.0;
        for (int r = 0; r < csize; ++r) v += sh.part[r][tid];  // rank order
        sh.tot[tid] = v;
      }
      __syncthreads();
      if (tid == 0) gn_update(sh.tot, g, scal[3], scal[4], scal[2], scal[5]);
      __syncthreads();
      const double* words = reinterpret_cast<const double*>(&g);
      for (int x = tid; x < (csize - 1) * kStateWords; x += kThreads) {
        const int r = 1 + x / kStateWords, w = x % kStateWords;
        cluster.map_shared_rank(reinterpret_cast<double*>(&g), r)[w] = words[w];
      }
    }
    cluster.sync();  // every rank holds the new state
  }

  if (rank == 0 && tid == 0) {
    double* o = out + s * 16;
    if (carry != nullptr) {
      // de-centre: T_world = Trans(a) T_centred Trans(-a), so
      // t_world = t + (I - R) a; then compose with the carried pose
      const double* Rc = carry + s * 15;
      const double* tc = Rc + 9;
      const double* an = Rc + 12;
      for (int i = 0; i < 3; ++i) {
        double twd = g.t[i];
        for (int j = 0; j < 3; ++j) twd += ((i == j ? 1.0 : 0.0) - g.R[3 * i + j]) * an[j];
        for (int j = 0; j < 3; ++j)
          o[3 * i + j] = g.R[3 * i] * Rc[j] + g.R[3 * i + 1] * Rc[3 + j] +
                         g.R[3 * i + 2] * Rc[6 + j];
        o[9 + i] = g.R[3 * i] * tc[0] + g.R[3 * i + 1] * tc[1] +
                   g.R[3 * i + 2] * tc[2] + twd;
      }
    } else {
      for (int i = 0; i < 9; ++i) o[i] = g.R[i];
      for (int i = 0; i < 3; ++i) o[9 + i] = g.t[i];
    }
    o[12] = g.ncorr;
    o[13] = g.rms;
    o[14] = g.iters;
    o[15] = g.conv + 2.0 * g.stale;
  }
}

cudaLaunchConfig_t cluster_config(int ctas, int clusters, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Allow clusters above the portable 8 CTAs, then report how many clusters
// of `clusters` CTAs can be resident at once (0: the shape cannot launch).
extern "C" int lis_gn_cluster_check(int clusters, int* max_active) {
  cudaError_t e = cudaFuncSetAttribute(gn_cluster_kernel,
                                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(clusters, clusters, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(max_active, gn_cluster_kernel, &cfg);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// K1 (carry, streams = 1), K4 (no carry, streams = 1), K5 (no carry):
// streams x clusters CTAs in clusters of `clusters`, per_cta queries each.
extern "C" int lis_fused_gn(void* q, void* qmask, void* cand, void* scal, void* carry,
                            int n, int nc, int n_inner, int streams, int clusters,
                            int per_cta, void* out, void* stream) {
  // rank 0 keeps kMaxCluster partials, and the slices must cover the queries
  if (clusters < 1 || clusters > kMaxCluster || (long long)clusters * per_cta < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(streams * clusters, clusters,
                                                static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel, static_cast<const float*>(q),
      static_cast<const float*>(qmask), static_cast<const float*>(cand),
      static_cast<const double*>(scal), static_cast<const double*>(carry), n, nc, n_inner,
      per_cta, static_cast<double*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
