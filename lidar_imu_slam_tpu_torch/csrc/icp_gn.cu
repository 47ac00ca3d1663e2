// Fused robust Gauss-Newton ICP rounds: kernels K1 (fused_gn_carry), K4
// (fused_gn) and K5 (fused_gn_batched): one cluster kernel for all three,
// and a kernel that spreads one large stream over several clusters.
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
// solve + two cluster barriers), a few microseconds each. At the dense
// shape (16,384 x 80: 15.7 MB of candidates) one cluster of 16 SMs spends
// most of a launch on those reads, so there a stream spreads over G
// clusters, each CTA's slice held in shared memory.
//
// Design, one cluster a stream (gn_cluster_kernel; K5 always, K1 / K4
// where ops/kernels/icp_gn.py:spread_shape gives G = 1, as at 4096 x 80):
// each stream is a thread-block cluster of C CTAs (grid S x C, cluster
// dims (C, 1, 1); C and the queries per CTA come from
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
// Design, G clusters a stream (gn_spread_kernel; one stream, G >= 2):
// G x C CTAs in clusters of C. CTA b of the grid takes the whole warps of
// queries [b * W / K, (b + 1) * W / K) (W = ceil(N / 32) warps, K = G x C
// CTAs; none empty), 128-160 queries a CTA at the dense shape. Two
// threads share a query, each scanning half of its slots (a CTA has two
// threads a query of its slice, at most kSpreadThreads); a shuffle keeps
// the lower half's minimum on a tie, so the first slot still wins. When
// the CTA's slice fits (kResident: 3 x NC x 128 f32 = 120 KB at 80 slots)
// it is copied into dynamic shared memory once, before iteration 0, by
// cp.async (16-byte chunks when N % 4 == 0, else 4-byte words), row by
// row, the second half's rows 16 floats on so that the two threads of a
// query read different banks; later iterations read only shared memory.
// Otherwise the slots are read from global memory / L2 as above. Per
// iteration each cluster reduces into its rank 0 as above; rank 0 writes
// the cluster's 18 f64 to a global slot (iteration, cluster) and arrives
// at a G-party barrier: a per-launch counter in global memory, a release
// add after __threadfence(), acquire loads until it reaches G x
// (iteration + 1). Then every rank 0 loads the G slots at once (through
// L2, never a stale L1 line), adds them in cluster order 0 .. G-1 and
// runs the same solve on the same bits: the states stay bit-identical in
// every cluster, with no second barrier to broadcast them. Every cluster
// therefore leaves the loop in the same iteration (one leaving early
// would hang the others at the barrier), and cluster 0's rank 0 writes the
// row. All G clusters must be resident at once, or the barrier never
// completes: the wrapper caps G at cudaOccupancyMaxActiveClusters and
// raises for a forced shape above it. The counter and the slots are
// per-launch scratch from the caller's stream, so concurrent launches
// share nothing.
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
// 16)); K1 and K4 are launches with S = 1. The spread kernel (S = 1) also
// takes scratch (1 + n_inner x G x 18,) f64, zeroed by the caller: the
// barrier's u32 counter in word 0, then the clusters' sums by (iteration,
// cluster).
//
// Built without fast math: +inf candidates, exact sqrt / sin / cos.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the spread kernel: two threads a query, up to 224 queries a pass (the
// largest resident slice at 80 slots)
constexpr int kSpreadThreads = 448;
constexpr int kSpreadWarps = kSpreadThreads / 32;
constexpr int kSums = 18;
constexpr int kMaxCluster = 16;  // MAX_CLUSTER in ops/kernels/icp_gn.py
constexpr int kMaxGroups = 32;   // MAX_GROUPS in ops/kernels/icp_gn.py

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

// Per-CTA workspace of the GN loop (kW warps).
template <int kW>
struct GnShared {
  double warp_part[kW][kSums];
  double part[kMaxCluster][kSums];  // rank 0: the cluster's CTA sums, by rank
  double tot[kSums];
  GnState g;
};

__device__ __forceinline__ void identity_state(GnState& g) {
  for (int i = 0; i < 9; ++i) g.R[i] = (i % 4 == 0) ? 1.0 : 0.0;
  g.t[0] = g.t[1] = g.t[2] = 0.0;
  g.conv = g.stale = g.ncorr = g.rms = g.iters = 0.0;
}

// One correspondence's 18 weighted sums (f32 residual and weight, f64 sums).
__device__ __forceinline__ void accumulate(double* acc, float wx, float wy, float wz, float bx,
                                           float by, float bz, float best, float kth) {
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

// This CTA's sums (every thread's acc; `warps` warps) into rank 0's slot
// for this rank.
template <int kW>
__device__ __forceinline__ void cta_sums_to_rank0(const double* acc, GnShared<kW>& sh,
                                                  double* part0, int rank, int lane, int warp,
                                                  int warps) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    const double v = warp_sum(acc[k]);
    if (lane == 0) sh.warp_part[warp][k] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const double v = warp_sum(lane < warps ? sh.warp_part[lane][k] : 0.0);
      if (lane == 0) part0[rank * kSums + k] = v;
    }
  }
}

// Rank 0 (`threads` threads): the new state into every other rank's shared
// memory.
__device__ __forceinline__ void broadcast_state(const cg::cluster_group& cluster, GnState& g,
                                                int csize, int tid, int threads) {
  const double* words = reinterpret_cast<const double*>(&g);
  for (int x = tid; x < (csize - 1) * kStateWords; x += threads) {
    const int r = 1 + x / kStateWords, w = x % kStateWords;
    cluster.map_shared_rank(reinterpret_cast<double*>(&g), r)[w] = words[w];
  }
}

// The row (16,): with a carry (K1), the correction de-centred and composed
// with the carried pose; without one (K4 / K5), the centred correction.
__device__ __forceinline__ void write_row(const GnState& g, const double* carry, double* o) {
  if (carry != nullptr) {
    // de-centre: T_world = Trans(a) T_centred Trans(-a), so
    // t_world = t + (I - R) a; then compose with the carried pose
    const double* Rc = carry;
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

// One stream per cluster (see the header comment): n_inner robust GN
// iterations over the stream's queries, CTA rank r on its slice; rank 0
// solves and writes the row (K1's carry epilogue when carry is not null).
__global__ void __launch_bounds__(kThreads)
gn_cluster_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                  const float* __restrict__ cand, const double* __restrict__ scal,
                  const double* __restrict__ carry, int n, int nc, int n_inner,
                  int per_cta, double* __restrict__ out) {
  __shared__ GnShared<kWarps> sh;
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

  if (tid == 0) identity_state(g);
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
      if (qmask[i] > 0.5f && best < maxd2) accumulate(acc, wx, wy, wz, bx, by, bz, best, kth);
    }

    cta_sums_to_rank0(acc, sh, part0, rank, lane, warp, kWarps);
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
      broadcast_state(cluster, g, csize, tid, kThreads);
    }
    cluster.sync();  // every rank holds the new state
  }

  if (rank == 0 && tid == 0)
    write_row(g, carry == nullptr ? nullptr : carry + s * 15, out + s * 16);
}

// The resident slab's layout (see gn_spread_kernel): floats a plane, and
// the offset of slot j's row within one.
__host__ __device__ __forceinline__ size_t slab_plane(int half, int per_cta) {
  return 2 * (size_t)half * per_cta + 32;
}
__device__ __forceinline__ size_t slab_row(int j, int half, int per_cta) {
  return (size_t)j * per_cta + (j < half ? 0 : 16);
}

// Asynchronous copy of 16 or 4 bytes, global to shared (no register
// staging).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// This CTA's candidate slice into the slab (see gn_spread_kernel): row
// (plane c, slot j) is cnt contiguous floats in global and in shared
// memory, copied in chunks of kVec floats; an odd NC's pad row is +inf.
template <int kVec>
__device__ __forceinline__ void load_slab(float* slab, const float* cand, int n, int nc,
                                          int half, int per_cta, int lo, int cnt) {
  const size_t plane = (size_t)nc * n, pstride = slab_plane(half, per_cta);
  const int vec = cnt / kVec, rows = 3 * 2 * half;
  for (int x = threadIdx.x; x < rows * vec; x += blockDim.x) {
    const int row = x / vec, v = (x - row * vec) * kVec;
    const int c = row / (2 * half), j = row - c * 2 * half;
    float* dst = slab + c * pstride + slab_row(j, half, per_cta) + v;
    if (j < nc)
      cp_async<4 * kVec>(dst, cand + c * plane + (size_t)j * n + lo + v);
    else
      for (int k = 0; k < kVec; ++k) dst[k] = INFINITY;
  }
}

// The spread kernel's G-party barrier, on thread 0 of each cluster's rank
// 0 after a __syncthreads(): a release add (cumulative over the CTA's
// writes that barrier ordered before it), then acquire loads until
// `target` arrivals have been seen; a __syncthreads() after it orders the
// CTA's later loads. A barrier still open after ~2^34 SM cycles (seconds;
// a microsecond or two when all clusters are resident, as the launcher
// checks) traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void groups_barrier(unsigned* count, unsigned target) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
  const long long t0 = clock64();
  unsigned seen = 0;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(seen) : "l"(count) : "memory");
    if (seen >= target) break;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One stream over G clusters of C CTAs (see the header comment). kResident:
// the CTA's slots in dynamic shared memory, a plane per coordinate of
// slab_plane floats: half = ceil(NC / 2) rows of per_cta floats for slots
// [0, half), then, 16 floats on, the rows of slots [half, 2 half) (an odd
// NC's last one +inf, never nearer). The two threads of a query read the
// same row offset in the two halves, 16 banks apart: no bank conflict.
template <bool kResident>
__global__ void __launch_bounds__(kSpreadThreads)
gn_spread_kernel(const float* __restrict__ q, const float* __restrict__ qmask,
                 const float* __restrict__ cand, const double* __restrict__ scal,
                 const double* __restrict__ carry, int n, int nc, int n_inner, int per_cta,
                 double* __restrict__ scratch, double* __restrict__ out) {
  __shared__ GnShared<kSpreadWarps> sh;
  __shared__ double group_part[kMaxGroups * kSums];  // rank 0: the G clusters' sums
  extern __shared__ __align__(16) float slab[];
  GnState& g = sh.g;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int groups = static_cast<int>(gridDim.x) / csize;
  const int group = static_cast<int>(blockIdx.x) / csize;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, pairs = threads / 2;
  const int h = tid & 1;  // this thread's half of the slots
  const int half = (nc + 1) / 2;
  const long long warps = (n + 31) / 32, ctas = gridDim.x;
  const int lo = static_cast<int>(blockIdx.x * warps / ctas) * 32;
  const int hi = min(n, static_cast<int>((blockIdx.x + 1) * warps / ctas) * 32);
  const int cnt = hi - lo;  // >= 1: the launcher keeps K <= W
  const float kth = static_cast<float>(scal[0]);
  const float maxd2 = static_cast<float>(scal[1]);
  const size_t plane = (size_t)nc * n, pstride = slab_plane(half, per_cta);
  unsigned* count = reinterpret_cast<unsigned*>(scratch);
  double* slots = scratch + 1;
  double* part0 = cluster.map_shared_rank(&sh.part[0][0], 0);

  if (kResident) {
    // 16-byte chunks when every row starts on 16 bytes (N % 4 == 0: lo is a
    // multiple of 32 and cnt of 4)
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(cand) & 15) == 0)
      load_slab<4>(slab, cand, n, nc, half, per_cta, lo, cnt);
    else
      load_slab<1>(slab, cand, n, nc, half, per_cta, lo, cnt);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  if (tid == 0) identity_state(g);
  // every CTA of the cluster runs, with its state (and slots) set, before
  // any access to another CTA's shared memory
  cluster.sync();

  for (int it = 0; it < n_inner; ++it) {
    // a frozen state changes nothing further; every cluster holds the same
    // state, so all of them leave in the same iteration
    if (g.conv >= 0.5 || g.stale >= 0.5) break;
    const float r00 = (float)g.R[0], r01 = (float)g.R[1], r02 = (float)g.R[2];
    const float r10 = (float)g.R[3], r11 = (float)g.R[4], r12 = (float)g.R[5];
    const float r20 = (float)g.R[6], r21 = (float)g.R[7], r22 = (float)g.R[8];
    const float t0 = (float)g.t[0], t1 = (float)g.t[1], t2 = (float)g.t[2];

    double acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

    // a pass takes a query a thread pair (one pass up to 224 queries);
    // every thread runs every pass (the shuffle needs the whole warp), and
    // a pair past the slice's end repeats its last query without adding it
    for (int base = 0; base < cnt; base += pairs) {
      const bool live = base + (tid >> 1) < cnt;
      const int li = min(base + (tid >> 1), cnt - 1);
      const int i = lo + li;
      const float x = q[i], y = q[n + i], z = q[2 * (size_t)n + i];
      const float wx = r00 * x + r01 * y + r02 * z + t0;
      const float wy = r10 * x + r11 * y + r12 * z + t1;
      const float wz = r20 * x + r21 * y + r22 * z + t2;
      float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
      if (kResident) {
        const float* mine = slab + slab_row(h * half, half, per_cta) + li;
#pragma unroll 4
        for (int j2 = 0; j2 < half; ++j2) {
          const size_t o = (size_t)j2 * per_cta;
          const float cx = mine[o], cy = mine[pstride + o], cz = mine[2 * pstride + o];
          const float dx = cx - wx, dy = cy - wy, dz = cz - wz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < best) { best = d2; bx = cx; by = cy; bz = cz; }
        }
      } else {
        const int j1 = min(nc, (h + 1) * half);
#pragma unroll 4
        for (int j = h * half; j < j1; ++j) {
          const size_t o = (size_t)j * n + i;
          const float cx = cand[o], cy = cand[plane + o], cz = cand[2 * plane + o];
          const float dx = cx - wx, dy = cy - wy, dz = cz - wz;
          const float d2 = dx * dx + dy * dy + dz * dz;
          if (d2 < best) { best = d2; bx = cx; by = cy; bz = cz; }
        }
      }
      // the pair's halves: half 0 holds the lower slots and keeps its own
      // minimum unless half 1's is strictly smaller (the first slot wins)
      const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
      const float ox = __shfl_xor_sync(0xffffffffu, bx, 1);
      const float oy = __shfl_xor_sync(0xffffffffu, by, 1);
      const float oz = __shfl_xor_sync(0xffffffffu, bz, 1);
      if (ob < best) { best = ob; bx = ox; by = oy; bz = oz; }
      if (h == 0 && live && qmask[i] > 0.5f && best < maxd2)
        accumulate(acc, wx, wy, wz, bx, by, bz, best, kth);
    }

    cta_sums_to_rank0(acc, sh, part0, rank, lane, warp, threads / 32);
    cluster.sync();  // rank 0 holds the cluster's partials

    if (rank == 0) {
      double* slot = slots + (size_t)it * groups * kSums;
      if (tid < kSums) {
        double v = 0.0;
        for (int r = 0; r < csize; ++r) v += sh.part[r][tid];  // rank order
        slot[group * kSums + tid] = v;
      }
      __syncthreads();
      if (tid == 0) groups_barrier(count, static_cast<unsigned>(groups) * (it + 1));
      __syncthreads();
      // the G clusters' sums in one round of loads through L2, then added
      // in cluster order
      for (int x = tid; x < groups * kSums; x += threads) group_part[x] = __ldcg(slot + x);
      __syncthreads();
      if (tid < kSums) {
        double v = 0.0;
        for (int c = 0; c < groups; ++c) v += group_part[c * kSums + tid];  // cluster order
        sh.tot[tid] = v;
      }
      __syncthreads();
      if (tid == 0) gn_update(sh.tot, g, scal[3], scal[4], scal[2], scal[5]);
      __syncthreads();
      broadcast_state(cluster, g, csize, tid, threads);
    }
    cluster.sync();  // every rank holds the new state
  }

  if (group == 0 && rank == 0 && tid == 0) write_row(g, carry, out);
}

using SpreadKernel = void (*)(const float*, const float*, const float*, const double*,
                              const double*, int, int, int, int, double*, double*);

cudaLaunchConfig_t cluster_config(int ctas, int clusters, cudaStream_t stream,
                                  cudaLaunchAttribute* attr, size_t smem = 0,
                                  int threads = kThreads) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The spread kernel's threads: a pair a query, up to kSpreadThreads.
int spread_threads(int per_cta) { return 2 * std::min(per_cta, kSpreadThreads / 2); }

// Dynamic shared memory of a resident slice of per_cta queries x NC slots
// (slab_bytes in ops/kernels/icp_gn.py).
size_t slab_bytes(int nc, int per_cta) {
  return sizeof(float) * 3 * slab_plane((nc + 1) / 2, per_cta);
}

// The spread kernel's attributes, once per device (idempotent, so a race
// is benign): clusters above 8 CTAs, and the resident variant's dynamic
// shared memory up to what a block may opt into beside its static
// workspace (`budget`).
cudaError_t spread_attributes(int* budget) {
  static unsigned long long done = 0;  // a bit per device
  static int budgets[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ((done >> dev) & 1ull)) {
    *budget = budgets[dev];
    return cudaSuccess;
  }
  int optin = 0;
  cudaFuncAttributes fa;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, gn_spread_kernel<true>);
  if (e != cudaSuccess) return e;
  *budget = optin - static_cast<int>(fa.sharedSizeBytes);
  e = cudaFuncSetAttribute(gn_spread_kernel<true>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gn_spread_kernel<false>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gn_spread_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *budget);
  if (e == cudaSuccess && dev < 64) {
    budgets[dev] = *budget;
    done |= 1ull << dev;
  }
  return e;
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

// The spread kernel's dynamic shared memory budget a CTA (`budget`), and
// how many clusters of `clusters` CTAs of it can be resident at once at
// per_cta queries a CTA x NC slots, the resident variant or the other;
// per_cta = 0: the most a CTA can take (kSpreadThreads threads, and the
// whole budget when resident).
extern "C" int lis_gn_spread_check(int clusters, int nc, int per_cta, int resident,
                                   int* max_active, int* budget) {
  cudaError_t e = spread_attributes(budget);
  if (e == cudaSuccess) {
    const size_t smem = !resident ? 0 : per_cta == 0 ? *budget : slab_bytes(nc, per_cta);
    const int threads = per_cta == 0 ? kSpreadThreads : spread_threads(per_cta);
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(clusters, clusters, nullptr, &attr, smem, threads);
    const SpreadKernel kernel = resident ? &gn_spread_kernel<true> : &gn_spread_kernel<false>;
    e = cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
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

// K1 (carry) or K4 (no carry) of one stream over `groups` clusters of
// `clusters` CTAs, at most per_cta queries a CTA; scratch as the header's
// layout says. The caller has checked that all groups clusters can be
// resident at once.
extern "C" int lis_fused_gn_spread(void* q, void* qmask, void* cand, void* scal, void* carry,
                                   int n, int nc, int n_inner, int groups, int clusters,
                                   int per_cta, int resident, void* scratch, void* out,
                                   void* stream) {
  const long long warps = (n + 31) / 32, ctas = (long long)groups * clusters;
  // no CTA without queries, none above per_cta; rank 0 keeps kMaxGroups sums
  if (n < 1 || nc < 1 || groups < 1 || groups > kMaxGroups || clusters < 1 ||
      clusters > kMaxCluster || ctas > warps || (warps + ctas - 1) / ctas * 32 > per_cta)
    return static_cast<int>(cudaErrorInvalidValue);
  int budget = 0;
  cudaError_t e = spread_attributes(&budget);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = resident ? slab_bytes(nc, per_cta) : 0;
  if (smem > static_cast<size_t>(budget)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(static_cast<int>(ctas), clusters, static_cast<cudaStream_t>(stream), &attr,
                     smem, spread_threads(per_cta));
  const SpreadKernel kernel = resident ? &gn_spread_kernel<true> : &gn_spread_kernel<false>;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(q),
                         static_cast<const float*>(qmask), static_cast<const float*>(cand),
                         static_cast<const double*>(scal), static_cast<const double*>(carry), n,
                         nc, n_inner, per_cta, static_cast<double*>(scratch),
                         static_cast<double*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
