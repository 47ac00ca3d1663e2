// The measurement probes P1-P4: two gathers (take_rows, take_lanes) and an
// f32 fused Gauss-Newton prototype (gn_proto).
//
// Replaces: the JAX package's tools/ probes, Pallas kernels that ask what
// Mosaic lowers and at what cost on a TPU:
//   * take_rows  <- tools/exp_pallas.py:run_take (body k_take, jnp.take of
//                   table rows) and tools/exp_gather2.py:probe (bodies k_taa,
//                   take_along_axis on axis 0, and k_i32, the i32 table with
//                   an in-kernel broadcast of an (N, 1) index);
//   * take_lanes <- tools/exp_pallas.py:run_lane (body k_lane,
//                   take_along_axis on axis 1);
//   * gn_proto   <- tools/exp_pallas.py:run (body _gn_kernel): n_inner
//                   iterations of nearest candidate + Geman-McClure weights +
//                   16 weighted sums + unrolled 6x6 Cholesky + Rodrigues exp
//                   + left compose, all f32.
//
// What bounds them on the card: bytes, and at the probes' sizes the launch.
// take_rows at (2048, 512) with a (2048, 512) index moves 12 MB (index,
// gathered rows, output), about 3.6 us at 3.35 TB/s; at (2048, 128) by
// (2048, 1) 2 MB, 0.6 us; take_lanes 0.2 MB. The gathers are laid out for
// few, wide, independent memory operations in flight per thread:
//   * take_rows, blocks of 4 warps; each warp takes kRowsPerWarp rows at
//     once and 32 consecutive 16-byte vectors of each (grid x: vector
//     columns, grid y: row groups, sized for one wave on 132 SMs, then a
//     row-group loop). An (N, 1) index is read once per row by one lane and
//     broadcast with __shfl_sync; the rows' table loads (__ldg of float4 /
//     int4, ld.global.nc) all go out before the first streaming store
//     (__stcs), so the dependent index -> table chains of the rows overlap.
//     An (N, W) index is read as one int4 a thread, then four table loads
//     and one 16-byte store. Two-dimensional indices: no division;
//   * take_lanes, a grid of (column chunk, row): each thread loads an int4
//     of indices, reads four table entries of its row (a 32 KB row stays in
//     L1) and writes one float4.
// The launcher takes the 16-byte variant when the widths are multiples of 4
// and the pointers 16-byte aligned, else the scalar variant of the same
// kernel (one element per load).
//
// gn_proto reads its 3.9 MB of candidates (4096 queries x 80 slots) once
// per iteration, from L2 after the first: the byte bound (every input once)
// is 1.2 us, but one SM draws only ~100 GB/s from L2, so a single block
// spends ~40 us an iteration on those reads. The design spreads the queries
// over a thread-block cluster, as K1 / K4 / K5 do (icp_gn.cu): C CTAs of
// kGnThreads = 256 (C and the queries per CTA from the wrapper, K1's rule:
// min(16, ceil(N * NC / (256 * 80))), 16 at the probe's shape; cluster
// dims (C, 1, 1), a non-portable size above 8). CTA rank r takes queries
// [r * per_cta, (r + 1) * per_cta). Per iteration each CTA reduces its 17
// f32 sums (warp shuffles, then one warp over the 8 per-warp partials) and
// writes them into rank 0's shared memory through distributed shared
// memory. After a cluster barrier, rank 0 adds the C partials in rank
// order (repeated launches give bit-equal outputs), solves, exponentiates
// and composes on one thread (gn_proto_update) and writes the 13-float
// carry into every rank; a second barrier releases the cluster. All
// n_inner iterations run, as in the JAX kernel: a converged carry freezes
// the pose but does not leave the loop. A CTA's candidates (245 KB at 256
// queries x 80 slots) do not fit in shared memory, but its first 64 slots
// do (196,608 bytes of dynamic shared memory): the CTA copies them in
// once, with 16-byte loads, before the first iteration, so every
// iteration reads only the other 16 slots from L2.
//
// Rounding: every f32 step of gn_proto's per-query work and of the solve is
// rounded as written (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn: no FMA contraction), in the JAX kernel's operation order, so
// the kernel differs from the plain PyTorch version only by the order of
// the 17 cluster sums. Indices of the gathers are clamped into range (the
// probes' indices are in range; the plain versions clamp the same way).
//
// Layouts: take_rows table (C, W), idx (N, W) or (N, 1) (idx_cols = W or
// 1), out (N, W); take_lanes table (R, C), idx (R, N), out (R, N), idx i32.
// gn_proto q (3, NQ) f32, qm (NQ,) bool as bytes, cand (3, NC, NQ) f32,
// scal (2,) f32 = [kth, maxd2], out (13,) f32 = [R row-major 9, t 3, conv].

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowThreads = 128;  // take_rows: 4 warps a block
constexpr int kRowsPerWarp = 4;    // rows a warp has in flight
constexpr int kRowsPerBlock = kRowThreads / 32 * kRowsPerWarp;
constexpr int kLaneThreads = 128;  // take_lanes
constexpr long long kWaveBlocks = 132LL * 16;  // 128-thread blocks: 2048 threads on each of 132 SMs
constexpr int kGnThreads = 256;
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kGnMaxCluster = 16;  // MAX_CLUSTER in ops/kernels/icp_gn.py
constexpr int kSums = 17;  // 16 weighted sums + the correspondence count
constexpr int kCarry = 13;  // R 9 | t 3 | conv
// dynamic shared memory of a gn_proto CTA: 64 candidate slots of 256
// queries (the rule's CTA), 196,608 bytes
constexpr int kGnResidentFloats = 3 * 64 * kGnThreads;
constexpr size_t kGnResidentBytes = kGnResidentFloats * sizeof(float);
constexpr int kGnAhead = 16;  // global candidate slots loaded ahead of the shared-memory pass

template <typename T, int VEC> struct VecOf { using type = T; };
template <> struct VecOf<float, 4> { using type = float4; };
template <> struct VecOf<int, 4> { using type = int4; };

__device__ __forceinline__ float4 make4(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ int4 make4(int a, int b, int c, int d) { return make_int4(a, b, c, d); }

__device__ __forceinline__ int clamp_row(int r, int c) { return min(max(r, 0), c - 1); }

// out[i, j] = table[clamp(idx[i, j or 0]), j] over VEC-wide vectors of a
// row: w % VEC == 0, and with VEC = 4 table / out (and an (N, W) idx)
// 16-byte aligned. BCAST: idx is (N, 1).
template <typename T, int VEC, bool BCAST>
__global__ void __launch_bounds__(kRowThreads)
take_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx, int c, int w, int n,
                 T* __restrict__ out) {
  using V = typename VecOf<T, VEC>::type;
  const int lane = threadIdx.x & 31;
  const int wv = w / VEC;                   // vectors a row
  const int col = blockIdx.x * 32 + lane;  // this lane's vector column
  const bool on = col < wv;
  const V* tab = reinterpret_cast<const V*>(table);
  V* dst = reinterpret_cast<V*>(out);
  const int step = gridDim.y * kRowsPerBlock;
  for (int row0 = blockIdx.y * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp; row0 < n;
       row0 += step) {
    V v[kRowsPerWarp];
    if constexpr (BCAST) {
      int mine = 0;  // lane u < kRowsPerWarp reads row row0 + u's index
      if (lane < kRowsPerWarp && row0 + lane < n) mine = clamp_row(__ldg(idx + row0 + lane), c);
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const int r = __shfl_sync(0xffffffffu, mine, u);
        if (on && row0 + u < n) v[u] = __ldg(tab + (size_t)r * wv + col);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        if (!on || row0 + u >= n) continue;
        const int j = col * VEC;                          // first column
        const size_t e = (size_t)(row0 + u) * w + j;       // first element
        if constexpr (VEC == 4) {
          const int4 r = __ldg(reinterpret_cast<const int4*>(idx + e));
          v[u] = make4(__ldg(table + (size_t)clamp_row(r.x, c) * w + j),
                       __ldg(table + (size_t)clamp_row(r.y, c) * w + j + 1),
                       __ldg(table + (size_t)clamp_row(r.z, c) * w + j + 2),
                       __ldg(table + (size_t)clamp_row(r.w, c) * w + j + 3));
        } else {
          v[u] = __ldg(table + (size_t)clamp_row(__ldg(idx + e), c) * w + j);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u)
      if (on && row0 + u < n) __stcs(dst + (size_t)(row0 + u) * wv + col, v[u]);
  }
}

// out[r, j] = table[r, clamp(idx[r, j])] over VEC consecutive columns a
// thread: n % VEC == 0, and with VEC = 4 idx / out 16-byte aligned
template <int VEC>
__global__ void __launch_bounds__(kLaneThreads)
take_lanes_kernel(const float* __restrict__ table, const int* __restrict__ idx, int rows, int c,
                  int n, float* __restrict__ out) {
  const int j = (blockIdx.x * kLaneThreads + threadIdx.x) * VEC;
  if (j >= n) return;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* row = table + (size_t)r * c;
    const size_t e = (size_t)r * n + j;
    if constexpr (VEC == 4) {
      const int4 k = __ldg(reinterpret_cast<const int4*>(idx + e));
      __stcs(reinterpret_cast<float4*>(out + e),
             make_float4(__ldg(row + clamp_row(k.x, c)), __ldg(row + clamp_row(k.y, c)),
                         __ldg(row + clamp_row(k.z, c)), __ldg(row + clamp_row(k.w, c))));
    } else {
      __stcs(out + e, __ldg(row + clamp_row(__ldg(idx + e), c)));
    }
  }
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
// jnp.maximum / torch.maximum: NaN if either side is NaN
__device__ __forceinline__ float maxn(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// thread 0: one GN update from the 17 sums; c = the 13-float carry
// [R 9 | t 3 | conv], updated in place (exp_pallas.py:164-260)
__device__ void gn_proto_update(const float* s, float* c) {
  const float sw = s[0], Sx = s[1], Sy = s[2], Sz = s[3];
  const float sxx = s[4], syy = s[5], szz = s[6], sxy = s[7], sxz = s[8], syz = s[9];
  const float trx = s[10], try_ = s[11], trz = s[12];
  const float bxs = s[13], bys = s[14], bzs = s[15], ncorr = s[16];
  const float A[6][6] = {
      {sw, 0.f, 0.f, 0.f, Sz, -Sy},
      {0.f, sw, 0.f, -Sz, 0.f, Sx},
      {0.f, 0.f, sw, Sy, -Sx, 0.f},
      {0.f, -Sz, Sy, add(syy, szz), -sxy, -sxz},
      {Sz, 0.f, -Sx, -sxy, add(sxx, szz), -syz},
      {-Sy, Sx, 0.f, -sxz, -syz, add(sxx, syy)},
  };
  const float b[6] = {-trx, -try_, -trz, -bxs, -bys, -bzs};
  const float dmax = maxn(maxn(maxn(A[0][0], A[3][3]), maxn(A[4][4], A[5][5])), 1.f);
  const float ridge = mul((float)1e-7, dmax);
  float L[6][6];
#pragma unroll
  for (int jj = 0; jj < 6; ++jj) {
    float d = add(A[jj][jj], ridge);
#pragma unroll
    for (int kk = 0; kk < jj; ++kk) d = sub(d, mul(L[jj][kk], L[jj][kk]));
    L[jj][jj] = __fsqrt_rn(maxn(d, (float)1e-20));
    const float inv = dv(1.f, L[jj][jj]);
#pragma unroll
    for (int ii = jj + 1; ii < 6; ++ii) {
      float t = A[ii][jj];
#pragma unroll
      for (int kk = 0; kk < jj; ++kk) t = sub(t, mul(L[ii][kk], L[jj][kk]));
      L[ii][jj] = mul(t, inv);
    }
  }
  float y[6], xi[6];
#pragma unroll
  for (int ii = 0; ii < 6; ++ii) {
    float acc = b[ii];
#pragma unroll
    for (int kk = 0; kk < ii; ++kk) acc = sub(acc, mul(L[ii][kk], y[kk]));
    y[ii] = dv(acc, L[ii][ii]);
  }
#pragma unroll
  for (int ii = 5; ii >= 0; --ii) {
    float acc = y[ii];
#pragma unroll
    for (int kk = ii + 1; kk < 6; ++kk) acc = sub(acc, mul(L[kk][ii], xi[kk]));
    xi[ii] = dv(acc, L[ii][ii]);
  }

  float vx = xi[0], vy = xi[1], vz = xi[2], ox = xi[3], oy = xi[4], oz = xi[5];
  const bool ok = ncorr >= 20.f;
  const float step2 = add(add(add(add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz)), mul(ox, ox)),
                              mul(oy, oy)),
                          mul(oz, oz));
  const float conv = c[12];
  const float scale = (ok && conv < 0.5f) ? 1.f : 0.f;
  vx = mul(vx, scale); vy = mul(vy, scale); vz = mul(vz, scale);
  ox = mul(ox, scale); oy = mul(oy, scale); oz = mul(oz, scale);

  // Rodrigues (f32): R = I + a W + b2 W^2, left Jacobian with (b2, c3)
  const float sq = add(add(mul(ox, ox), mul(oy, oy)), mul(oz, oz));
  const float sqc = maxn(sq, (float)1e-30);
  const float th = __fsqrt_rn(sqc);
  const bool small = sq < (float)1e-12;
  const float a = small ? sub(1.f, dv(sq, 6.f)) : dv(sinf(th), th);
  const float b2 = small ? sub(0.5f, dv(sq, 24.f)) : dv(sub(1.f, cosf(th)), sqc);
  const float c3 = small ? (float)(1.0 / 6.0) : dv(sub(1.f, a), sqc);
  const float e00 = add(1.f, mul(b2, sub(mul(ox, ox), sq)));
  const float e01 = add(mul(a, -oz), mul(mul(b2, ox), oy));
  const float e02 = add(mul(a, oy), mul(mul(b2, ox), oz));
  const float e10 = add(mul(a, oz), mul(mul(b2, ox), oy));
  const float e11 = add(1.f, mul(b2, sub(mul(oy, oy), sq)));
  const float e12 = add(mul(a, -ox), mul(mul(b2, oy), oz));
  const float e20 = add(mul(a, -oy), mul(mul(b2, ox), oz));
  const float e21 = add(mul(a, ox), mul(mul(b2, oy), oz));
  const float e22 = add(1.f, mul(b2, sub(mul(oz, oz), sq)));
  const float v00 = add(1.f, mul(c3, sub(mul(ox, ox), sq)));
  const float v01 = add(mul(b2, -oz), mul(mul(c3, ox), oy));
  const float v02 = add(mul(b2, oy), mul(mul(c3, ox), oz));
  const float v10 = add(mul(b2, oz), mul(mul(c3, ox), oy));
  const float v11 = add(1.f, mul(c3, sub(mul(oy, oy), sq)));
  const float v12 = add(mul(b2, -ox), mul(mul(c3, oy), oz));
  const float v20 = add(mul(b2, -oy), mul(mul(c3, ox), oz));
  const float v21 = add(mul(b2, ox), mul(mul(c3, oy), oz));
  const float v22 = add(1.f, mul(c3, sub(mul(oz, oz), sq)));
  const float dt0 = add(add(mul(v00, vx), mul(v01, vy)), mul(v02, vz));
  const float dt1 = add(add(mul(v10, vx), mul(v11, vy)), mul(v12, vz));
  const float dt2 = add(add(mul(v20, vx), mul(v21, vy)), mul(v22, vz));

  // compose: new = E @ old
  const float E[3][3] = {{e00, e01, e02}, {e10, e11, e12}, {e20, e21, e22}};
  const float dt[3] = {dt0, dt1, dt2};
  float n[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      n[3 * i + j] = add(add(mul(E[i][0], c[j]), mul(E[i][1], c[3 + j])), mul(E[i][2], c[6 + j]));
    n[9 + i] = add(add(add(mul(E[i][0], c[9]), mul(E[i][1], c[10])), mul(E[i][2], c[11])), dt[i]);
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) c[k] = n[k];
  c[12] = (!ok || __fsqrt_rn(step2) < (float)5e-4) ? 1.f : conv;
}

// Per-CTA workspace of the GN loop.
struct ProtoShared {
  float warp_part[kGnWarps][kSums];
  float part[kGnMaxCluster][kSums];  // rank 0: the cluster's CTA sums, by rank
  float tot[kSums];
  float carry[kCarry];
};

// One cluster (see the header comment): n_inner f32 GN iterations, CTA rank
// r on its slice of the queries; rank 0 solves and writes the carry.
__global__ void __launch_bounds__(kGnThreads)
gn_proto_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qm,
                const float* __restrict__ cand, const float* __restrict__ scal, int nq, int nc,
                int n_inner, int per_cta, float* __restrict__ out) {
  __shared__ ProtoShared sh;
  extern __shared__ __align__(16) float resident[];  // (3, res, per_cta): the first res slots
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float kth = scal[0], maxd2 = scal[1];
  const size_t plane = (size_t)nc * nq;
  const int lo = rank * per_cta;
  const int hi = min(nq, lo + per_cta);
  const int res = min(nc, kGnResidentFloats / (3 * per_cta));
  float* part0 = cluster.map_shared_rank(&sh.part[0][0], 0);
  float* carry = sh.carry;
  if (tid < kCarry) carry[tid] = (tid == 0 || tid == 4 || tid == 8) ? 1.f : 0.f;
  // this CTA's first res slots into shared memory, (3, res, per_cta): rows
  // of hi - lo contiguous floats, 16-byte loads when every row is aligned
  const int cnt = hi - lo;
  if ((nq & 3) == 0 && (reinterpret_cast<uintptr_t>(cand) & 15) == 0) {
    const int vec = cnt >> 2;  // cnt % 4 == 0: lo is a multiple of 32, hi of 4
#pragma unroll 8
    for (int x = tid; x < 3 * res * vec; x += kGnThreads) {
      const int row = x / vec, v = x - row * vec;  // row = plane * res + slot
      const float* src = cand + (size_t)(row / res) * plane + (size_t)(row % res) * nq + lo;
      reinterpret_cast<float4*>(resident + (size_t)row * per_cta)[v] =
          __ldg(reinterpret_cast<const float4*>(src) + v);
    }
  } else {
    for (int x = tid; x < 3 * res * cnt; x += kGnThreads) {
      const int row = x / cnt, v = x - row * cnt;
      resident[(size_t)row * per_cta + v] =
          cand[(size_t)(row / res) * plane + (size_t)(row % res) * nq + lo + v];
    }
  }
  // every CTA of the cluster runs, with its carry and candidates set, before
  // any access to another CTA's shared memory
  cluster.sync();
  for (int it = 0; it < n_inner; ++it) {
    const float r00 = carry[0], r01 = carry[1], r02 = carry[2];
    const float r10 = carry[3], r11 = carry[4], r12 = carry[5];
    const float r20 = carry[6], r21 = carry[7], r22 = carry[8];
    const float t0 = carry[9], t1 = carry[10], t2 = carry[11];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
    for (int i = lo + tid; i < hi; i += kGnThreads) {
      const float qx = q[i], qy = q[nq + i], qz = q[2 * (size_t)nq + i];
      const float wx = add(add(add(mul(r00, qx), mul(r01, qy)), mul(r02, qz)), t0);
      const float wy = add(add(add(mul(r10, qx), mul(r11, qy)), mul(r12, qz)), t1);
      const float wz = add(add(add(mul(r20, qx), mul(r21, qy)), mul(r22, qz)), t2);
      float best = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
      const auto visit = [&](float cx, float cy, float cz) {
        const float dx = sub(cx, wx), dy = sub(cy, wy), dz = sub(cz, wz);
        const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
        if (d2 < best) {
          best = d2;
          bx = cx;
          by = cy;
          bz = cz;
        }
      };
      // slots [0, res) from shared memory, the rest from global memory / L2,
      // in slot order (the first minimum wins); the first kGnAhead global
      // slots are loaded before the shared-memory pass, which hides them
      float ax[kGnAhead], ay[kGnAhead], az[kGnAhead];
#pragma unroll
      for (int a = 0; a < kGnAhead; ++a) {
        const size_t o = (size_t)min(res + a, nc - 1) * nq + i;
        ax[a] = cand[o];
        ay[a] = cand[plane + o];
        az[a] = cand[2 * plane + o];
      }
      const float* mine = resident + (i - lo);
#pragma unroll 8
      for (int j = 0; j < res; ++j)
        visit(mine[(size_t)j * per_cta], mine[(size_t)(res + j) * per_cta],
              mine[(size_t)(2 * res + j) * per_cta]);
#pragma unroll
      for (int a = 0; a < kGnAhead; ++a)
        if (res + a < nc) visit(ax[a], ay[a], az[a]);
#pragma unroll 8
      for (int j = res + kGnAhead; j < nc; ++j) {
        const size_t o = (size_t)j * nq + i;
        visit(cand[o], cand[plane + o], cand[2 * plane + o]);
      }
      if (qm[i] && best < maxd2) {  // non-correspondences add exact zeros
        const float rx = sub(wx, bx), ry = sub(wy, by), rz = sub(wz, bz);
        const float res2 = add(add(mul(rx, rx), mul(ry, ry)), mul(rz, rz));
        const float den = add(kth, res2);
        const float w = dv(mul(kth, kth), mul(den, den));
        const float wsx = mul(w, wx), wsy = mul(w, wy), wsz = mul(w, wz);
        acc[0] = add(acc[0], w);
        acc[1] = add(acc[1], wsx);
        acc[2] = add(acc[2], wsy);
        acc[3] = add(acc[3], wsz);
        acc[4] = add(acc[4], mul(wsx, wx));
        acc[5] = add(acc[5], mul(wsy, wy));
        acc[6] = add(acc[6], mul(wsz, wz));
        acc[7] = add(acc[7], mul(wsx, wy));
        acc[8] = add(acc[8], mul(wsx, wz));
        acc[9] = add(acc[9], mul(wsy, wz));
        acc[10] = add(acc[10], mul(w, rx));
        acc[11] = add(acc[11], mul(w, ry));
        acc[12] = add(acc[12], mul(w, rz));
        acc[13] = add(acc[13], sub(mul(wsy, rz), mul(wsz, ry)));
        acc[14] = add(acc[14], sub(mul(wsz, rx), mul(wsx, rz)));
        acc[15] = add(acc[15], sub(mul(wsx, ry), mul(wsy, rx)));
        acc[16] = add(acc[16], 1.f);
      }
    }
    // this CTA's sums, into rank 0's slot for this rank
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) sh.warp_part[warp][k] = v;
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        float v = lane < kGnWarps ? sh.warp_part[lane][k] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = add(v, __shfl_down_sync(0xffffffffu, v, off));
        if (lane == 0) part0[rank * kSums + k] = v;
      }
    }
    cluster.sync();  // rank 0 holds the cluster's partials

    if (rank == 0) {
      if (tid < kSums) {
        float v = sh.part[0][tid];
        for (int r = 1; r < csize; ++r) v = add(v, sh.part[r][tid]);  // rank order
        sh.tot[tid] = v;
      }
      __syncthreads();
      if (tid == 0) gn_proto_update(sh.tot, carry);
      __syncthreads();
      for (int x = tid; x < (csize - 1) * kCarry; x += kGnThreads) {
        const int r = 1 + x / kCarry, w = x % kCarry;
        cluster.map_shared_rank(carry, r)[w] = carry[w];
      }
    }
    cluster.sync();  // every rank holds the new carry
  }
  if (rank == 0 && tid < kCarry) out[tid] = carry[tid];
}

cudaLaunchConfig_t gn_proto_config(int clusters, cudaStream_t stream,
                                   cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = clusters;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters);
  cfg.blockDim = dim3(kGnThreads);
  cfg.dynamicSmemBytes = kGnResidentBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, int VEC, bool BCAST>
void launch_rows(const void* table, const void* idx, int c, int w, int n, void* out,
                 cudaStream_t st) {
  const long long gx = (w / VEC + 31) / 32;
  const long long groups = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  long long gy = kWaveBlocks / gx;  // one wave, then the row-group loop
  gy = std::min(std::min(groups, std::max(gy, 1LL)), 65535LL);
  take_rows_kernel<T, VEC, BCAST><<<dim3((unsigned)gx, (unsigned)gy), kRowThreads, 0, st>>>(
      static_cast<const T*>(table), static_cast<const int*>(idx), c, w, n, static_cast<T*>(out));
}

template <typename T>
int launch_take_rows(const void* table, const void* idx, int c, int w, int n, int idx_cols,
                     void* out, cudaStream_t st) {
  if (n <= 0 || w <= 0) return 0;
  const bool bcast = idx_cols == 1;
  const bool vec = w % 4 == 0 && aligned16(table) && aligned16(out) && (bcast || aligned16(idx));
  if (vec && bcast) launch_rows<T, 4, true>(table, idx, c, w, n, out, st);
  else if (vec) launch_rows<T, 4, false>(table, idx, c, w, n, out, st);
  else if (bcast) launch_rows<T, 1, true>(table, idx, c, w, n, out, st);
  else launch_rows<T, 1, false>(table, idx, c, w, n, out, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

static_assert(kGnWarps <= 32, "the second reduction stage takes one partial per lane");

// out[i, j] = table[clamp(idx[i, j or 0]), j]; elem_code 0 = f32, 1 = i32
extern "C" int lis_take_rows(void* table, void* idx, int c, int w, int n, int idx_cols,
                             int elem_code, void* out, void* stream) {
  if (c <= 0 || (idx_cols != 1 && idx_cols != w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_code == 0) return launch_take_rows<float>(table, idx, c, w, n, idx_cols, out, st);
  if (elem_code == 1) return launch_take_rows<int>(table, idx, c, w, n, idx_cols, out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out[r, j] = table[r, clamp(idx[r, j])]; table (R, C) f32, idx / out (R, N)
extern "C" int lis_take_lanes(void* table, void* idx, int r, int c, int n, void* out,
                              void* stream) {
  if (r <= 0 || n <= 0) return 0;
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(idx) && aligned16(out);
  const int per_block = kLaneThreads * (vec ? 4 : 1);
  const dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)std::min(r, 65535));
  const float* t = static_cast<const float*>(table);
  const int* k = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (vec) take_lanes_kernel<4><<<grid, kLaneThreads, 0, st>>>(t, k, r, c, n, o);
  else take_lanes_kernel<1><<<grid, kLaneThreads, 0, st>>>(t, k, r, c, n, o);
  return static_cast<int>(cudaGetLastError());
}

// Allow clusters above the portable 8 CTAs and the resident candidates'
// dynamic shared memory, once per device (idempotent, so a race is benign).
static cudaError_t gn_proto_attributes() {
  static unsigned long long done = 0;  // a bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && ((done >> dev) & 1ull))) return e;
  e = cudaFuncSetAttribute(gn_proto_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gn_proto_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kGnResidentBytes));
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

// Set gn_proto's attributes, then report how many clusters of `clusters`
// CTAs of it can be resident at once (0: the shape cannot launch).
extern "C" int lis_gn_proto_cluster_check(int clusters, int* max_active) {
  cudaError_t e = gn_proto_attributes();
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = gn_proto_config(clusters, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(max_active, gn_proto_kernel, &cfg);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// n_inner fused GN iterations from the identity on one cluster of
// `clusters` CTAs, per_cta queries each; out (13,) f32
extern "C" int lis_gn_proto(void* q, void* qm, void* cand, void* scal, int nq, int nc,
                            int n_inner, int clusters, int per_cta, void* out, void* stream) {
  if (nq <= 0 || nc <= 0 || n_inner < 0 || clusters < 1 || clusters > kGnMaxCluster ||
      (long long)clusters * per_cta < nq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = gn_proto_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn_proto_config(clusters, static_cast<cudaStream_t>(stream),
                                                 &attr);
  e = cudaLaunchKernelEx(
      &cfg, gn_proto_kernel, static_cast<const float*>(q), static_cast<const uint8_t*>(qm),
      static_cast<const float*>(cand), static_cast<const float*>(scal), nq, nc, n_inner,
      per_cta, static_cast<float*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
