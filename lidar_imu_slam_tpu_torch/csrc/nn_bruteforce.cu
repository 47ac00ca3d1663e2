// Exact global nearest neighbour by brute force: kernel K6 (nn_bruteforce).
//
// Replaces: the JAX package's ops/pallas/nn_bruteforce.py:nn_bruteforce
// (body _kernel), which streams a (3, M) pool through VMEM in 8192-point
// tiles against 256-query tiles and keeps a running (min d^2, argmin).
//
// Contract (the plain version's, bit for bit): for each query q, over every
// pool entry p, d^2 = (dx*dx + dy*dy) + dz*dz with d = p - q, in f32
// rounded at every step (__fsub_rn / __fmul_rn / __fadd_rn, no FMA
// contraction); the minimum and the SMALLEST index attaining it. +inf
// entries (dead or evicted slab rows, padding) never win; a query whose
// pool holds nothing finite, or that is not finite itself, gets (+inf, 0).
// (A NaN entry never wins here either; the plain version and the JAX
// kernel skip the whole chunk or tile holding it, so pools with NaN
// entries lie outside the bit-equal contract: ROADMAP queue 3.)
//
// What bounds it on the card: operations. At the classic path's shape (N =
// 4096 queries, M = 1,310,720 pool entries) there are 5.4e9 pairs; at 8
// f32 operations a pair, 0.64 ms at the 67 TFLOP/s of one H100 SXM (700 W)
// outside the tensor cores. The exact expression takes about 12 issue
// slots a pair (8 un-fused operations, a compare, two selects, a shared
// load), so computing it for every pair is issue-bound at ~2.3 ms. The
// design computes it only where it can matter:
//
//   * Filter. Each pool stage is kept in shared memory as (x, y, z, |p|^2)
//     and every pair costs a = fma(-2qx, px, fma(-2qy, py, fma(-2qz, pz,
//     |p|^2))) = d^2 - |q|^2 + rounding, and a group minimum (fminf): three
//     FFMA and one FMNMX, with one broadcast LDS.128 serving the thread's
//     kQ = 4 queries. Only -2q and the threshold of each query stay in
//     registers through the filter loop; the rest of its state (running
//     best and index, |q|^2, mode) lives in shared memory, else 4 queries
//     a thread spill.
//   * Exact re-check. After each group of kGroup = 32 entries, a query whose
//     group minimum is <= thr_q recomputes that group with the exact
//     expression, in index order, strict `<` against its running best.
//   * thr_q = T_q - |q|^2 + margin_q, T_q an upper bound on the query's
//     exact minimum: the smaller of the slice's running best and a
//     per-query best shared by all slices (atomicMin on the f32 bits,
//     read at every stage), seeded by a pre-pass (nn_seed_kernel: the exact
//     d^2 to every kSampleStride-th pool entry, ~1.6% of the pairs).
//
// Why the result is bit-equal. Every T_q is the exact d^2 of a real entry
// (or the shared best's start, above every in-range d^2, below), so T_q >=
// D* (the exact minimum) and the group of the first entry i*
// attaining D* always passes the filter (below). A slice therefore
// reports either its first-index minimum over the entries it re-checked
// or (+inf, 0): the slice holding i* reports (D*, i*) exactly (nothing
// before i* in it reaches D*), earlier slices report more than D*, and the
// ordered merge (nn_merge_kernel, the earlier slice wins a tie) returns
// (D*, i*). Which groups are re-checked depends on timing; the answer does
// not.
//
// The margin (the filter never drops an entry with d^2 <= T_q). u = 2^-24.
// For finite p, q with every |coordinate| <= 2^60 (kRange):
//   d^2 = D (1 + th), |th| <= g5, D = |p - q|^2 exact, g_n = n u / (1 - n u)
//     (each term: one subtraction, one product, at most two additions);
//   a = |p|^2 - 2 q.p + Ea with, bounding the fused chain by the un-fused
//     one (an FMA rounds once where mul-then-add rounds twice):
//     |p|^2 computed with |err| <= g3 |p|^2, each product 2 q_i p_i with
//     u |2 q_i p_i|, the three additions g3 (|p|^2 + 2 |q| |p|), so
//     |Ea| <= 6.0000004 u |p|^2 + 8.0000006 u |q| |p|.
//   If d^2 <= T then D <= T / (1 - g5) <= T + 5.0001 u T, hence
//     a <= T - |q|^2 + 5.0001 u T + 6.0000004 u P2' + 8.0000006 u |q| P1'
//   with P2' the stage's largest exact |p|^2 (<= P2 (1 + 3.0001 u), P2 the
//   largest computed one) and P1' = sqrt(P2').
// The kernel takes
//   thr_q = round_up_f32( T - |q|^2 + 8 u (T + |q|^2 + P2 + 2 |q| sqrt(P2))
//                         + 2^-120 )
// evaluated in f64, with |q|^2 rounded down and |q| rounded up to f32 (both
// only raise it): 8 u T covers 5.0001 u T, 8 u P2 covers the |p|^2 term,
// 16 u |q| sqrt(P2) covers the cross term, 8 u |q|^2 covers the f64
// rounding of the expression (~2^-50 (T + |q|^2)), and 2^-120 every
// subnormal rounding. tests/test_torch_nn_bruteforce.py holds the Python
// mirror (nn_bruteforce.filter_threshold) against seeded adversarial pairs.
//
// Outside that range: a non-finite entry is staged as (0, 0, 0, +inf): its
// a is +inf (never passes a finite threshold) and the re-check skips it. A
// finite entry beyond kRange is staged as (0, 0, 0, -inf): its group always
// passes, and the re-check reads its coordinates from global memory. A
// non-finite query takes no re-check (its every d^2 is +inf or NaN: the
// answer is (+inf, 0)); a finite query beyond kRange filters with -2q = 0
// and thr = +inf, so every group is re-checked. The shared best starts at
// 0x7f7f7f7f (3.39e38, cudaMemsetAsync), above every d^2 of in-range
// coordinates (<= 3 * 2^122).
//
// Layout: 2-D grid, blockIdx.x a tile of kQueries = 512 queries (kQ per
// thread, strided by kThreads so the loads coalesce), blockIdx.y a slice of
// slice_len pool entries (8192 from the wrapper), staged kTile at a time;
// 80 registers and 28 KB of shared memory, 6 blocks an SM. At the path's
// shape 8 x 160 = 1,280 blocks over 132 SMs. queries (N, 3)
// f32 row-major; pool (3, M) f32 coordinate-major; scratch part_d2 /
// part_idx (S, N); outputs d2 (N,) f32 (the shared best until the merge
// overwrites it), idx (N,) i32. Built without fast math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;                // threads per block
constexpr int kQ = 4;                        // queries per thread
constexpr int kQueries = kThreads * kQ;      // queries per block
constexpr int kTile = 1024;                  // pool entries per shared-memory stage (16 KB)
constexpr int kGroup = 32;                   // entries per filter group
constexpr int kSampleStride = 64;            // the seed pre-pass: every 64th entry
constexpr int kSeedChunk = 256;              // samples per seed block
constexpr float kRange = 1152921504606846976.0f;  // 2^60: the filter's coordinate range
constexpr double kU = 5.9604644775390625e-08;     // 2^-24
constexpr double kMarginC = 8.0;
constexpr double kMarginAbs = 7.52316384526264e-37;  // 2^-120
constexpr int kBestInit = 0x7f7f7f7f;        // the shared best's start (3.39e38)

static_assert(kTile % kGroup == 0, "a stage holds whole groups");

__device__ __forceinline__ float exact_d2(float px, float py, float pz, float qx, float qy,
                                          float qz) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  const float dz = __fsub_rn(pz, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ bool in_range(float x, float y, float z) {
  return fabsf(x) <= kRange && fabsf(y) <= kRange && fabsf(z) <= kRange;  // false for NaN
}

// Pre-pass: the exact d^2 from each query to every kSampleStride-th pool
// entry, min into the shared best (atomicMin on the bits: d^2 >= +0).
__global__ void __launch_bounds__(kThreads)
nn_seed_kernel(const float* __restrict__ q, const float* __restrict__ pool, int n, int m,
               int* __restrict__ best_bits) {
  __shared__ float4 tile[kSeedChunk];
  const int samples = (m + kSampleStride - 1) / kSampleStride;
  const int s0 = blockIdx.y * kSeedChunk;
  const int cnt = min(kSeedChunk, samples - s0);
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const size_t p = (size_t)(s0 + j) * kSampleStride;
    tile[j] = make_float4(pool[p], pool[(size_t)m + p], pool[2 * (size_t)m + p], 0.f);
  }
  __syncthreads();
  float qx[kQ], qy[kQ], qz[kQ], best[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueries + k * kThreads + threadIdx.x;
    qx[k] = qy[k] = qz[k] = 0.f;
    if (qi < n) {
      qx[k] = q[3 * (size_t)qi];
      qy[k] = q[3 * (size_t)qi + 1];
      qz[k] = q[3 * (size_t)qi + 2];
    }
    best[k] = INFINITY;
  }
  for (int j = 0; j < cnt; ++j) {
    const float4 p = tile[j];
#pragma unroll
    for (int k = 0; k < kQ; ++k) best[k] = fminf(best[k], exact_d2(p.x, p.y, p.z, qx[k], qy[k], qz[k]));
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueries + k * kThreads + threadIdx.x;
    if (qi < n && best[k] < __int_as_float(kBestInit)) atomicMin(best_bits + qi, __float_as_int(best[k]));
  }
}

// The filter threshold of one query at one stage (see the header): T the
// upper bound on its exact minimum, qq <= |q|^2 and qn >= |q|, p2 the
// stage's largest computed |p|^2 and p1 its square root, in f64.
__device__ __forceinline__ float filter_threshold(float t, float qqf, float qnf, double p2,
                                                  double p1) {
  const double td = t, qq = qqf, qn = qnf;
  const double thr = (td - qq) + kMarginC * kU * (td + qq + p2 + 2.0 * qn * p1) + kMarginAbs;
  return __double2float_ru(thr);
}

__global__ void __launch_bounds__(kThreads, 6)
nn_slice_kernel(const float* __restrict__ q, const float* __restrict__ pool, int n, int m,
                int slice_len, int* __restrict__ best_bits, float* __restrict__ part_d2,
                int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  __shared__ float warp_max[kThreads / 32];
  // a query's state that the filter loop does not touch, in shared memory
  // (each thread reads and writes only its own column) so that the loop
  // keeps kQ queries in registers: the running best and its index, |q|^2
  // rounded down and |q| rounded up to f32 (each only raises the
  // threshold), the shared best read at the stage's start, the mode (0
  // filtered; 1 skipped: not finite, or past n; 2 every group re-checked:
  // beyond kRange)
  __shared__ float s_best[kQ][kThreads], s_qq[kQ][kThreads], s_qn[kQ][kThreads];
  __shared__ float s_shared[kQ][kThreads];
  __shared__ int s_best_i[kQ][kThreads], s_mode[kQ][kThreads];
  const int tid = threadIdx.x, lane = tid & 31;
  const int begin = blockIdx.y * slice_len;
  const int end = min(begin + slice_len, m);

  float mx[kQ], my[kQ], mz[kQ];  // -2q (an in-range query's q is -0.5 of it, exactly)
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueries + k * kThreads + tid;
    float x = 0.f, y = 0.f, z = 0.f;
    if (qi < n) {
      x = q[3 * (size_t)qi];
      y = q[3 * (size_t)qi + 1];
      z = q[3 * (size_t)qi + 2];
    }
    const bool finite = isfinite(x) && isfinite(y) && isfinite(z);
    const int mode = qi >= n || !finite ? 1 : (in_range(x, y, z) ? 0 : 2);
    const float s = mode == 0 ? -2.f : 0.f;
    mx[k] = s * x;
    my[k] = s * y;
    mz[k] = s * z;
    const double qqd = (double)x * x + (double)y * y + (double)z * z;
    s_qq[k][tid] = __double2float_rd(qqd);
    s_qn[k][tid] = __double2float_ru(sqrt(qqd));
    s_best[k][tid] = INFINITY;
    s_best_i[k][tid] = 0;
    s_mode[k][tid] = mode;
  }

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int cnt = min(kTile, end - t0);
    const int padded = (cnt + kGroup - 1) / kGroup * kGroup;
    __syncthreads();  // the previous stage is consumed
    float p2 = 0.f;
    for (int j = tid; j < padded; j += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);  // a padding entry: never re-checked
      if (j < cnt) {
        const size_t p = (size_t)t0 + j;
        const float x = pool[p], y = pool[(size_t)m + p], z = pool[2 * (size_t)m + p];
        if (in_range(x, y, z)) {
          v = make_float4(x, y, z, fmaf(x, x, fmaf(y, y, __fmul_rn(z, z))));
          p2 = fmaxf(p2, v.w);
        } else if (isfinite(x) && isfinite(y) && isfinite(z)) {
          v.w = -INFINITY;  // beyond kRange: always re-checked, from global memory
        }
      }
      tile[j] = v;
    }
    for (int o = 16; o > 0; o >>= 1) p2 = fmaxf(p2, __shfl_xor_sync(0xffffffffu, p2, o));
    if (lane == 0) warp_max[tid >> 5] = p2;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) p2 = fmaxf(p2, warp_max[w]);
    const double p2d = p2, p1d = sqrt(p2d);

    float thr[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int qi = blockIdx.x * kQueries + k * kThreads + tid;
      const int mode = s_mode[k][tid];
      const float shared = mode == 0 ? __int_as_float(__ldcg(best_bits + qi)) : INFINITY;
      s_shared[k][tid] = shared;
      thr[k] = mode == 0 ? filter_threshold(fminf(s_best[k][tid], shared), s_qq[k][tid],
                                            s_qn[k][tid], p2d, p1d)
                         : (mode == 2 ? INFINITY : NAN);
    }

    for (int g = 0; g < padded; g += kGroup) {
      float lo[kQ], hi[kQ];  // two running minima a query: shorter dependency chains
#pragma unroll
      for (int k = 0; k < kQ; ++k) lo[k] = hi[k] = INFINITY;
#pragma unroll
      for (int e = 0; e < kGroup; e += 2) {
        const float4 p = tile[g + e];
        const float4 r = tile[g + e + 1];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          lo[k] = fminf(lo[k], fmaf(mx[k], p.x, fmaf(my[k], p.y, fmaf(mz[k], p.z, p.w))));
          hi[k] = fminf(hi[k], fmaf(mx[k], r.x, fmaf(my[k], r.y, fmaf(mz[k], r.z, r.w))));
        }
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        if (fminf(lo[k], hi[k]) <= thr[k]) {  // false for NaN: a skipped query
          const int mode = s_mode[k][tid];
          float qx = -0.5f * mx[k], qy = -0.5f * my[k], qz = -0.5f * mz[k];
          if (mode == 2) {  // beyond kRange: its coordinates from global memory
            const size_t qi = (size_t)blockIdx.x * kQueries + k * kThreads + tid;
            qx = q[3 * qi];
            qy = q[3 * qi + 1];
            qz = q[3 * qi + 2];
          }
          float best = s_best[k][tid];
          int best_i = s_best_i[k][tid];
          for (int e = 0; e < kGroup; ++e) {
            const float4 p = tile[g + e];
            float px = p.x, py = p.y, pz = p.z;
            if (p.w == -INFINITY) {
              const size_t o = (size_t)t0 + g + e;
              px = pool[o];
              py = pool[(size_t)m + o];
              pz = pool[2 * (size_t)m + o];
            }
            const float d2 = exact_d2(px, py, pz, qx, qy, qz);
            if (d2 < best && p.w != INFINITY) {
              best = d2;
              best_i = t0 + g + e;
            }
          }
          s_best[k][tid] = best;
          s_best_i[k][tid] = best_i;
          if (mode == 0)
            thr[k] = fminf(thr[k], filter_threshold(best, s_qq[k][tid], s_qn[k][tid], p2d, p1d));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      const int qi = blockIdx.x * kQueries + k * kThreads + tid;
      const float best = s_best[k][tid];
      if (s_mode[k][tid] == 0 && best < s_shared[k][tid])
        atomicMin(best_bits + qi, __float_as_int(best));
    }
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int qi = blockIdx.x * kQueries + k * kThreads + tid;
    if (qi < n) {
      part_d2[(size_t)blockIdx.y * n + qi] = s_best[k][tid];
      part_idx[(size_t)blockIdx.y * n + qi] = s_best_i[k][tid];
    }
  }
}

__global__ void nn_merge_kernel(const float* __restrict__ part_d2,
                                const int* __restrict__ part_idx, int n, int slices,
                                float* __restrict__ d2, int* __restrict__ idx) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= n) return;
  float best = part_d2[qi];
  int best_i = part_idx[qi];
  for (int s = 1; s < slices; ++s) {
    const float v = part_d2[(size_t)s * n + qi];
    if (v < best) {
      best = v;
      best_i = part_idx[(size_t)s * n + qi];
    }
  }
  d2[qi] = best;
  idx[qi] = best_i;
}

}  // namespace

// Seed, filter and merge on `stream`; part_d2 / part_idx hold ceil(m /
// slice_len) (at least 1) rows of n; d2 doubles as the shared best until
// the merge. slice_len must be a positive multiple of kTile.
extern "C" int lis_nn_bruteforce(void* q, void* pool, int n, int m, int slice_len,
                                 void* part_d2, void* part_idx, void* d2, void* idx,
                                 void* stream) {
  if (n <= 0) return 0;
  if (slice_len <= 0 || slice_len % kTile != 0 || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = m > 0 ? (m + slice_len - 1) / slice_len : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* pf = static_cast<const float*>(pool);
  int* best_bits = static_cast<int*>(d2);
  cudaError_t err = cudaMemsetAsync(d2, 0x7f, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (n + kQueries - 1) / kQueries;
  if (m > 0) {
    const int samples = (m + kSampleStride - 1) / kSampleStride;
    const dim3 seed_grid(tiles, (samples + kSeedChunk - 1) / kSeedChunk);
    nn_seed_kernel<<<seed_grid, kThreads, 0, st>>>(qf, pf, n, m, best_bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nn_slice_kernel<<<dim3(tiles, slices), kThreads, 0, st>>>(
      qf, pf, n, m, slice_len, best_bits, static_cast<float*>(part_d2),
      static_cast<int*>(part_idx));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_merge_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part_d2), static_cast<const int*>(part_idx), n, slices,
      static_cast<float*>(d2), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
