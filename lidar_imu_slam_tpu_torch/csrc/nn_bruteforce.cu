// Exact global nearest neighbour by brute force: kernel K6 (nn_bruteforce).
//
// Replaces: the JAX package's ops/pallas/nn_bruteforce.py:nn_bruteforce
// (body _kernel), which streams a (3, M) pool through VMEM in 8192-point
// tiles against 256-query tiles and keeps a running (min d^2, argmin).
//
// For each query q, over every pool entry p, d^2 = (dx*dx + dy*dy) + dz*dz
// with d = p - q, in f32 rounded at every step (__fmul_rn / __fadd_rn: no
// FMA contraction, so d^2 is bit-equal to the plain PyTorch version's, and
// near-ties resolve the same way); the minimum and the SMALLEST index
// attaining it. +inf entries (dead or evicted slab rows, padding) never win;
// a query whose pool holds nothing finite gets (+inf, 0), as the TPU
// kernel's initial accumulator.
//
// What bounds it on the card: operations. At the classic path's shape
// (N = 4096 queries, M = 1,310,720 pool entries) it evaluates 5.4e9 pairs
// at 8 f32 operations each, 4.3e10 in all: at least 0.64 ms at the 67
// TFLOP/s an H100 SXM at its 700 W limit reaches outside the tensor cores,
// while its 15.7 MB pool takes ~5 us at that card's 3.35 TB/s. So the
// design keeps the pool in shared memory and the query in registers:
//   * pass 1 (nn_slice_kernel): a 2-D grid — blockIdx.x a tile of 256
//     queries (one per thread), blockIdx.y a slice of slice_len pool
//     entries (8192 from the wrapper).
//     The block stages its slice through shared memory kTile points at a
//     time (coalesced per coordinate plane, stored as float4 so every
//     thread's read is one broadcast LDS.128) and each thread keeps its own
//     running (d^2, index) with a strict `<` in index order, so the first
//     minimum of the slice wins. At the path's shape: 16 x 160 = 2,560
//     blocks over 132 SMs.
//   * pass 2 (nn_merge_kernel): one thread per query walks the slices in
//     order and keeps the partial with a strictly smaller d^2 — the earlier
//     slice wins a tie, as the TPU kernel's tile merge does. No atomics:
//     the result never depends on block arrival order.
// A tensor-core ||q||^2 + ||p||^2 - 2 q.p formulation (with its precision
// question) is later work.
//
// Layout: queries (N, 3) f32 row-major; pool (3, M) f32 coordinate-major;
// scratch part_d2 / part_idx (S, N); outputs d2 (N,) f32, idx (N,) i32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // queries per block
constexpr int kTile = 2048;    // pool points per shared-memory stage (32 KB)

__global__ void __launch_bounds__(kThreads)
nn_slice_kernel(const float* __restrict__ q, const float* __restrict__ pool, int n, int m,
                int slice_len, float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int begin = blockIdx.y * slice_len;
  const int end = min(begin + slice_len, m);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < n) {
    qx = q[3 * (size_t)qi];
    qy = q[3 * (size_t)qi + 1];
    qz = q[3 * (size_t)qi + 2];
  }
  float best = INFINITY;
  int best_i = 0;
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int cnt = min(kTile, end - t0);
    __syncthreads();  // the previous stage is consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const size_t p = (size_t)t0 + j;
      tile[j] = make_float4(pool[p], pool[(size_t)m + p], pool[2 * (size_t)m + p], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(p.x, qx);
      const float dy = __fsub_rn(p.y, qy);
      const float dz = __fsub_rn(p.z, qz);
      const float d2 =
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_i = t0 + j;
      }
    }
  }
  if (qi < n) {
    part_d2[(size_t)blockIdx.y * n + qi] = best;
    part_idx[(size_t)blockIdx.y * n + qi] = best_i;
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

// Both passes on `stream`; part_d2 / part_idx hold ceil(m / slice_len)
// (at least 1) rows of n. slice_len must be a positive multiple of kTile.
extern "C" int lis_nn_bruteforce(void* q, void* pool, int n, int m, int slice_len,
                                 void* part_d2, void* part_idx, void* d2, void* idx,
                                 void* stream) {
  if (n <= 0) return 0;
  if (slice_len <= 0 || slice_len % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slices = m > 0 ? (m + slice_len - 1) / slice_len : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kThreads - 1) / kThreads, slices);
  nn_slice_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(pool), n, m, slice_len,
      static_cast<float*>(part_d2), static_cast<int*>(part_idx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_merge_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part_d2), static_cast<const int*>(part_idx), n, slices,
      static_cast<float*>(d2), static_cast<int*>(idx));
  return static_cast<int>(cudaGetLastError());
}
