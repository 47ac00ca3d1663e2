// The per-point pass of the LIO step's IMU motion compensation: for each
// point, the interval search over its stream's IMU pose trail, exp(w dt) of
// the interval's gyro, the trail pose and the transform to the scan end,
// P' = R_end^T (R_k exp(w dt) P + pos_k + vel_k dt + acc_k dt^2 / 2
//                + R_k exp(w dt) t_il - p_lidar_end),
// written once; a point whose mask is off is copied through.
//
// Replaces: no Pallas kernel. The JAX package's per-point undistortion
// (lidar_imu_slam_tpu/models/ekf.py:motion_compensation_with_imu) is plain
// jnp that XLA fuses; the port's plain PyTorch version
// (models/ekf.py:deskew_points_plain) runs it as ~140 aten passes over the
// (S, N) points, among them a 21-column gather of the trail rows that
// materialises (21, S, N) f32 and a searchsorted that writes an i64 index.
//
// What bounds it on the card: bytes, by the roofline. At the LIO ensemble's
// shape (S = 4096 streams x N = 16,384 points) a launch reads the points
// (12 B), their f64 times (8 B) and mask (1 B) and writes the points (12
// B): 33 B a point, 2.21 GB, plus the (S, M, 21) trail tables (22 MB): 0.67
// ms at 3.35 TB/s. The design moves each of those bytes once. Close behind
// come the instructions: ~100 f32 operations and three sin / cos a point,
// each rounded on its own, some 400 instructions a point.
//
// Design: grid (point blocks, S); a block of 256 threads takes one stream's
// points in chunks of 256 and first loads that stream's M trail offsets,
// their finite copies, the M x 21 table and its t_il, p_lidar_end and
// R_end into shared memory (M = 65 at the default 64-sample packet: ~6
// KB), so the binary search and the row reads never touch device memory.
// A chunk's (256, 3) rows go through shared memory both ways: the block
// reads and writes 768 contiguous floats, neighbouring threads on
// neighbouring words (the 12-byte rows would otherwise be three strided
// loads and stores a point), the times and mask are read a point a thread,
// and everything moves with streaming loads and stores (read or written
// once). A block takes up to 8 chunks (fewer when that leaves under 1,024
// blocks), so the table is loaded once per 2,048 points. The per-stream
// terms stay in shared memory, not registers, so that a thread needs 32
// registers and eight blocks fit an SM: on one H100 at 4096 x 16,384 a
// launch took 1.70 ms with them in registers (64), 1.39 ms in shared
// memory (40 registers, six blocks an SM) and 1.30 ms at eight blocks;
// the same loads and stores with no arithmetic take 0.77 ms. The
// arithmetic, each step rounded on its own (below), is what the rest
// waits on.
//
// Rounding: bit-equal to the plain version on the card. Every step keeps
// the plain version's operation order and rounds on its own (__fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn: the library is built
// without --fmad=false, and a contracted FMA would move the bits); sin and
// cos are the full-precision sinf / cosf that PyTorch's kernels call; the
// time is rounded to f32 (__double2float_rn) before the search; `sq / 6.0`
// is the product with the f32 reciprocal of 6, as PyTorch's division by a
// scalar computes it. The search is searchsorted's lower bound (first
// offset >= t, the +inf padding included), k = clamp(that - 1, 0, M - 1).
//
// Layouts: pts (S, N, 3) f32; rel (S, N) f64; mask (S, N) bool as bytes;
// offsets (S, M) f32; table (S, M, 21) f32, an entry's R row-major, gyro,
// position, velocity, acceleration; t_il, p_end (S, 3) f32; rot_end (S, 3,
// 3) f32 row-major; out (S, N, 3) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 21;
constexpr int kBlocksPerSm = 8;  // 32 registers a thread
constexpr int kMaxChunks = 8;  // chunks of kThreads points a block
constexpr int kMinBlocks = 1024;
constexpr int kMaxEntries = 480;  // trail entries: the shared memory stays under 48 KB

// a row-major 3x3 times v, each product and sum rounded as the plain
// version's separate passes round them
__device__ __forceinline__ void mat_vec(const float* r, float ax, float ay, float az,
                                        float& ox, float& oy, float& oz) {
  ox = __fadd_rn(__fadd_rn(__fmul_rn(r[0], ax), __fmul_rn(r[1], ay)), __fmul_rn(r[2], az));
  oy = __fadd_rn(__fadd_rn(__fmul_rn(r[3], ax), __fmul_rn(r[4], ay)), __fmul_rn(r[5], az));
  oz = __fadd_rn(__fadd_rn(__fmul_rn(r[6], ax), __fmul_rn(r[7], ay)), __fmul_rn(r[8], az));
}

struct Rotation {  // exp(w): w and the coefficients of Rodrigues' formula
  float wx, wy, wz, cos_t, sinc, b;

  // exp(w) v = v cos + (w x v) sinc + w (w . v) b
  __device__ __forceinline__ void apply(float vx, float vy, float vz, float& ox, float& oy,
                                        float& oz) const {
    const float dot =
        __fadd_rn(__fadd_rn(__fmul_rn(wx, vx), __fmul_rn(wy, vy)), __fmul_rn(wz, vz));
    ox = __fadd_rn(__fadd_rn(__fmul_rn(vx, cos_t),
                             __fmul_rn(__fsub_rn(__fmul_rn(wy, vz), __fmul_rn(wz, vy)), sinc)),
                   __fmul_rn(__fmul_rn(wx, dot), b));
    oy = __fadd_rn(__fadd_rn(__fmul_rn(vy, cos_t),
                             __fmul_rn(__fsub_rn(__fmul_rn(wz, vx), __fmul_rn(wx, vz)), sinc)),
                   __fmul_rn(__fmul_rn(wy, dot), b));
    oz = __fadd_rn(__fadd_rn(__fmul_rn(vz, cos_t),
                             __fmul_rn(__fsub_rn(__fmul_rn(wx, vy), __fmul_rn(wy, vx)), sinc)),
                   __fmul_rn(__fmul_rn(wz, dot), b));
  }
};

__device__ __forceinline__ Rotation rotation(float gx, float gy, float gz, float dtp) {
  Rotation r;
  r.wx = __fmul_rn(gx, dtp);
  r.wy = __fmul_rn(gy, dtp);
  r.wz = __fmul_rn(gz, dtp);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(r.wx, r.wx), __fmul_rn(r.wy, r.wy)),
                             __fmul_rn(r.wz, r.wz));
  float half;
  if (sq < 1e-12f) {  // small angle: the series
    r.sinc = __fsub_rn(1.0f, __fmul_rn(sq, 1.0f / 6.0f));
    r.cos_t = __fsub_rn(1.0f, __fmul_rn(0.5f, sq));
    half = 1.0f;
  } else {
    const float th = __fsqrt_rn(sq);
    r.sinc = __fdiv_rn(sinf(th), th);
    r.cos_t = cosf(th);
    const float h = __fmul_rn(0.5f, th);
    half = __fdiv_rn(sinf(h), h);  // (1 - cos th) / th^2 = sinc(th / 2)^2 / 2
  }
  r.b = __fmul_rn(__fmul_rn(0.5f, half), half);
  return r;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
imu_deskew_kernel(const float* __restrict__ pts, const double* __restrict__ rel,
                  const uint8_t* __restrict__ mask, const float* __restrict__ offsets,
                  const float* __restrict__ table, const float* __restrict__ t_il,
                  const float* __restrict__ p_end, const float* __restrict__ rot_end, int n,
                  int m, int chunks, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_io = smem;                // (256, 3) a chunk's rows
  float* s_til = s_io + 3 * kThreads;  // (3,) t_il, (3,) p_end, (9,) R_end
  float* s_pe = s_til + 3;
  float* s_re = s_pe + 3;
  float* s_off = s_re + 9;           // (M,) the offsets, +inf padding included
  float* s_off0 = s_off + m;         // (M,) the same, 0 where not finite
  float* s_tab = s_off0 + m;         // (M, 21)
  const long long b = blockIdx.y;

  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float o = __ldg(offsets + b * m + j);
    s_off[j] = o;
    s_off0[j] = isfinite(o) ? o : 0.0f;
  }
  for (int j = threadIdx.x; j < m * kCols; j += kThreads)
    s_tab[j] = __ldg(table + b * m * kCols + j);
  if (threadIdx.x < 3) {
    s_til[threadIdx.x] = __ldg(t_il + b * 3 + threadIdx.x);
    s_pe[threadIdx.x] = __ldg(p_end + b * 3 + threadIdx.x);
  } else if (threadIdx.x < 12) {
    s_re[threadIdx.x - 3] = __ldg(rot_end + b * 9 + threadIdx.x - 3);
  }

  const long long base = b * n;
  for (int c = 0; c < chunks; ++c) {
    const int i0 = (blockIdx.x * chunks + c) * kThreads;
    if (i0 >= n) break;  // the same for the whole block
    const int cnt = min(kThreads, n - i0);
    const float* src = pts + (base + i0) * 3;
    for (int j = threadIdx.x; j < 3 * cnt; j += kThreads) s_io[j] = __ldcs(src + j);
    const int t = threadIdx.x;
    const bool mine = t < cnt;
    const double r = mine ? __ldcs(rel + base + i0 + t) : 0.0;
    const bool on = mine && __ldcs(mask + base + i0 + t) != 0;
    __syncthreads();  // the table (first chunk) and this chunk's rows

    if (on) {
      const float rel32 = __double2float_rn(r);
      int lo = 0, hi = m;  // searchsorted's lower bound
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(s_off[mid] >= rel32)) lo = mid + 1;
        else hi = mid;
      }
      const int k = min(max(lo - 1, 0), m - 1);
      const float* row = s_tab + k * kCols;
      const float dtp = __fsub_rn(rel32, s_off0[k]);
      const Rotation w = rotation(row[9], row[10], row[11], dtp);

      float ex, ey, ez, rx, ry, rz, ix, iy, iz;
      w.apply(s_io[3 * t], s_io[3 * t + 1], s_io[3 * t + 2], ex, ey, ez);
      mat_vec(row, ex, ey, ez, rx, ry, rz);  // R_k exp(w dt) p
      w.apply(s_til[0], s_til[1], s_til[2], ex, ey, ez);
      mat_vec(row, ex, ey, ez, ix, iy, iz);  // R_k exp(w dt) t_il
      const float h2 = __fmul_rn(__fmul_rn(0.5f, dtp), dtp);
      const float ri[3] = {rx, ry, rz}, ii[3] = {ix, iy, iz};
      float cv[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float trans = __fsub_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(row[12 + a], __fmul_rn(row[15 + a], dtp)),
                                __fmul_rn(row[18 + a], h2)),
                      ii[a]),
            s_pe[a]);
        cv[a] = __fadd_rn(ri[a], trans);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)  // R_end^T
        s_io[3 * t + a] = __fadd_rn(
            __fadd_rn(__fmul_rn(s_re[a], cv[0]), __fmul_rn(s_re[3 + a], cv[1])),
            __fmul_rn(s_re[6 + a], cv[2]));
    }
    __syncthreads();  // every row of the chunk written

    float* dst = out + (base + i0) * 3;
    for (int j = threadIdx.x; j < 3 * cnt; j += kThreads) __stcs(dst + j, s_io[j]);
    __syncthreads();  // s_io read out before the next chunk's rows land
  }
}

}  // namespace

// The deskewed points of S streams x N points over M trail entries; see the
// layouts above. Returns the launch's cudaError (0: launched).
extern "C" int lis_imu_deskew(void* pts, void* rel, void* mask, void* offsets, void* table,
                              void* t_il, void* p_end, void* rot_end, int s, int n, int m,
                              void* out, void* stream) {
  if (s <= 0 || n <= 0) return 0;
  if (s > 65535 || m <= 0 || m > kMaxEntries) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (n + kThreads - 1) / kThreads;
  int chunks = kMaxChunks;
  while (chunks > 1 &&
         static_cast<long long>(s) * ((n_chunks + chunks - 1) / chunks) < kMinBlocks)
    chunks /= 2;
  const dim3 blocks(static_cast<unsigned>((n_chunks + chunks - 1) / chunks),
                    static_cast<unsigned>(s));
  const size_t shared =
      sizeof(float) * (3 * kThreads + 15 + static_cast<size_t>(m) * (2 + kCols));
  imu_deskew_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const double*>(rel),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(offsets),
      static_cast<const float*>(table), static_cast<const float*>(t_il),
      static_cast<const float*>(p_end), static_cast<const float*>(rot_end), n, m, chunks,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
