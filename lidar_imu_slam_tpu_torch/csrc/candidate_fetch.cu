// The ICP candidate fetch of the fused GN paths (K1 / K4 / K5's input): for
// each query and each of its NB neighbour voxels, the grid lookup with its
// fingerprint check, the voxel's packed row and its Kp lanes decoded
// relative to the stream's anchor, written as the candidate planes.
//
// Replaces: no Pallas kernel. The JAX package's fetch
// (lidar_imu_slam_tpu/ops/voxel_map.py:gather_candidate_planes_packed) is
// plain jnp gathers that XLA fuses; the port's plain PyTorch version
// (ops/voxel_map.py:gather_candidate_planes_packed_plain) runs it as ~142
// aten ops a call, most of them elementwise passes over the (S, Kp, NB * N)
// candidates and a stack of the three planes.
//
// What bounds it on the card: bytes. At the batched deployments' shapes
// (S x N = 1,048,576 queries, NB = 8, Kp = 10, NC = 80) a launch writes
// S x 3 x 80 x N x 4 B = 1,007 MB of planes and reads one 4-byte grid cell
// (33.6 MB) and one 40-byte packed row (335.5 MB) a (query, neighbour), and
// the queries and their mask (13.6 MB): 1.39 GB, 0.415 ms at 3.35 TB/s,
// 72% of it the planes it writes. The design moves each of those bytes
// once: nothing between the lookup and the planes touches device memory.
//
// Design: one thread a (query n, stream b), grid (ceil(N / 256), B), so
// consecutive threads take consecutive queries of one stream and each of a
// thread's NB x 3 x Kp stores to a plane row (candidate j = kp * NB + nb)
// is, over the warp, one coalesced 128-byte line. A thread reads its query
// once, computes its base voxels once (NB = 8: six divisions, not 24), and
// starts all NB grid loads before it reads the first row, so each thread
// keeps NB independent lookups in flight; then, a neighbour at a time, it
// reads the packed row (8-byte loads when Kp is even: rows of 40 bytes,
// else 4-byte ones) and writes its lanes. The source arrives in voxel
// order, so neighbouring queries mostly read the same grid cells and rows,
// from L1 / L2; the planes leave with streaming stores (__stcs), which do
// not push the cells and rows out of L2. A thread per (query, neighbour)
// instead, grid (ceil(N / 256), NB, B), took 0.90-1.16 ms a launch at the
// deployments' shapes against 0.41-0.44 ms for this layout (one H100, on
// maps whose rows fit in L2; on maps of the deployments' live voxels this
// layout takes 0.58 / 0.65 ms, tools/fetch_cases.deployment).
//
// Rounding: bit-equal to the plain version. The voxel index is a true f32
// division (__fdiv_rn) truncated toward zero; the decode keeps the plain
// version's operation order, (q * scale) - halfspan, then ((kv * vs) +
// local) + aoff, each step rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn: the library is built without --fmad=false, and a contracted
// FMA would move the bits). A lane < 0, an absent voxel and a masked-out
// query give +inf.
//
// Layouts: q (B, N, 3) f32 world frame; qm (B, N) bool as bytes; grid
// (B, G) i32 (fingerprint << slot_bits | slot, -1 absent); packed (B, C, Kp)
// i32; av (B, 3) i32 = round(anchor / vs); aoff (B, 3) f32 = av * vs -
// anchor (both from the wrapper, in f64 there); out (B, 3, Kp * NB, N) f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeyBits = 10;
constexpr int kKeyMask = (1 << kKeyBits) - 1;
constexpr int kPklBits = 10;
constexpr int kPklMax = (1 << kPklBits) - 1;

struct Geometry {
  int lgx, lgy, lgz;  // log2 of the grid's dimensions
  int slot_bits;
  int cap;  // rows of the packed slab
  float vs, half, scale, halfspan;
};

// voxel_map.voxel_of: a true f32 division, truncated toward zero
__device__ __forceinline__ int voxel_index(float x, float vs) {
  return static_cast<int>(__fdiv_rn(x, vs));
}

// voxel_map._neighbor_voxels, axis a of neighbour nb: NB = 8 is the 2x2x2
// cover of lo = voxel_of(q - half) and hi = voxel_of(q + half) (bit set:
// hi), NB = 27 the 3x3x3 shell lo = voxel_of(q) + {-1, 0, 1}
template <int NB>
__device__ __forceinline__ int neighbour_axis(const int (&lo)[3], const int (&hi)[3], int nb,
                                              int a) {
  if (NB == 8) return (nb >> (2 - a)) & 1 ? hi[a] : lo[a];
  const int digit = a == 0 ? nb / 9 : a == 1 ? (nb / 3) % 3 : nb % 3;
  return lo[a] + (digit - 1);
}

// voxel_map.pack_key, grid_pos, _fp_of and _lookup: the slot of the voxel,
// or -1 when it is absent or the query masked out
__device__ __forceinline__ int lookup(const int (&vox)[3], bool on, const int* grid,
                                      const Geometry& g) {
  if (!on) return -1;
  const int key = ((vox[0] & kKeyMask) << (2 * kKeyBits)) | ((vox[1] & kKeyMask) << kKeyBits) |
                  (vox[2] & kKeyMask);
  const int gy = 1 << g.lgy, gz = 1 << g.lgz;
  const int pos = (((key >> (2 * kKeyBits)) & ((1 << g.lgx) - 1)) * gy +
                   ((key >> kKeyBits) & (gy - 1))) * gz + (key & (gz - 1));
  const int xhi = key >> (2 * kKeyBits + g.lgx);
  const int yhi = (key >> (kKeyBits + g.lgy)) & ((1 << (kKeyBits - g.lgy)) - 1);
  const int zhi = (key >> g.lgz) & ((1 << (kKeyBits - g.lgz)) - 1);
  const int fp = (((xhi << (kKeyBits - g.lgy)) | yhi) << (kKeyBits - g.lgz)) | zhi;
  const int cell = __ldg(grid + pos);
  if (cell < 0 || (cell >> g.slot_bits) != fp) return -1;
  return min(static_cast<int>(static_cast<unsigned>(cell) & ((1u << g.slot_bits) - 1u)),
             g.cap - 1);
}

// voxel_map._pk_decode_axis relative to the anchor: kv_vs = (kv - av) * vs
__device__ __forceinline__ float decode_axis(int p, int shift, float kv_vs, float aoff,
                                             const Geometry& g) {
  const float local = __fsub_rn(__fmul_rn(static_cast<float>((p >> shift) & kPklMax), g.scale),
                                g.halfspan);
  return __fadd_rn(__fadd_rn(kv_vs, local), aoff);
}

template <int NB, bool kPairs>
__global__ void __launch_bounds__(kThreads)
candidate_fetch_kernel(const float* __restrict__ q, const uint8_t* __restrict__ qm,
                       const int* __restrict__ grid, const int* __restrict__ packed,
                       const int* __restrict__ av, const float* __restrict__ aoff, int n,
                       long long g_cells, int kp, Geometry g, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long b = blockIdx.y;
  const long long qi = b * n + i;

  int lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    const float x = __ldg(q + qi * 3 + a);
    lo[a] = voxel_index(NB == 8 ? __fsub_rn(x, g.half) : x, g.vs);
    hi[a] = NB == 8 ? voxel_index(__fadd_rn(x, g.half), g.vs) : lo[a];
  }
  // every neighbour's grid cell in flight at once
  const bool on = __ldg(qm + qi) != 0;
  const int* gb = grid + b * g_cells;
  int slots[NB];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int vox[3] = {neighbour_axis<NB>(lo, hi, nb, 0), neighbour_axis<NB>(lo, hi, nb, 1),
                        neighbour_axis<NB>(lo, hi, nb, 2)};
    slots[nb] = lookup(vox, on, gb, g);
  }

  int avb[3];
  float off[3];
  for (int a = 0; a < 3; ++a) {
    avb[a] = __ldg(av + b * 3 + a);
    off[a] = __ldg(aoff + b * 3 + a);
  }
  const int nc = kp * NB;
  const long long plane = static_cast<long long>(nc) * n;
  const long long lane = static_cast<long long>(NB) * n;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll 1
  for (int nb = 0; nb < NB; ++nb) {
    float kv_vs[3];
    for (int a = 0; a < 3; ++a)
      kv_vs[a] = __fmul_rn(static_cast<float>(neighbour_axis<NB>(lo, hi, nb, a) - avb[a]), g.vs);
    // slots[nb] read through selects, so that slots[] stays in registers:
    // indexed at run time it would live in local memory (unrolling this
    // loop instead spills at NB 27 and took 2.08 against 1.72 ms there)
    int slot = slots[0];
#pragma unroll
    for (int k = 1; k < NB; ++k) slot = k == nb ? slots[k] : slot;
    const int* row = packed + (b * g.cap + max(slot, 0)) * kp;
    float* o = out + (b * 3 * nc + nb) * n + i;
    auto emit = [&](int p) {  // an absent voxel reads as lanes of -1
      const bool bad = p < 0;
      __stcs(o, bad ? inf : decode_axis(p, 2 * kPklBits, kv_vs[0], off[0], g));
      __stcs(o + plane, bad ? inf : decode_axis(p, kPklBits, kv_vs[1], off[1], g));
      __stcs(o + 2 * plane, bad ? inf : decode_axis(p, 0, kv_vs[2], off[2], g));
      o += lane;
    };
    if (kPairs) {
      for (int k = 0; k < kp; k += 2) {
        const int2 v = slot < 0 ? make_int2(-1, -1)
                                : __ldg(reinterpret_cast<const int2*>(row + k));
        emit(v.x);
        emit(v.y);
      }
    } else {
      for (int k = 0; k < kp; ++k) emit(slot < 0 ? -1 : __ldg(row + k));
    }
  }
}

}  // namespace

// Candidate planes of B streams x N queries x NB neighbours; see the
// layouts above. Returns the launch's cudaError (0: launched).
extern "C" int lis_candidate_fetch(void* q, void* qm, void* grid, void* packed, void* av,
                                   void* aoff, int b, int n, long long g_cells, int cap, int kp,
                                   int nbhd, int lgx, int lgy, int lgz, int slot_bits, float vs,
                                   float half, float scale, float halfspan, void* out,
                                   void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (b > 65535 || cap <= 0 || kp <= 0 || (nbhd != 8 && nbhd != 27) || slot_bits < 1 ||
      slot_bits > 31 || lgx < 0 || lgx > kKeyBits || lgy < 0 || lgy > kKeyBits || lgz < 0 ||
      lgz > kKeyBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{lgx, lgy, lgz, slot_bits, cap, vs, half, scale, halfspan};
  const dim3 blocks(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    static_cast<unsigned>(b));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* m = static_cast<const uint8_t*>(qm);
  const int* gr = static_cast<const int*>(grid);
  const int* pk = static_cast<const int*>(packed);
  const int* a = static_cast<const int*>(av);
  const float* ao = static_cast<const float*>(aoff);
  float* o = static_cast<float*>(out);
  const bool pairs = kp % 2 == 0 && (reinterpret_cast<uintptr_t>(packed) & 7u) == 0;
  if (nbhd == 8 && pairs)
    candidate_fetch_kernel<8, true><<<blocks, kThreads, 0, st>>>(qf, m, gr, pk, a, ao, n, g_cells,
                                                                 kp, g, o);
  else if (nbhd == 8)
    candidate_fetch_kernel<8, false><<<blocks, kThreads, 0, st>>>(qf, m, gr, pk, a, ao, n,
                                                                  g_cells, kp, g, o);
  else if (pairs)
    candidate_fetch_kernel<27, true><<<blocks, kThreads, 0, st>>>(qf, m, gr, pk, a, ao, n,
                                                                  g_cells, kp, g, o);
  else
    candidate_fetch_kernel<27, false><<<blocks, kThreads, 0, st>>>(qf, m, gr, pk, a, ao, n,
                                                                   g_cells, kp, g, o);
  return static_cast<int>(cudaGetLastError());
}
