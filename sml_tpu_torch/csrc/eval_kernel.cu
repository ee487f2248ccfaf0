// masked_rank_kernel: masked leave-one-out rank counts by dense scoring,
// K2's earlier design, kept as P1's kernel (K2 is now the gather kernel of
// csrc/masked_rank_gather.cu). For each eval row b:
//
//   rank[b] = #{ i : bit(mask[b], i) and ue[b] . items_t[:, i] > sstar[b] }
//
// strictly greater; the (B, I) score matrix is never written out. The mask
// covers the row's negatives only, so the target never compares with
// itself. Mask layout (unchanged from the JAX package, so masks compare word
// for word): bit k of uint32 word jb*128 + w marks item jb*4096 + k*128 + w.
// The item table is transposed, (d, I_pad), as in the JAX package.
//
// P1 replaces the eval-design probe scripts/eval_kernel_probe.py
// make_variant (Pallas body _kernel_body :49-68, K2's function under layout
// variants); this kernel is a template over two of its axes:
//   RB          rows per block: 32 or 64 (the probe's rblk 256 and 512);
//               a warp owns RB/8 rows.
//   ITEMS_ON_X  grid order: false puts row tiles on blockIdx.x (the probe's
//               "ij"); true puts item blocks on blockIdx.x ("ji"). The card
//               rasterises blockIdx.x fastest, so the order only decides
//               which operand neighbouring blocks share in L2.
// The probe's dimension_semantics has no counterpart: blocks run in any
// order and the counts are added with integer atomics. Every instantiation
// is reached through one entry point, sml_masked_rank.
//
// Bound on an H100 SXM at the probe's shape (B=16,384, I_pad=20,480, d=64,
// 999 negatives per row). The function needs the scores of the set mask
// bits only: 2*d*popcount(mask) = 2.1 GFLOP (0.031 ms at 67 TFLOP/s, f32
// outside the tensor cores) against 51.5 MB of f32 inputs (0.0154 ms at
// 3.35 TB/s), so operations bound it; with bf16 inputs the tensor cores'
// rate leaves the 46.7 MB (0.0139 ms) of bytes as the bound. This design's
// floor is its dense work, 2*B*I_pad*d = 42.9 GFLOP, 0.64 ms in f32; only a
// design that skips the unmasked columns goes below it (K2's gather).
//
// Design: a 2-D grid of (RB-row tiles) x (4096-item mask blocks), so the
// blocks are independent (the TPU kernel summed over the item axis in
// sequence; here blocks run in no order). A block stages its RB user rows
// in shared memory (k-major), loads its RBx128 mask words once into
// registers (each thread owns RB/8 rows x 4 lanes), then walks the 32 bit
// planes: per plane it stages the d x 128 item tile, computes a register
// tile of f32 scores (fmaf, no tensor cores, no TF32), and counts
// bit & (score > sstar). The per-row counts are summed across the warp with
// shuffles and added into rank[b] with one int32 atomicAdd per row and
// warp; integer atomics do not depend on order, so results are
// deterministic. ue/items_t may be f32 or bf16 (widened on load).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;   // warp w owns rows w*RB/8.. of the tile
constexpr int LANES = 128;     // items per bit plane
constexpr int PLANES = 32;     // bits per mask word
constexpr int I_BLK = LANES * PLANES;

__device__ __forceinline__ float widen(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T, int RB, bool ITEMS_ON_X>
__global__ void __launch_bounds__(THREADS) masked_rank_kernel(
    const T* __restrict__ ue, const T* __restrict__ items_t,
    const float* __restrict__ sstar, const uint32_t* __restrict__ maskp,
    int* __restrict__ rank, int B, int d, int ipad) {
  constexpr int ROWS = RB / (THREADS / 32);   // rows per warp: 4 or 8
  static_assert(ROWS % 4 == 0, "a warp owns a multiple of 4 rows");
  extern __shared__ __align__(16) float smem[];
  float* ueT = smem;              // [d][RB]
  float* its = smem + d * RB;     // [d][LANES]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = (ITEMS_ON_X ? blockIdx.y : blockIdx.x) * RB;
  const int jb = ITEMS_ON_X ? blockIdx.x : blockIdx.y;
  const int words = ipad / PLANES;

  for (int i = tid; i < RB * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    const int gr = row0 + r;
    ueT[k * RB + r] = gr < B ? widen(ue, (size_t)gr * d + k) : 0.f;
  }

  float ss[ROWS];
  uint32_t mw[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int gr = row0 + ty * ROWS + r;
    ss[r] = gr < B ? sstar[gr] : INFINITY;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      mw[r][m] = gr < B
          ? maskp[(size_t)gr * words + jb * LANES + tx + 32 * m] : 0u;
  }

  int cnt[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) cnt[r] = 0;
  for (int k = 0; k < PLANES; ++k) {
    __syncthreads();   // ueT staged; the previous plane's tile consumed
    const size_t base = (size_t)jb * I_BLK + k * LANES;
    for (int i = tid; i < d * LANES; i += THREADS) {
      const int dd = i / LANES, w = i - dd * LANES;
      its[i] = widen(items_t, (size_t)dd * ipad + base + w);
    }
    __syncthreads();

    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float* it = its + dd * LANES + tx;
      const float v[4] = {it[0], it[32], it[64], it[96]};
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(
            &ueT[dd * RB + ty * ROWS + 4 * q]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc[4 * q + 0][m] = fmaf(u.x, v[m], acc[4 * q + 0][m]);
          acc[4 * q + 1][m] = fmaf(u.y, v[m], acc[4 * q + 1][m]);
          acc[4 * q + 2][m] = fmaf(u.z, v[m], acc[4 * q + 2][m]);
          acc[4 * q + 3][m] = fmaf(u.w, v[m], acc[4 * q + 3][m]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        cnt[r] += (int)((((mw[r][m] >> k) & 1u) != 0u) && (acc[r][m] > ss[r]));
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    int c = cnt[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    const int gr = row0 + ty * ROWS + r;
    if (tx == 0 && c != 0 && gr < B) atomicAdd(&rank[gr], c);
  }
}

template <typename T, int RB, bool ITEMS_ON_X>
int launch(const void* ue, const void* items_t, const float* sstar,
           const uint32_t* maskp, int* rank, int B, int d, int ipad,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const size_t smem = (size_t)d * (RB + LANES) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const unsigned row_tiles = (B + RB - 1) / RB;
  const unsigned item_blocks = ipad / I_BLK;
  if ((ITEMS_ON_X ? row_tiles : item_blocks) > 65535u)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ipad == 0) return (int)cudaSuccess;
  const cudaError_t err =
      allow_max_smem(masked_rank_kernel<T, RB, ITEMS_ON_X>, smem_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = ITEMS_ON_X ? dim3(item_blocks, row_tiles)
                               : dim3(row_tiles, item_blocks);
  masked_rank_kernel<T, RB, ITEMS_ON_X><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(items_t), sstar, maskp,
      rank, B, d, ipad);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_variant(const void* ue, const void* items_t, const float* sstar,
                   const uint32_t* maskp, int* rank, int B, int d, int ipad,
                   int rows_per_block, int items_on_x, cudaStream_t s) {
  if (rows_per_block == 32)
    return items_on_x
        ? launch<T, 32, true>(ue, items_t, sstar, maskp, rank, B, d, ipad, s)
        : launch<T, 32, false>(ue, items_t, sstar, maskp, rank, B, d, ipad, s);
  if (rows_per_block == 64)
    return items_on_x
        ? launch<T, 64, true>(ue, items_t, sstar, maskp, rank, B, d, ipad, s)
        : launch<T, 64, false>(ue, items_t, sstar, maskp, rank, B, d, ipad, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ue: (B, d), items_t: (d, ipad), both f32 (in_bf16 = 0) or bf16; sstar:
// (B,) f32; maskp: (B, ipad/32) uint32; rank: (B,) int32, zeroed by the
// caller. ipad is a multiple of 4096. rows_per_block (32 or 64) and
// items_on_x (0: row tiles on blockIdx.x; 1: item blocks) pick P1's
// instantiation.
extern "C" int sml_masked_rank(const void* ue, const void* items_t,
                               int in_bf16, const void* sstar,
                               const void* maskp, void* rank, int B, int d,
                               int ipad, int rows_per_block, int items_on_x,
                               void* stream) {
  if (B < 0 || d <= 0 || ipad < 0 || ipad % I_BLK != 0)
    return (int)cudaErrorInvalidValue;
  const auto* ss = static_cast<const float*>(sstar);
  const auto* mp = static_cast<const uint32_t*>(maskp);
  auto* rk = static_cast<int*>(rank);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch_variant<__nv_bfloat16>(ue, items_t, ss, mp, rk, B, d, ipad,
                                         rows_per_block, items_on_x, s);
  return launch_variant<float>(ue, items_t, ss, mp, rk, B, d, ipad,
                               rows_per_block, items_on_x, s);
}
