// K2 masked_rank_kernel: masked leave-one-out rank counts.
//
// Replaces the Pallas TPU kernel sml_tpu/ops/eval_kernel.py
// masked_rank_pallas (kernel body _kernel, :133-156). For each eval row b:
//
//   rank[b] = #{ i : bit(mask[b], i) and ue[b] . items_t[:, i] > sstar[b] }
//
// strictly greater; the (B, I) score matrix is never written out. The mask
// covers the row's negatives only, so the target never compares with
// itself. Mask layout (unchanged from the JAX package, so masks compare word
// for word): bit k of uint32 word jb*128 + w marks item jb*4096 + k*128 + w.
//
// Bound on an H100 SXM. The function needs the scores of the set mask bits
// only: 2*d*popcount(mask) operations, against (B*d + d*I_pad)*itemsize +
// B*I_pad/8 + 8*B bytes (ue, the item table, the mask, sstar, rank). At
// B=1024, d=64, I_pad=20,480 and 999 negatives per row that is 0.13 GFLOP
// (0.002 ms at 67 TFLOP/s, f32 outside the tensor cores) against ~8.1 MB
// (0.0024 ms at 3.35 TB/s): bound by bytes at ~0.0024 ms per call. This
// design scores every column densely, 2*B*d*I_pad = 2.68 GFLOP, whose floor
// is 0.040 ms; only a design that skips the unmasked columns can go below it.
//
// Design: a 2-D grid of (32-row tiles) x (4096-item mask blocks), so the
// blocks are independent (the TPU kernel summed over the item axis in
// sequence; here blocks run in no order). A block stages its 32 user rows
// in shared memory (k-major), loads its 32x128 mask words once into
// registers (each thread owns 4 rows x 4 lanes), then walks the 32 bit
// planes: per plane it stages the d x 128 item tile, computes a 4x4
// register tile of f32 scores (fmaf, no tensor cores, no TF32), and counts
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

constexpr int RB = 32;         // eval rows per block
constexpr int THREADS = 256;   // warp w owns rows 4w..4w+3 of the tile
constexpr int LANES = 128;     // items per bit plane
constexpr int PLANES = 32;     // bits per mask word
constexpr int I_BLK = LANES * PLANES;

__device__ __forceinline__ float widen(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) masked_rank_kernel(
    const T* __restrict__ ue, const T* __restrict__ items_t,
    const float* __restrict__ sstar, const uint32_t* __restrict__ maskp,
    int* __restrict__ rank, int B, int d, int ipad) {
  extern __shared__ __align__(16) float smem[];
  float* ueT = smem;              // [d][RB]
  float* its = smem + d * RB;     // [d][LANES]

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int row0 = blockIdx.x * RB;
  const int jb = blockIdx.y;
  const int words = ipad / PLANES;

  for (int i = tid; i < RB * d; i += THREADS) {
    const int r = i / d, k = i - r * d;
    const int gr = row0 + r;
    ueT[k * RB + r] = gr < B ? widen(ue, (size_t)gr * d + k) : 0.f;
  }

  float ss[4];
  uint32_t mw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gr = row0 + ty * 4 + r;
    ss[r] = gr < B ? sstar[gr] : INFINITY;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      mw[r][m] = gr < B
          ? maskp[(size_t)gr * words + jb * LANES + tx + 32 * m] : 0u;
  }

  int cnt[4] = {0, 0, 0, 0};
  for (int k = 0; k < PLANES; ++k) {
    __syncthreads();   // ueT staged; the previous plane's tile consumed
    const size_t base = (size_t)jb * I_BLK + k * LANES;
    for (int i = tid; i < d * LANES; i += THREADS) {
      const int dd = i / LANES, w = i - dd * LANES;
      its[i] = widen(items_t, (size_t)dd * ipad + base + w);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float4 u = *reinterpret_cast<const float4*>(&ueT[dd * RB + ty * 4]);
      const float* it = its + dd * LANES + tx;
      const float v[4] = {it[0], it[32], it[64], it[96]};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[0][m] = fmaf(u.x, v[m], acc[0][m]);
        acc[1][m] = fmaf(u.y, v[m], acc[1][m]);
        acc[2][m] = fmaf(u.z, v[m], acc[2][m]);
        acc[3][m] = fmaf(u.w, v[m], acc[3][m]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        cnt[r] += (int)((((mw[r][m] >> k) & 1u) != 0u) && (acc[r][m] > ss[r]));
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int c = cnt[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    const int gr = row0 + ty * 4 + r;
    if (tx == 0 && c != 0 && gr < B) atomicAdd(&rank[gr], c);
  }
}

template <typename T>
int launch(const void* ue, const void* items_t, const float* sstar,
           const uint32_t* maskp, int* rank, int B, int d, int ipad,
           cudaStream_t stream, size_t smem) {
  static std::atomic<uint64_t> smem_ready{0};
  const cudaError_t err = allow_max_smem(masked_rank_kernel<T>, smem_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + RB - 1) / RB, ipad / I_BLK);
  masked_rank_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(items_t), sstar, maskp,
      rank, B, d, ipad);
  return (int)cudaGetLastError();
}

}  // namespace

// ue: (B, d), items_t: (d, ipad), both f32 (in_bf16 = 0) or bf16; sstar:
// (B,) f32; maskp: (B, ipad/32) uint32; rank: (B,) int32, zeroed by the
// caller. ipad is a multiple of 4096.
extern "C" int sml_masked_rank(const void* ue, const void* items_t,
                               int in_bf16, const void* sstar,
                               const void* maskp, void* rank, int B, int d,
                               int ipad, void* stream) {
  if (B < 0 || d <= 0 || ipad < 0 || ipad % I_BLK != 0 ||
      ipad / I_BLK > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)d * (RB + LANES) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (B == 0 || ipad == 0) return (int)cudaSuccess;
  const auto* ss = static_cast<const float*>(sstar);
  const auto* mp = static_cast<const uint32_t*>(maskp);
  auto* rk = static_cast<int*>(rank);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(ue, items_t, ss, mp, rk, B, d, ipad, s, smem);
  return launch<float>(ue, items_t, ss, mp, rk, B, d, ipad, s, smem);
}
