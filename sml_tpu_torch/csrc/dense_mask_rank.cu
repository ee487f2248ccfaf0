// P3 dense_mask_rank_kernel: masked rank over a dense int8 candidate mask.
//
// Replaces the Pallas TPU kernel of the eval-design probe
// scripts/eval_variants.py make_masked_rank_pallas (kernel :243-282, call
// :287). For each eval row b:
//
//   rank[b] = #{ i : maskm[b, i] != 0 and s[b, i] > s[b, tgt[b]] },
//   s = bf16(ue) . bf16(table)^T summed in f32.
//
// The mask holds ALL C+1 candidates, the target included, so the target
// meets itself in the count and that comparison must come out false: the
// target's score s* is computed by row_score, the one device function that
// computes every column's score, in the same order of operations (the TPU
// kernel took s* from the same score tiles for the same reason). Each
// product of two bf16 values is exact in f32, so fmaf and a multiply-add
// round alike and only the (fixed, sequential) order of the sums matters.
//
// Bound on an H100 SXM. The function reads the int8 mask (B*I_pad bytes),
// the bf16 table (I_pad*d*2), ue (B*d*2) and tgt, and writes rank; it needs
// the scores of the set mask entries only, 2*d*(popcount + B) operations.
// At B=1024, I_pad=20,480, d=64 and 1,001 candidates per row: ~23.8 MB,
// 0.0071 ms at 3.35 TB/s, against 0.131 GFLOP (0.002 ms even at the f32
// rate): bound by bytes.
//
// The TPU kernel scored every column twice (one pass for s*, one for the
// count), 2*2*B*I_pad*d = 5.4 GFLOP. This kernel skips the unmasked
// columns: one block per row streams the row's mask once with 16-byte
// loads, skips all-zero chunks, and scores only the set entries (~1,001 of
// 20,480), each with one thread reading the candidate's 128-byte table row
// from L2 (the 2.6 MB table stays there) against the user row in shared
// memory. Per-thread counts are summed with shuffles and one shared-memory
// pass; the block owns its row, so rank[b] is written once, without
// atomics. A target id outside [0, I_pad) gives s* = 0, as the TPU kernel's
// one-hot sum does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DIM = 64;          // latent width (the probe's DIM)
constexpr int THREADS = 256;
constexpr int CHUNK = 16;        // mask bytes per 16-byte load

__device__ __forceinline__ void widen8(const uint4 raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

// The score of table row i against the row's user vector u (shared memory):
// every score of the kernel, s* included, comes from here.
__device__ __forceinline__ float row_score(const float* __restrict__ u,
                                           const uint4* __restrict__ tab,
                                           int i) {
  const uint4* r = tab + (size_t)i * (DIM / 8);
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < DIM / 8; ++q) {
    float v[8];
    widen8(r[q], v);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fmaf(u[q * 8 + k], v[k], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS) dense_mask_rank_kernel(
    const __nv_bfloat16* __restrict__ ue, const int* __restrict__ tgt,
    const int8_t* __restrict__ maskm, const __nv_bfloat16* __restrict__ table,
    int* __restrict__ rank, int ipad) {
  __shared__ float u[DIM];
  __shared__ int warp_cnt[THREADS / 32];
  const int b = blockIdx.x;
  if (threadIdx.x < DIM)
    u[threadIdx.x] = __bfloat162float(ue[(size_t)b * DIM + threadIdx.x]);
  __syncthreads();

  const uint4* tab = reinterpret_cast<const uint4*>(table);
  const int t = tgt[b];
  const float ss = (t >= 0 && t < ipad) ? row_score(u, tab, t) : 0.f;
  const uint4* mrow = reinterpret_cast<const uint4*>(maskm + (size_t)b * ipad);
  int cnt = 0;
  for (int w = threadIdx.x; w < ipad / CHUNK; w += THREADS) {
    const uint4 m = mrow[w];
    if ((m.x | m.y | m.z | m.w) == 0u) continue;
    const uint32_t quad[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t x = quad[q];
      while (x != 0u) {
        const int byte = (__ffs(x) - 1) >> 3;
        x &= ~(0xffu << (8 * byte));
        cnt += (int)(row_score(u, tab, w * CHUNK + 4 * q + byte) > ss);
      }
    }
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += warp_cnt[w];
    rank[b] = total;
  }
}

}  // namespace

// ue: (B, 64) bf16; tgt: (B,) int32; maskm: (B, ipad) int8; table: (ipad,
// 64) bf16; rank: (B,) int32, written (not accumulated). ipad is a multiple
// of 16; ue, maskm and table are 16-byte aligned (checked by the caller).
extern "C" int sml_dense_mask_rank(const void* ue, const void* tgt,
                                   const void* maskm, const void* table,
                                   void* rank, int B, int ipad,
                                   void* stream) {
  if (B < 0 || ipad < 0 || ipad % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  dense_mask_rank_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ue), static_cast<const int*>(tgt),
      static_cast<const int8_t*>(maskm),
      static_cast<const __nv_bfloat16*>(table), static_cast<int*>(rank),
      ipad);
  return (int)cudaGetLastError();
}
