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
// target's score s* is computed by the scorer that computes every
// candidate's score, with the same lane layout and the same order of
// operations (the TPU kernel took s* from the same score tiles for the same
// reason). Each product of two bf16 values is exact in f32, so fmaf and a
// multiply-add round alike and only the (fixed) order of the sums matters.
//
// Bound on an H100 SXM. The function reads the int8 mask (B*I_pad bytes),
// the bf16 table (I_pad*d*2), ue (B*d*2) and tgt, and writes rank; it needs
// the scores of the set mask entries only, 2*d*(popcount + B) operations.
// At B=1024, I_pad=20,480, d=64 and 1,001 candidates per row: ~23.8 MB,
// 0.0071 ms at 3.35 TB/s, against 0.131 GFLOP (0.002 ms even at the f32
// rate): bound by bytes. The 2.6 MB table stays in the 50 MB L2, so the
// floor of a gather design is L2 bandwidth: 1024 x 1,001 rows of 128 bytes
// = 131 MB, ~0.028 ms at the ~4.7 TB/s that P2's gather reached from L2 on
// this card (csrc/candidate_scores.cu).
//
// The TPU kernel scored every column twice (one pass for s*, one for the
// count), 2*2*B*I_pad*d = 5.4 GFLOP. This kernel scores only the set
// entries (csrc/gather_rank.cuh): one block per row, the 8 warps split the
// row's mask into spans of 16-byte chunks; each lane loads ROUNDS chunks at
// a time, turns the nonzero bytes of each into item ids in its warp's list,
// and 8 lanes score each listed candidate, one 16-byte load of its 128-byte
// row each, against 8 user values held in registers (P2's layout). Every
// warp scores the target the same way first, so every lane holds s*. The
// per-warp counts are summed in shared memory and rank[b] is stored once,
// without atomics. A target id outside [0, I_pad) gives s* = 0, as the TPU
// kernel's one-hot sum does.
//
// The mask reaches the warps by coalesced 16-byte loads from global memory,
// two chunks per lane in flight. A 1-D bulk copy (cp.async.bulk on an
// mbarrier) of each warp's span into shared memory, issued at block start
// to overlap the target's score, was timed against it on an H100 and left
// out: within 3% either way across runs (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_rank.cuh"

namespace {

using namespace gather_rank;

constexpr int DIM = 64;                    // latent width (the probe's DIM)
constexpr int CHUNK = 16;                  // mask bytes per 16-byte load
constexpr int ROUNDS = 2;                  // mask loads per lane in flight
using Scorer = VecScorer<__nv_bfloat16, 1>;   // 8 lanes x 16 bytes a row

// Bit k set where byte k of the 16-byte chunk is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(const uint4 m) {
  const uint32_t w[4] = {m.x, m.y, m.z, m.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // 0x01/0x02/0x04/0x08 in the nonzero bytes, summed into the top byte
    const uint32_t t = __vcmpne4(w[q], 0u) & 0x08040201u;
    bits |= ((t * 0x01010101u) >> 24) << (4 * q);
  }
  return bits;
}

__global__ void __launch_bounds__(THREADS) dense_mask_rank_kernel(
    const __nv_bfloat16* __restrict__ ue, const int* __restrict__ tgt,
    const int8_t* __restrict__ maskm, const __nv_bfloat16* __restrict__ table,
    int* __restrict__ rank, int ipad) {
  __shared__ int lists[WARPS][CAP];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = ipad / CHUNK;
  const int lo = warp * chunks / WARPS;
  const int hi = (warp + 1) * chunks / WARPS;
  const uint4* mrow = reinterpret_cast<const uint4*>(maskm + (size_t)b * ipad);

  const Scorer s(table, ue + (size_t)b * DIM, DIM, lane);
  const int t = tgt[b];
  const bool in_range = t >= 0 && t < ipad;
  Scorer::Regs row;
  s.fetch(in_range ? t : 0, in_range, row);
  const float st = s.dot(row);
  const float ss = in_range ? st : 0.f;

  int* list = lists[warp];
  int n = 0, cnt = 0;
  auto flush = [&](int m) { cnt += score_list(s, list, m, ss, lane); };
  for (int c0 = lo; c0 < hi; c0 += 32 * ROUNDS) {
    uint4 m[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = c0 + 32 * r + lane;
      m[r] = c < hi ? __ldg(mrow + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int c = c0 + 32 * r + lane;
      append(list, n, nonzero_bytes(m[r]), lane,
             [&](int k) { return CHUNK * c + k; }, flush);
    }
  }
  flush(n);
  store_block_count(cnt, rank + b);
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
  auto s = static_cast<cudaStream_t>(stream);
  dense_mask_rank_kernel<<<B, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(ue), static_cast<const int*>(tgt),
      static_cast<const int8_t*>(maskm),
      static_cast<const __nv_bfloat16*>(table), static_cast<int*>(rank),
      ipad);
  return (int)cudaGetLastError();
}
