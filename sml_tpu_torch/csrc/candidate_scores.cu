// P2 candidate_scores_kernel: per-row candidate scores by a gather-dot.
//
// Replaces the Pallas TPU kernel of the eval-design probe
// scripts/eval_variants.py make_pallas_scorer (kernel :146-153, call :160).
// For each eval row b and candidate slot c:
//
//   out[b, c] = sum_k ue[b, k] * table[cand[b, c], k]
//
// with bf16 inputs and f32 sums. A product of two bf16 values is exact in
// f32, so this kernel and its plain version differ only in the order of the
// sums.
//
// Bound on an H100 SXM. The function reads cand (B*C*4 bytes), ue (B*d*2),
// the table rows the candidates name (128 bytes each, every distinct row
// once) and writes out (B*C*4). At B=1024, C=1001, I=20,000, d=64 that is
// ~10.9 MB, 0.0033 ms at 3.35 TB/s, against 2*B*C*d = 0.131 GFLOP (0.002
// ms even at the f32 rate of 67 TFLOP/s): bound by bytes.
//
// The TPU kernel scored every item of the table for every row, 2*B*I*d =
// 2.6 GFLOP, and then picked the candidate columns, because its matrix unit
// cannot gather. The card can: this kernel scores only the B*C candidates.
// One block per eval row; each thread holds 8 of the row's 64 user values in
// registers, and 8 neighbouring lanes read one candidate's 128-byte table
// row with one 16-byte load each (a warp reads 4 whole rows per load), so
// every load is a full cache line. The 2.56 MB bf16 table stays in the
// 50 MB L2. The 8 partial dot products are summed with shuffles and lane 0
// of the group writes the score. A candidate id outside [0, n_items) scores
// 0 and reads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DIM = 64;                    // latent width (the probe's DIM)
constexpr int THREADS = 256;
constexpr int TPC = DIM / 8;               // lanes per candidate: 8 x 8 bf16
constexpr int CPW = 32 / TPC;              // candidates per warp step
constexpr int CPB = (THREADS / 32) * CPW;  // candidates per block step

__device__ __forceinline__ void widen8(const uint4 raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__global__ void __launch_bounds__(THREADS) candidate_scores_kernel(
    const __nv_bfloat16* __restrict__ ue, const int* __restrict__ cand,
    const __nv_bfloat16* __restrict__ table, float* __restrict__ out, int C,
    int n_items) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % TPC;    // which 8 of the 64 dims
  const int slot = lane / TPC;   // which candidate of the warp's step
  float u[8];
  widen8(reinterpret_cast<const uint4*>(ue + (size_t)b * DIM)[sub], u);
  const int* crow = cand + (size_t)b * C;
  float* orow = out + (size_t)b * C;
  const uint4* tab = reinterpret_cast<const uint4*>(table);
  for (int c0 = 0; c0 < C; c0 += CPB) {
    const int c = c0 + warp * CPW + slot;
    float acc = 0.f;
    if (c < C) {
      const int item = crow[c];
      if ((unsigned)item < (unsigned)n_items) {
        float v[8];
        widen8(tab[(size_t)item * TPC + sub], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = fmaf(u[k], v[k], acc);
      }
    }
#pragma unroll
    for (int o = TPC / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (sub == 0 && c < C) orow[c] = acc;
  }
}

}  // namespace

// ue: (B, 64) bf16; cand: (B, C) int32; table: (n_items, 64) bf16; out:
// (B, C) f32. ue and table 16-byte aligned (checked by the caller).
extern "C" int sml_candidate_scores(const void* ue, const void* cand,
                                    const void* table, void* out, int B,
                                    int C, int n_items, void* stream) {
  if (B < 0 || C < 0 || n_items < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  candidate_scores_kernel<<<B, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ue), static_cast<const int*>(cand),
      static_cast<const __nv_bfloat16*>(table), static_cast<float*>(out), C,
      n_items);
  return (int)cudaGetLastError();
}
