// K2 masked_rank_gather_kernel: masked leave-one-out rank counts by
// compacting each row's mask and gathering the set items' table rows.
//
// Replaces the Pallas TPU kernel sml_tpu/ops/eval_kernel.py
// masked_rank_pallas (kernel body _kernel, :133-156). For each eval row b:
//
//   rank[b] = #{ i : bit(mask[b], i) and ue[b] . items[i, :] > sstar[b] }
//
// strictly greater, scores as f32 sums (bf16 inputs widened on load). The
// mask covers the row's negatives only, so the target never compares with
// itself; sstar comes from the caller. Mask layout (unchanged from the JAX
// package, so masks compare word for word): bit k of uint32 word jb*128 + w
// marks item jb*4096 + k*128 + w. The item table is row-major, (I_pad, d):
// a candidate's row is d contiguous values, so a gather touches d*itemsize /
// 128 cache lines per candidate instead of d.
//
// Bound on an H100 SXM. The function needs the scores of the set mask bits
// only: 2*d*popcount(mask) operations, against (B*d + I_pad*d)*itemsize +
// B*I_pad/8 + 8*B bytes (ue, the item table, the mask, sstar, rank). At
// B=1024, d=64, I_pad=20,480 and 999 negatives per row that is 0.13 GFLOP
// (0.002 ms at 67 TFLOP/s, f32 outside the tensor cores) against ~8.1 MB
// (0.0024 ms at 3.35 TB/s): bound by bytes at ~0.0024 ms per call. Each
// gathered row meets one user vector, about 0.5 operations per byte, so
// tensor cores cannot help. The table (5.2 MB in f32 at 20,480 x 64) stays
// in the 50 MB L2, so the floor of a gather design is L2 bandwidth: 1024 x
// 999 rows of 256 bytes = 262 MB per call, ~0.056 ms at the ~4.7 TB/s that
// P2's gather reached from L2 on this card (csrc/candidate_scores.cu; half
// that in bf16).
//
// Design (csrc/gather_rank.cuh): one block per eval row (B blocks, not the
// 160 row-tile x item-block blocks of the dense design at B=1024); the 8
// warps split the row's I_pad/32 words into spans of 16-byte chunks. A lane
// loads one chunk (4 words) per round; each half word is compacted into
// the warp's list of item ids, and the list is scored with 8 lanes per
// candidate, each lane reading 16-byte vectors of the candidate's row (two
// for a 256-byte f32 row at d=64, one for bf16) against its slice of the
// user vector in registers (16 lanes per candidate, one f32 vector each,
// measured slower on an H100: PERF.md). Rows whose width is not whole
// 16-byte vectors (or not 16-byte aligned) take ScalarScorer in the same
// kernel.
// The per-warp counts are summed in shared memory and rank[b] is stored
// once, without atomics, so the caller need not zero it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gather_rank.cuh"

namespace {

using namespace gather_rank;

constexpr int I_BLK = 4096;          // items per 128-word mask block
constexpr int CHUNK_ITEMS = 128;     // items whose bits share 16 bytes

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS) masked_rank_gather_kernel(
    const T* __restrict__ ue, const T* __restrict__ items,
    const float* __restrict__ sstar, const uint4* __restrict__ maskp,
    int* __restrict__ rank, int d, int ipad) {
  __shared__ int lists[WARPS][CAP];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const S s(items, ue + (size_t)b * d, d, lane);
  const float thr = sstar[b];
  const int chunks = ipad / CHUNK_ITEMS;      // 16-byte chunks per mask row
  const uint4* mrow = maskp + (size_t)b * chunks;
  const int hi = (warp + 1) * chunks / WARPS;
  int* list = lists[warp];
  int n = 0, cnt = 0;
  auto flush = [&](int m) { cnt += score_list(s, list, m, thr, lane); };
  for (int c0 = warp * chunks / WARPS; c0 < hi; c0 += 32) {
    const int c = c0 + lane;
    const uint4 m = c < hi ? __ldg(mrow + c) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t words[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gw = 4 * c + q;                // word index in the row
      const int base = ((gw >> 7) << 12) | (gw & 127);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        append(list, n, (words[q] >> (16 * h)) & 0xffffu, lane,
               [&](int k) { return base | ((k + 16 * h) << 7); }, flush);
    }
  }
  flush(n);
  store_block_count(cnt, rank + b);
}

template <typename T, typename S>
int run(const void* ue, const void* items, const float* sstar,
        const void* maskp, int* rank, int B, int d, int ipad,
        cudaStream_t stream) {
  masked_rank_gather_kernel<T, S><<<B, THREADS, 0, stream>>>(
      static_cast<const T*>(ue), static_cast<const T*>(items), sstar,
      static_cast<const uint4*>(maskp), rank, d, ipad);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Pick the scorer: 16-byte vectors where the rows allow them (VPL vectors
// per lane of each 8-lane group), else scalar loads.
template <typename T>
int dispatch(const void* ue, const void* items, const float* sstar,
             const void* maskp, int* rank, int B, int d, int ipad,
             cudaStream_t s) {
  const int row_bytes = d * (int)sizeof(T);
  if (row_bytes % 16 == 0 && aligned16(ue) && aligned16(items)) {
    const int per_lane = (row_bytes / 16 + G - 1) / G;
    switch (per_lane) {
      case 1:
        return run<T, VecScorer<T, 1>>(ue, items, sstar, maskp, rank, B, d,
                                       ipad, s);
      case 2:
        return run<T, VecScorer<T, 2>>(ue, items, sstar, maskp, rank, B, d,
                                       ipad, s);
      case 3:
      case 4:
        return run<T, VecScorer<T, 4>>(ue, items, sstar, maskp, rank, B, d,
                                       ipad, s);
      case 5:
      case 6:
      case 7:
      case 8:
        return run<T, VecScorer<T, 8>>(ue, items, sstar, maskp, rank, B, d,
                                       ipad, s);
      default:
        break;
    }
  }
  return run<T, ScalarScorer<T>>(ue, items, sstar, maskp, rank, B, d, ipad,
                                 s);
}

}  // namespace

// ue: (B, d), items: (ipad, d) row-major, both f32 (in_bf16 = 0) or bf16;
// sstar: (B,) f32; maskp: (B, ipad/32) uint32, 16-byte aligned; rank: (B,)
// int32, written (not accumulated). ipad is a multiple of 4096.
extern "C" int sml_masked_rank_gather(const void* ue, const void* items,
                                      int in_bf16, const void* sstar,
                                      const void* maskp, void* rank, int B,
                                      int d, int ipad, void* stream) {
  if (B < 0 || d <= 0 || ipad < 0 || ipad % I_BLK != 0 || !aligned16(maskp))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const auto* ss = static_cast<const float*>(sstar);
  auto* rk = static_cast<int*>(rank);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return dispatch<__nv_bfloat16>(ue, items, ss, maskp, rk, B, d, ipad, s);
  return dispatch<float>(ue, items, ss, maskp, rk, B, d, ipad, s);
}
