// Warp-cooperative "compact the mask, gather-score the candidates" device
// code, shared by the two masked-rank kernels: K2
// (csrc/masked_rank_gather.cu, a packed bit mask, f32 or bf16 tables) and
// P3 (csrc/dense_mask_rank.cu, an int8 mask, bf16 tables).
//
// A block owns one eval row; its WARPS warps split the row's mask into
// contiguous spans of 16-byte chunks. A warp walks its span in rounds of
// one 16-byte load per lane, turns the round's set entries into item ids in
// its own list in shared memory (append), and scores the list (score_list)
// when it is full and at the end. The per-warp counts meet in shared memory
// and the block stores its row's rank once (store_block_count): no atomics.
//
// (a) Compaction. append() takes at most 16 set bits per lane (K2: half of
// one mask word; P3: the nonzero bytes of one 16-byte chunk), so one call
// adds at most 32 x 16 = 512 ids, which is the list's capacity CAP: the list
// is scored first whenever a call would overflow it. A row with every entry
// set works, and shared memory does not depend on how dense the mask is.
// Each lane counts its bits with __popc; an inclusive warp scan by shuffles
// gives each lane its first slot.
//
// (b) Group dot. G = 8 lanes score one candidate. Lane `sub` of a group
// holds the user vector's 16-byte vectors sub, sub + G, sub + 2G, ...
// (widened to f32) in registers and reads the same vectors of the
// candidate's table row with 16-byte loads, so neighbouring lanes read
// neighbouring bytes of one row. The G partial sums meet in an xor
// butterfly: every lane of the group ends with the same bits (IEEE addition
// commutes), and every group of every warp computes a given row's score by
// the same operations in the same order, so a row's score compared with
// itself compares equal.
// ScalarScorer is the same layout with 4- or 2-byte loads, for a width whose
// rows are not whole 16-byte vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gather_rank {

constexpr int WARPS = 8;                 // warps per block (one eval row)
constexpr int THREADS = 32 * WARPS;
constexpr int CAP = 512;                 // ids per warp list
constexpr int G = 8;                     // lanes per candidate
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One 16-byte vector of a table row, widened to f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void widen(const uint4 r,
                                               float (&out)[N]) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void widen(const uint4 r,
                                               float (&out)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      out[2 * k] = f.x;
      out[2 * k + 1] = f.y;
    }
  }
};

// Sum over the G lanes of a group; every lane of the group gets the sum.
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Scores with 16-byte loads: rows of d * sizeof(T) bytes, a multiple of 16,
// at 16-byte aligned addresses. VPL vectors per lane (ceil(vectors / G),
// rounded up to a power of two); U candidates per lane in flight, so that
// about four 16-byte loads per lane are outstanding.
template <typename T, int VPL>
struct VecScorer {
  static constexpr int N = Vec16<T>::N;
  static constexpr int U = VPL >= 4 ? 1 : 4 / VPL;
  struct Regs {
    uint4 v[VPL];
  };
  const uint4* tab;
  int nvec;      // 16-byte vectors per row
  int sub;       // this lane's place in its group
  float u[VPL][N];

  __device__ __forceinline__ VecScorer(const T* table, const T* urow, int d,
                                       int lane)
      : tab(reinterpret_cast<const uint4*>(table)),
        nvec(d * (int)sizeof(T) / 16),
        sub(lane % G) {
    const uint4* ur = reinterpret_cast<const uint4*>(urow);
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      if (sub + p * G < nvec) {
        Vec16<T>::widen(ur[sub + p * G], u[p]);
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k) u[p][k] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void fetch(int id, bool ok, Regs& r) const {
    const uint4* row = tab + (size_t)id * nvec;
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      const int vi = sub + p * G;
      r.v[p] = (ok && vi < nvec) ? __ldg(row + vi)
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ float dot(const Regs& r) const {
    float acc = 0.f;
#pragma unroll
    for (int p = 0; p < VPL; ++p) {
      if (sub + p * G < nvec) {
        float v[N];
        Vec16<T>::widen(r.v[p], v);
#pragma unroll
        for (int k = 0; k < N; ++k) acc = fmaf(u[p][k], v[k], acc);
      }
    }
    return group_sum(acc);
  }
};

// The same group layout with one element per load: lane `sub` takes
// elements sub, sub + G, ... of the row.
template <typename T>
struct ScalarScorer {
  static constexpr int U = 1;
  struct Regs {
    int id;      // -1: no candidate
  };
  const T* tab;
  const T* urow;
  int d;
  int sub;

  __device__ __forceinline__ ScalarScorer(const T* table, const T* urow_,
                                          int d_, int lane)
      : tab(table), urow(urow_), d(d_), sub(lane % G) {}

  __device__ __forceinline__ void fetch(int id, bool ok, Regs& r) const {
    r.id = ok ? id : -1;
  }

  __device__ __forceinline__ float dot(const Regs& r) const {
    float acc = 0.f;
    if (r.id >= 0) {
      const T* row = tab + (size_t)r.id * d;
      for (int k = sub; k < d; k += G)
        acc = fmaf(to_f32(__ldg(urow + k)), to_f32(__ldg(row + k)), acc);
    }
    return group_sum(acc);
  }
};

// Count the first n ids of this warp's list whose score is above thr. The
// count lands in the lanes with sub == 0; every lane of the warp calls this
// with the same n.
template <typename S>
__device__ __forceinline__ int score_list(const S& s, const int* list, int n,
                                          float thr, int lane) {
  constexpr int CPW = 32 / G;            // candidates per warp step
  const int slot = lane / G;
  int cnt = 0;
  __syncwarp();                          // the list's ids are written
  for (int c0 = 0; c0 < n; c0 += CPW * S::U) {
    typename S::Regs r[S::U];
    bool ok[S::U];
#pragma unroll
    for (int j = 0; j < S::U; ++j) {
      const int c = c0 + j * CPW + slot;
      ok[j] = c < n;
      s.fetch(ok[j] ? list[c] : 0, ok[j], r[j]);
    }
#pragma unroll
    for (int j = 0; j < S::U; ++j) {
      const float x = s.dot(r[j]);
      cnt += (int)(ok[j] && s.sub == 0 && x > thr);
    }
  }
  __syncwarp();                          // read before it is rewritten
  return cnt;
}

// Append the ids of this lane's set bits (at most 16; bit k names id_of(k))
// to the warp's list of n ids. When the warp's ids would overflow CAP,
// flush(n) scores the list first and it restarts empty. Every lane of the
// warp calls this.
template <typename IdOf, typename Flush>
__device__ __forceinline__ void append(int* list, int& n, uint32_t bits,
                                       int lane, IdOf id_of, Flush flush) {
  if (__ballot_sync(FULL, bits != 0u) == 0u) return;
  const int mine = __popc(bits);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  if (n + total > CAP) {
    flush(n);
    n = 0;
  }
  int pos = n + incl - mine;
  while (bits != 0u) {
    list[pos++] = id_of(__ffs(bits) - 1);
    bits &= bits - 1u;
  }
  n += total;
}

// Sum the block's per-lane counts and store the total at *out, once.
__device__ __forceinline__ void store_block_count(int cnt, int* out) {
  __shared__ int warp_cnt[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  if ((threadIdx.x & 31) == 0) warp_cnt[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += warp_cnt[w];
    *out = total;
  }
}

}  // namespace gather_rank
