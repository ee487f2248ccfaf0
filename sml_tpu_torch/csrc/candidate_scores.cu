// P2 candidate_scores_kernel: the eval-design probe's scorer, whole, in one
// launch: gather each row's user vector and its candidates' table rows, and
// score them.
//
// Replaces the Pallas TPU kernel of the eval-design probe
// scripts/eval_variants.py make_pallas_scorer (scorer :155, kernel :146-153,
// the user gather ue_t[users] :157). For each eval row b and candidate c:
//
//   out[b, c] = sum_k ue_t[u(users[b]), k] * table[i(cand[b, c]), k]
//
// with bf16 inputs and f32 sums, DIM = 64. The ids follow the JAX function:
// u() wraps a user id in [-U, 0) and then clamps it into [0, U-1] (jnp
// indexing); i() wraps a candidate id in [-I, 0) (take_along_axis), and any
// other candidate id outside [0, I) scores NaN and reads no memory. A product
// of two bf16 values is exact in f32, so this kernel and its plain version
// differ only in the order of the sums (integer tables: not at all).
//
// Bound on an H100 SXM: by bytes. The function reads the ids (B*C of the
// dtype it is given), each distinct table row and user row once (128 bytes
// each) and writes out (B*C*4): at B=1024, C=1001, I=20,000 about 10.9 MB
// with int32 ids (0.0033 ms at 3.35 TB/s), 15 MB with int64 ones; 2*B*C*DIM
// = 0.131 GFLOP is 0.002 ms even at the f32 rate. A gather design reads one
// 128-byte table row per candidate, B*C*128 = 131 MB at that shape; the
// 2.56 MB bf16 table stays in the 50 MB L2, so its floor is that traffic
// over the L2 rate, about 6x the bound (chip_smoke.py prints both). The
// TPU scored all I items per row and picked the candidates (20x the
// operations); the card gathers only the candidates.
//
// Design. The gather's rows come from L2, but what bounds this kernel is
// the instructions that widen, multiply and sum them (chip_smoke.py's P2
// phase times a call in which every row read hits L1 beside the real one):
// * Work items of one row's 32 consecutive candidates, split into one
//   contiguous range per warp over a grid of one wave (SMs x resident blocks
//   from the occupancy API): a warp moves along its rows, so it loads a user
//   row only where its range enters a new row.
// * Ids first: a warp loads the next item's 32 ids (one coalesced load, one
//   id a lane, any stride) and, where it enters a new row, the next user id,
//   before it issues this item's table loads; at the item's start the ids
//   are checked, wrapped and staged in shared memory as row numbers (-1 for
//   NaN). No table load waits on a global id load, except the first item's.
// * Loads in flight: lane `sub` of an 8-lane group reads the 16-byte vector
//   `sub` of its group's 8 candidate rows, all 8 loads issued before any is
//   consumed (8 x 16 bytes in flight per thread), through the read-only path.
//   When a warp vote finds every id of the item in range (the usual case)
//   the loads carry no predicate; otherwise an id that scores NaN loads
//   nothing.
// * Sums and stores: each lane holds 8 partial sums, one per candidate of its
//   group. A transposing butterfly (xor 4, 2, 1: 4 + 2 + 1 shuffles) halves
//   the values a lane keeps at each level, so lane `sub` ends with the whole
//   sum of its group's candidate `sub`: lane l holds candidate l of the item,
//   the lane that staged its id, and the warp stores the item as one run of
//   32 consecutive floats (NaN where that id is out of range), for any C and
//   any alignment of out's rows, with no trip through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int DIM = 64;                  // latent width (the probe's DIM)
constexpr int VEC = DIM / 8;             // 16-byte vectors per row: 8
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ITEM = 32;                 // candidates per warp item
constexpr int PER_GROUP = ITEM / 4;      // candidates per 8-lane group: 8
constexpr unsigned FULL = 0xffffffffu;

static_assert(VEC == 8 && PER_GROUP == 8,
              "the butterfly pairs 8 lanes with 8 candidates");

// The 8 bf16 values of a 16-byte vector, widened to f32 (exact).
__device__ __forceinline__ void widen8(const uint4 raw, float (&out)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// A candidate id -> its table row, or -1 for an id that scores NaN.
template <typename Id>
__device__ __forceinline__ int item_row(Id id, int n_items) {
  long long v = static_cast<long long>(id);
  if (v < 0) v += n_items;
  return (v >= 0 && v < n_items) ? static_cast<int>(v) : -1;
}

// A user id -> its table row: wrapped, then clamped (n_users > 0).
template <typename Id>
__device__ __forceinline__ int user_row(Id id, int n_users) {
  long long v = static_cast<long long>(id);
  if (v < 0) v += n_users;
  return static_cast<int>(v < 0 ? 0 : (v >= n_users ? n_users - 1 : v));
}

template <typename UId, typename CId>
__global__ void __launch_bounds__(THREADS) candidate_scores_kernel(
    const uint4* __restrict__ ue_t, int n_users,
    const UId* __restrict__ users, long long su,
    const CId* __restrict__ cand, long long sb, long long sc,
    const uint4* __restrict__ table, int n_items, float* __restrict__ out,
    int C, int chunks, long long n_work) {
  __shared__ __align__(16) int rows_s[WARPS][ITEM];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & 7;
  const int* grp_rows = &rows_s[warp][lane & ~7];
  const uint4* tab = table + sub;     // this lane's vector of every row

  const long long gw = (long long)blockIdx.x * WARPS + warp;
  const long long nw = (long long)gridDim.x * WARPS;
  const long long per = n_work / nw, extra = n_work % nw;
  long long w = gw * per + (gw < extra ? gw : extra);
  const long long end = w + per + (gw < extra ? 1 : 0);
  if (w >= end) return;

  long long b = w / chunks;
  int c0 = static_cast<int>(w % chunks) * ITEM;
  const CId* crow = cand + b * sb;
  CId id = 0;
  if (c0 + lane < C) id = crow[(long long)(c0 + lane) * sc];
  UId uid_next = users[b * su];
  bool new_row = true;
  float u[8];

  for (;;) {
    // stage this item's ids as table rows (-1: NaN, or past C)
    __syncwarp();
    const int my_row = c0 + lane < C ? item_row(id, n_items) : -1;
    rows_s[warp][lane] = my_row;
    const bool all_valid = __all_sync(FULL, my_row >= 0);
    __syncwarp();

    // the next item's ids, and its user id where it enters a new row
    const bool has_next = w + 1 < end;
    int nc0 = c0 + ITEM;
    const bool next_row = nc0 >= C;
    if (next_row) nc0 = 0;
    const CId* ncrow = next_row ? crow + sb : crow;
    const UId uid = uid_next;
    if (has_next) {
      if (nc0 + lane < C) id = ncrow[(long long)(nc0 + lane) * sc];
      if (next_row) uid_next = users[(b + 1) * su];
    }

    // this lane's 16-byte vector of its group's 8 candidate rows
    const int4 r0 = *reinterpret_cast<const int4*>(grp_rows);
    const int4 r1 = *reinterpret_cast<const int4*>(grp_rows + 4);
    const int row[PER_GROUP] = {r0.x, r0.y, r0.z, r0.w,
                                r1.x, r1.y, r1.z, r1.w};
    uint4 raw[PER_GROUP];
    if (all_valid) {
#pragma unroll
      for (int q = 0; q < PER_GROUP; ++q)
        raw[q] = __ldg(tab + (size_t)(unsigned)row[q] * VEC);
    } else {
#pragma unroll
      for (int q = 0; q < PER_GROUP; ++q)
        raw[q] = row[q] >= 0 ? __ldg(tab + (size_t)(unsigned)row[q] * VEC)
                             : make_uint4(0u, 0u, 0u, 0u);
    }
    if (new_row)
      widen8(__ldg(ue_t + (size_t)user_row(uid, n_users) * VEC + sub), u);

    float part[PER_GROUP];
#pragma unroll
    for (int q = 0; q < PER_GROUP; ++q) {
      float v[8];
      widen8(raw[q], v);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc = fmaf(u[j], v[j], acc);
      part[q] = acc;
    }

    // transposing butterfly: lane `sub` ends with candidate `sub`'s sum
    const bool h4 = sub & 4, h2 = sub & 2, h1 = sub & 1;
    float t4[4], t2[2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float keep = h4 ? part[q + 4] : part[q];
      const float send = h4 ? part[q] : part[q + 4];
      t4[q] = keep + __shfl_xor_sync(FULL, send, 4);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float keep = h2 ? t4[q + 2] : t4[q];
      const float send = h2 ? t4[q] : t4[q + 2];
      t2[q] = keep + __shfl_xor_sync(FULL, send, 2);
    }
    const float score = (h1 ? t2[1] : t2[0]) +
                        __shfl_xor_sync(FULL, h1 ? t2[0] : t2[1], 1);
    if (c0 + lane < C)
      out[b * C + c0 + lane] =
          my_row >= 0 ? score : __int_as_float(0x7fc00000);

    if (!has_next) break;
    new_row = next_row;
    b += next_row;
    crow = ncrow;
    c0 = nc0;
    ++w;
  }
}

// Blocks of one full wave of `kernel` on the current device: SMs x resident
// blocks per SM, queried once per device and instantiation.
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, std::atomic<int> (&cache)[64],
                        int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (blocks = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (err != cudaSuccess) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cache[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

template <typename UId, typename CId>
cudaError_t launch(const void* ue_t, int n_users, const void* users,
                   long long su, const void* cand, long long sb, long long sc,
                   const void* table, int n_items, void* out, int B, int C,
                   cudaStream_t stream) {
  static std::atomic<int> cache[64];
  const auto kernel = candidate_scores_kernel<UId, CId>;
  int wave = 0;
  const cudaError_t err = wave_blocks(kernel, cache, wave);
  if (err != cudaSuccess) return err;
  const int chunks = (C + ITEM - 1) / ITEM;
  const long long n_work = (long long)B * chunks;
  long long blocks = (n_work + WARPS - 1) / WARPS;
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(ue_t), n_users,
      static_cast<const UId*>(users), su, static_cast<const CId*>(cand), sb,
      sc, static_cast<const uint4*>(table), n_items,
      static_cast<float*>(out), C, chunks, n_work);
  return cudaGetLastError();
}

}  // namespace

// ue_t: (n_users, 64) bf16, n_users > 0; users: B ids at stride su; cand:
// (B, C) ids at strides (sb, sc); ids int32, or int64 where *_is64; table:
// (n_items, 64) bf16; out: (B, C) f32, contiguous. Strides in elements;
// both tables contiguous and 16-byte aligned (checked by the caller).
extern "C" int sml_candidate_scores(const void* ue_t, int n_users,
                                    const void* users, int64_t su,
                                    int users_is64, const void* cand,
                                    int64_t sb, int64_t sc, int cand_is64,
                                    const void* table, int n_items, void* out,
                                    int B, int C, void* stream) {
  if (B < 0 || C < 0 || n_items < 0 || n_users <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (users_is64)
    err = cand_is64 ? launch<int64_t, int64_t>(ue_t, n_users, users, su, cand,
                                               sb, sc, table, n_items, out, B,
                                               C, s)
                    : launch<int64_t, int32_t>(ue_t, n_users, users, su, cand,
                                               sb, sc, table, n_items, out, B,
                                               C, s);
  else
    err = cand_is64 ? launch<int32_t, int64_t>(ue_t, n_users, users, su, cand,
                                               sb, sc, table, n_items, out, B,
                                               C, s)
                    : launch<int32_t, int32_t>(ue_t, n_users, users, su, cand,
                                               sb, sc, table, n_items, out, B,
                                               C, s);
  return (int)err;
}
