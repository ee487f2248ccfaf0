// P1 masked_rank_kernel: masked leave-one-out rank counts by dense scoring,
// the kernel of the eval-design probe (K2 itself is the gather kernel of
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
// variants); this kernel is a template over its axes:
//   T           float: scores by fmaf on the CUDA cores (no TF32, which
//               would flip ranks on real-valued tables); __nv_bfloat16:
//               scores by mma.sync on the tensor cores (bf16 products are
//               exact in f32 and are summed in f32).
//   RB          rows per block: 64 or 128 (the probe's rblk 256 and 512).
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
// floor is its dense work, 2*B*I_pad*d = 42.9 GFLOP: 0.64 ms in f32 on the
// CUDA cores, 0.043 ms in bf16 on the tensor cores; only a design that skips
// the unmasked columns goes below it (K2's gather).
//
// Design. A block owns RB rows x one 4096-item mask block and walks its 32
// bit planes of 128 items, as the TPU body does.
// - The block's RB user rows are staged in shared memory once. Each plane's
//   d x 128 item tile arrives by 16-byte cp.async copies into a ring of
//   STAGES buffers, so the next plane's copy overlaps this plane's product.
// - f32: each of the 256 threads computes an 8 x TN register tile of scores
//   (TN = 4 at RB 64, 8 at RB 128) from float4 reads of the k-major user and
//   item tiles: 8*TN fmaf per 2 + TN/4 16-byte shared-memory loads.
// - bf16: 8 warps in a 2 x 4 layout, each a (RB/2) x 32 tile of
//   m16n8k16 mma.sync products with fragments loaded by ldmatrix (.trans for
//   the k-major item tile); rows are padded by 16 bytes so that ldmatrix's
//   eight row addresses fall in distinct banks. Each plane's first k-step
//   multiplies into a zero accumulator, so no register is cleared.
// - The epilogue runs on the score registers: for each score, a hit word
//   collects bit k of plane k when score > sstar[row] (one compare and one
//   predicated OR; the mask is not read inside the loop). After the last
//   plane each thread ANDs its hit words with its mask words (read once),
//   popcounts, sums over the threads that share a row by shuffles and then
//   shared memory, and one int32 atomicAdd per row per block adds the count
//   into rank[b]. Integer atomics do not depend on order, so results are
//   deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 128;     // items per bit plane
constexpr int PLANES = 32;     // bits per mask word
constexpr int I_BLK = LANES * PLANES;

// ring depth and item-row padding (elements) of each route
constexpr int FMA_STAGES = 2;
constexpr int MMA_STAGES = 3;
constexpr int MMA_PAD = 8;     // 16 bytes of bf16

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; valid = false fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate; with
// FIRST, c = a * b (a zero accumulator, so no register is cleared)
template <bool FIRST>
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if (FIRST)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Issue plane `plane`'s d x 128 item tile into `dst` (rows of LDB elements).
template <typename T, int LDB>
__device__ __forceinline__ void load_plane(T* dst, const T* __restrict__ items_t,
                                           size_t base, int plane, int d,
                                           int ipad) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int CH = LANES / VEC;       // copies per item row of the plane
  const T* src = items_t + base + (size_t)plane * LANES;
  for (int c = threadIdx.x; c < d * CH; c += THREADS) {
    const int dd = c / CH, q = c - dd * CH;
    cp_async16(dst + dd * LDB + q * VEC, src + (size_t)dd * ipad + q * VEC,
               true);
  }
}

// Add the per-row counts that the block gathered in shared memory into rank.
template <int RB>
__device__ __forceinline__ void flush_counts(const int* rowcnt, int* rank,
                                             int row0, int B) {
  __syncthreads();
  for (int r = threadIdx.x; r < RB; r += THREADS) {
    const int c = rowcnt[r];
    if (c != 0 && row0 + r < B) atomicAdd(&rank[row0 + r], c);
  }
}

// f32 route: 8 x TN scores per thread on the CUDA cores.
template <int RB>
__device__ __forceinline__ void fma_body(
    unsigned char* smem, int* rowcnt, const float* __restrict__ ue,
    const float* __restrict__ items_t, const float* __restrict__ sstar,
    const uint32_t* __restrict__ maskp, int* __restrict__ rank, int B, int d,
    int ipad, int row0, int jb) {
  constexpr int RG = RB / 8;            // row groups of 8 rows
  constexpr int IG = THREADS / RG;      // item groups: 32 or 16
  constexpr int TN = LANES / IG;        // items per thread: 4 or 8
  constexpr int HALF = RB / 2;
  static_assert(TN == 4 || TN == 8, "8 x 4 or 8 x 8 register tiles");
  float* ueT = reinterpret_cast<float*>(smem);      // [d][RB], k-major
  float* ring = ueT + d * RB;                        // [STAGES][d][LANES]
  const int stage = d * LANES;
  const int tid = threadIdx.x, ty = tid / IG, tx = tid % IG;
  const size_t base = (size_t)jb * I_BLK;

  for (int s = 0; s < FMA_STAGES - 1; ++s) {
    load_plane<float, LANES>(ring + s * stage, items_t, base, s, d, ipad);
    cp_async_commit();
  }
  // user rows, transposed to k-major; rows beyond B are zero
  const int d4 = d / 4;
  for (int i = tid; i < RB * d4; i += THREADS) {
    const int r = i % RB, k4 = i / RB, gr = row0 + r;
    const float4 v = gr < B
        ? reinterpret_cast<const float4*>(ue)[(size_t)gr * d4 + k4]
        : make_float4(0.f, 0.f, 0.f, 0.f);
    ueT[(4 * k4 + 0) * RB + r] = v.x;
    ueT[(4 * k4 + 1) * RB + r] = v.y;
    ueT[(4 * k4 + 2) * RB + r] = v.z;
    ueT[(4 * k4 + 3) * RB + r] = v.w;
  }

  // thread rows ty*4 + i and HALF + ty*4 + i; items tx*4 + j (and 64 + ...)
  auto row_of = [&](int i) { return (i < 4 ? 0 : HALF - 4) + ty * 4 + i; };
  float ss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + row_of(i);
    ss[i] = gr < B ? sstar[gr] : INFINITY;
  }
  uint32_t hits[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) hits[i][j] = 0u;

  for (int k = 0; k < PLANES; ++k) {
    const int next = k + FMA_STAGES - 1;
    if (next < PLANES)
      load_plane<float, LANES>(ring + (next % FMA_STAGES) * stage, items_t,
                               base, next, d, ipad);
    cp_async_commit();
    cp_async_wait<FMA_STAGES - 1>();
    __syncthreads();   // plane k (and the user rows) visible to every thread
    const float* its = ring + (k % FMA_STAGES) * stage;
    float acc[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(ueT + dd * RB + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(ueT + dd * RB + HALF + ty * 4);
      const float4 b0 =
          *reinterpret_cast<const float4*>(its + dd * LANES + tx * 4);
      float4 b1 = b0;
      if (TN == 8)
        b1 = *reinterpret_cast<const float4*>(its + dd * LANES + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    const uint32_t bit = 1u << k;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (acc[i][j] > ss[i]) hits[i][j] |= bit;
    __syncthreads();   // this plane's buffer may be refilled
  }

  const int words = ipad / PLANES;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + row_of(i);
    int c = 0;
    if (gr < B) {
      const uint32_t* mrow = maskp + (size_t)gr * words + jb * LANES + tx * 4;
      const uint4 w0 = *reinterpret_cast<const uint4*>(mrow);
      c = __popc(hits[i][0] & w0.x) + __popc(hits[i][1] & w0.y) +
          __popc(hits[i][2] & w0.z) + __popc(hits[i][3] & w0.w);
      if (TN == 8) {
        const uint4 w1 = *reinterpret_cast<const uint4*>(mrow + 64);
        c += __popc(hits[i][TN - 4] & w1.x) + __popc(hits[i][TN - 3] & w1.y) +
             __popc(hits[i][TN - 2] & w1.z) + __popc(hits[i][TN - 1] & w1.w);
      }
    }
    // the IG threads of a row group are one aligned run of lanes
#pragma unroll
    for (int o = IG / 2; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
    if (tx == 0 && c != 0) atomicAdd(&rowcnt[row_of(i)], c);
  }
  flush_counts<RB>(rowcnt, rank, row0, B);
}

// bf16 route: mma.sync m16n8k16 on the tensor cores, 8 warps as 2 x 4.
template <int RB>
__device__ __forceinline__ void mma_body(
    unsigned char* smem, int* rowcnt, const __nv_bfloat16* __restrict__ ue,
    const __nv_bfloat16* __restrict__ items_t, const float* __restrict__ sstar,
    const uint32_t* __restrict__ maskp, int* __restrict__ rank, int B, int d,
    int ipad, int row0, int jb) {
  constexpr int LDB = LANES + MMA_PAD;  // item tile row
  constexpr int WR = RB / 2;            // rows per warp
  constexpr int MT = WR / 16;           // m16 tiles per warp: 2 or 4
  constexpr int NT = 4;                 // n8 tiles per warp: 32 items
  const int lda = d + MMA_PAD;          // user row
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [RB][lda]
  __nv_bfloat16* ring = As + RB * lda;                  // [STAGES][d][LDB]
  const int stage = d * LDB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)jb * I_BLK;

  // user rows by 16-byte copies (rows beyond B zero-filled), in the first
  // group with plane 0
  const int d8 = d / 8;
  for (int c = tid; c < RB * d8; c += THREADS) {
    const int r = c / d8, q = c - r * d8, gr = row0 + r;
    cp_async16(As + r * lda + q * 8, ue + (size_t)min(gr, B - 1) * d + q * 8,
               gr < B);
  }
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    load_plane<__nv_bfloat16, LDB>(ring + s * stage, items_t, base, s, d,
                                   ipad);
    cp_async_commit();
  }

  // fragment rows: wm*WR + mt*16 + g (+8); items: wn*32 + nt*8 + 2t (+1)
  float ss[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = row0 + wm * WR + mt * 16 + g + 8 * h;
      ss[mt][h] = gr < B ? sstar[gr] : INFINITY;
    }
  uint32_t hits[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hits[mt][nt][e] = 0u;

  // per-lane ldmatrix offsets (elements): A rows lane&15, k half lane>>4;
  // B (k-major, transposed on load) k rows lane&7 (+8), n half lane>>4
  const unsigned a_base = smem_addr(As) +
      2u * ((wm * WR + (lane & 15)) * lda + (lane >> 4) * 8);
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB + wn * 32 +
                    (lane >> 4) * 8;
  for (int k = 0; k < PLANES; ++k) {
    const int next = k + MMA_STAGES - 1;
    if (next < PLANES)
      load_plane<__nv_bfloat16, LDB>(ring + (next % MMA_STAGES) * stage,
                                     items_t, base, next, d, ipad);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();   // plane k (and the user rows) visible to every thread
    const unsigned b_base =
        smem_addr(ring + (k % MMA_STAGES) * stage + b_off);
    float acc[MT][NT][4];
    // one k-step of 16: the B fragments of the warp's 32 items, then each
    // m16 tile's A fragment and its four products
    auto kstep = [&](int kk, auto first) {
      uint32_t b[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p)
        ldmatrix_x4_trans(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0],
                          b[2 * p + 1][1],
                          b_base + 2u * (kk * LDB + p * 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + 2u * (mt * 16 * lda + kk));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16<decltype(first)::value>(acc[mt][nt], a, b[nt]);
      }
    };
    kstep(0, std::true_type{});
#pragma unroll 3
    for (int kk = 16; kk < d; kk += 16) kstep(kk, std::false_type{});
    const uint32_t bit = 1u << k;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (acc[mt][nt][e] > ss[mt][e >> 1]) hits[mt][nt][e] |= bit;
    __syncthreads();   // this plane's buffer may be refilled
  }

  const int words = ipad / PLANES;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = wm * WR + mt * 16 + g + 8 * h, gr = row0 + rl;
      int c = 0;
      if (gr < B) {
        const uint32_t* mrow =
            maskp + (size_t)gr * words + jb * LANES + wn * 32 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 w = *reinterpret_cast<const uint2*>(mrow + nt * 8);
          c += __popc(hits[mt][nt][2 * h] & w.x) +
               __popc(hits[mt][nt][2 * h + 1] & w.y);
        }
      }
      // the four lanes of a fragment row, then the four warps of a row
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      if (t == 0 && c != 0) atomicAdd(&rowcnt[rl], c);
    }
  flush_counts<RB>(rowcnt, rank, row0, B);
}

template <typename T, int RB, bool ITEMS_ON_X>
__global__ void __launch_bounds__(THREADS, RB == 64 ? 2 : 1) masked_rank_kernel(
    const T* __restrict__ ue, const T* __restrict__ items_t,
    const float* __restrict__ sstar, const uint32_t* __restrict__ maskp,
    int* __restrict__ rank, int B, int d, int ipad) {
  // all shared memory is dynamic (allow_max_smem opts in to the whole
  // 227 KB, which leaves no room for static arrays): the RB row counts
  // first, then the route's tiles
  extern __shared__ __align__(16) unsigned char smem[];
  int* rowcnt = reinterpret_cast<int*>(smem);
  unsigned char* tiles = smem + RB * sizeof(int);
  for (int r = threadIdx.x; r < RB; r += THREADS) rowcnt[r] = 0;
  const int row0 = (ITEMS_ON_X ? blockIdx.y : blockIdx.x) * RB;
  const int jb = ITEMS_ON_X ? blockIdx.x : blockIdx.y;
  if constexpr (std::is_same<T, float>::value)
    fma_body<RB>(tiles, rowcnt, ue, items_t, sstar, maskp, rank, B, d, ipad,
                 row0, jb);
  else
    mma_body<RB>(tiles, rowcnt, ue, items_t, sstar, maskp, rank, B, d, ipad,
                 row0, jb);
}

template <typename T, int RB>
size_t smem_bytes(int d) {
  const size_t counts = RB * sizeof(int);
  if (std::is_same<T, float>::value)
    return counts + (size_t)d * (RB + FMA_STAGES * LANES) * sizeof(float);
  return counts + ((size_t)RB * (d + MMA_PAD) +
                   (size_t)MMA_STAGES * d * (LANES + MMA_PAD)) * sizeof(T);
}

template <typename T, int RB, bool ITEMS_ON_X>
int launch(const void* ue, const void* items_t, const float* sstar,
           const uint32_t* maskp, int* rank, int B, int d, int ipad,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const size_t smem = smem_bytes<T, RB>(d);
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
  if (rows_per_block == 64)
    return items_on_x
        ? launch<T, 64, true>(ue, items_t, sstar, maskp, rank, B, d, ipad, s)
        : launch<T, 64, false>(ue, items_t, sstar, maskp, rank, B, d, ipad, s);
  if (rows_per_block == 128)
    return items_on_x
        ? launch<T, 128, true>(ue, items_t, sstar, maskp, rank, B, d, ipad, s)
        : launch<T, 128, false>(ue, items_t, sstar, maskp, rank, B, d, ipad,
                                s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ue: (B, d), items_t: (d, ipad), both f32 (in_bf16 = 0) or bf16, both
// 16-byte aligned; d a multiple of 16; sstar: (B,) f32; maskp: (B, ipad/32)
// uint32, 16-byte aligned; rank: (B,) int32, zeroed by the caller. ipad is a
// multiple of 4096. rows_per_block (64 or 128) and items_on_x (0: row tiles
// on blockIdx.x; 1: item blocks) pick P1's instantiation.
extern "C" int sml_masked_rank(const void* ue, const void* items_t,
                               int in_bf16, const void* sstar,
                               const void* maskp, void* rank, int B, int d,
                               int ipad, int rows_per_block, int items_on_x,
                               void* stream) {
  if (B < 0 || d <= 0 || d % 16 != 0 || ipad < 0 || ipad % I_BLK != 0)
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
