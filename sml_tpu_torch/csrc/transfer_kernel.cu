// K1 transfer_rows_kernel: the full-table transfer refresh W = Θ(last, hat).
//
// Replaces the Pallas TPU kernel sml_tpu/ops/transfer_kernel.py
// fused_table_transfer (kernel body _kernel, :46-83). Per table row:
//
//   x_com = (x_t ⊙ x_hat) / ||x_t||          (0 on zero-norm rows)
//   conv1: [x_t, x_hat, x_com] 3 -> C1 mix, gelu
//   conv2: C1 -> C2 mix, gelu, flatten channel-major (index e*d + j)
//   fc1:   C2*d -> H, gelu
//   fc2:   H -> d
//
// with gelu(v) = v * sigmoid(1.702 v). Forward only.
//
// Bound on an H100 SXM: 2*((3*C1 + C1*C2)*d + C2*d*H + H*d) operations per
// row (403,456 at d=64, C1=10, C2=5, H=512) against 3*d*4 bytes of HBM
// traffic per row in f32. At the f32 rate outside the tensor cores (67
// TFLOP/s) the work takes ~26x longer than the traffic (3.35 TB/s): the
// kernel is bound by operations, 0.72 ms for 120,000 rows. Nearly all of it
// is the two products (fc1 81%, fc2 16%), so the design is a register-tiled
// f32 product whose left operand is made on the fly.
//
// Design: one block of 256 threads owns ROWS table rows (64, 32 or 16,
// chosen by the host from d). Only last, hat and out touch HBM; the weights
// stream from L2, every intermediate stays in shared memory or registers.
//   * The rows are staged once as f32 (bf16 snapshots are widened here;
//     16-byte loads where rows are aligned, scalar loads otherwise) with
//     1/||x_t|| per row (0 on a zero row, so x_com = 0 there).
//   * fc1's C2*d inputs come in chunks of 16 columns j x up to 8 conv2
//     channels e, made in a double-buffered shared tile: each (row, column)
//     runs conv1 once and the chunk's conv2 channels (IP items at a time,
//     for their latency). After the FMAs of each fc1 tile every thread makes
//     a share of the next chunk, so it is ready when its tiles start. The
//     tile holds 128 inputs whatever C2 is: nothing grows with C2.
//   * An fc1 weight tile is one channel e x 16 columns: fc1_w rows
//     e*d + j .. j+15, contiguous, x HP = 512 hidden units (H in passes of
//     512 when it is larger). Each thread keeps an 8 x TN register tile of
//     fc1 sums (8 x 16 at 64 rows: 6 16-byte shared loads per 128 FMAs,
//     each one shared-memory wavefront).
//   * The weight tiles flow through a STAGES-deep ring, each stage with an
//     mbarrier: where rows are 16-byte aligned (d % 4 == 0, H % 4 == 0)
//     thread 0 moves a tile by bulk (TMA) copies, one 32 KB copy when it is
//     contiguous; otherwise every thread copies by cp.async with zero fill.
//     A tile is issued STAGES - 1 tiles ahead of its use.
//   * Then fc2: gelu(fc1 + b1) goes, up to HC hidden units at a time, to a
//     shared tile in the chunk buffer just read out, and into fc2 sums kept
//     in registers (8 rows x 4 columns a thread; threads to spare split the
//     hidden sum and meet in shared memory at the end).
// Shared memory, in floats: 2*ROWS*(d+1) rows + ROWS norms + 64 conv1
// weights + 2*128*(ROWS+4) chunk tiles + STAGES*16*512 ring (+ mbarriers):
// it grows with d only, not with C2 or H (d=64: 201,760 bytes; ROWS is 64
// up to d=128, 32 up to 256, 16 up to 512).
// All arithmetic is f32 (fmaf; no tensor cores, no TF32); gelu uses the
// hardware exp2 and reciprocal (__expf, __fdividef), ~1e-6 relative.
// What limits it: one block of 8 warps per SM at 255 registers, so the
// latency of making a chunk's items (the conv1 and conv2 gelus) is not
// hidden behind other warps' FMAs.
// Limits: d <= 512 (the fc2 register tiles) and C1 <= 16 (conv1's
// registers); C2 and H are free.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KT = 16;       // fc1 inputs per weight tile: 16 columns j
constexpr int EB = 8;        // conv2 channels per flat chunk
constexpr int CHUNK = EB * KT;   // flat slots per chunk
constexpr int HC = 128;      // most hidden units per fc2 tile
constexpr int IP = 2;        // chunk items a thread makes at once
constexpr int MAX_C1 = 16;
constexpr int MAX_D = 512;

__device__ __forceinline__ float gelu_sig(float v) {
  return v * __fdividef(1.0f, 1.0f + __expf(-1.702f * v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// asynchronous copies; valid = false fills the destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// Each ring stage has an mbarrier that completes once per fill: THREADS
// arrivals (one per thread; for copies by cp.async, when the thread's
// copies have landed) and, for bulk copies, their bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// one bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned), counted against bar's expected bytes
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// four consecutive row elements as f32 (f32: one 16-byte load; bf16: 8 bytes)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float widen(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// The instantiation's tile shape. fc1: RG row groups of 8 rows x CG column
// groups of 4 hidden units (each thread TN/4 groups, CG*4 apart); a warp is
// WRG row groups x WCG column groups. fc2 takes RG row groups x dp/4 column
// groups of 4 (8 x 4 sums a thread), so dp <= MAXD; the threads left over
// split the hidden sum.
template <int ROWS, int TN, int STAGES>
struct Tile {
  static constexpr int RG = ROWS / 8;
  static constexpr int CG = THREADS / RG;
  static constexpr int HP = CG * TN;           // hidden units per pass
  static constexpr int STAGE = KT * HP;        // floats per ring stage
  static constexpr int WRG = RG < 4 ? RG : 4;
  static constexpr int WCG = 32 / WRG;
  static constexpr int PITCH = ROWS + 4;       // chunk tile pitch
  static constexpr int MAXD = 4 * THREADS / RG;
  static constexpr int IPT = ROWS * KT / THREADS;   // chunk items a thread
  static_assert(ROWS % 16 == 0 && TN % 4 == 0 && THREADS % RG == 0, "tile");
  static_assert(HC <= CHUNK && STAGES >= 2, "buffers");
};

// shared-memory layout, in floats; every region starts on a 16-byte boundary
struct Layout {
  int xt, xh, rinv, cw, chunk, ring, mbar, total;
  __host__ __device__ Layout(int rows, int stage, int stages, int d) {
    xt = 0;
    xh = rows * (d + 1);
    rinv = 2 * rows * (d + 1);
    cw = rinv + rows;
    chunk = round4(cw + 4 * MAX_C1);
    ring = round4(chunk + 2 * CHUNK * (rows + 4));
    mbar = ring + stages * stage;          // one 8-byte mbarrier a stage
    total = mbar + round4(2 * stages);
  }
};

// What a block needs to find the weight tile of stream position t.
struct Plan {
  int d, c2, h, nt1, kt2, dp, per_pass, total;
  bool vec1, vec2;   // 16-byte copies of fc1_w / fc2_w rows
};

// Issue tile t of the block's weight stream into ring stage dst, whose
// mbarrier is bar: per pass of HP hidden units, nt1 fc1 tiles, then the
// pass's fc2 tiles. fc1 tile (jb, e) = jb*c2 + e holds fc1_w rows
// e*d + 16*jb .. +15 (contiguous), HP units each; fc2 tiles kt2 hidden
// rows x dp columns. Where every row is 16-byte aligned (vec1 and vec2),
// thread 0 moves the tile by bulk copies and a row past d repeats row d-1
// (its flat input is 0), columns past the pass are left as they are (their
// sums are never read); otherwise every thread copies by cp.async with
// zero fill.
template <int HP>
__device__ __forceinline__ void issue_tile(float* dst, uint64_t* bar, int t,
                                           const Plan& P,
                                           const float* __restrict__ fc1_w,
                                           const float* __restrict__ fc2_w) {
  const int p = t / P.per_pass, r = t - p * P.per_pass;
  const int h0 = p * HP;
  const int hp = min(HP, P.h - h0);
  const bool bulk = P.vec1 && P.vec2;
  if (r < P.nt1) {
    const int jb = r / P.c2, e = r - jb * P.c2, j0 = jb * KT;
    const float* src = fc1_w + (size_t)(e * P.d + j0) * P.h + h0;
    if (bulk) {
      if (threadIdx.x == 0) {
        mbar_arrive_tx(bar, KT * hp * 4);
        if (hp == P.h && hp == HP && j0 + KT <= P.d) {
          bulk_copy(dst, src, KT * HP * 4, bar);   // one contiguous block
        } else {
          for (int qq = 0; qq < KT; ++qq)
            bulk_copy(dst + qq * HP, src + (size_t)min(qq, P.d - 1 - j0) * P.h,
                      hp * 4, bar);
        }
      } else {
        mbar_arrive(bar);
      }
      return;
    }
    if (P.vec1) {
      for (int i = threadIdx.x; i < KT * HP / 4; i += THREADS) {
        const int qq = i / (HP / 4), col = (i - qq * (HP / 4)) * 4;
        const bool ok = j0 + qq < P.d && col < hp;
        cp_async16(dst + qq * HP + col, ok ? src + (size_t)qq * P.h + col : fc1_w,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < KT * HP; i += THREADS) {
        const int qq = i / HP, col = i - qq * HP;
        const bool ok = j0 + qq < P.d && col < hp;
        cp_async4(dst + i, ok ? src + (size_t)qq * P.h + col : fc1_w, ok);
      }
    }
  } else {
    const int c0 = (r - P.nt1) * P.kt2;
    const int cnt = min(P.kt2, hp - c0);
    const int dp = P.dp;
    const float* src = fc2_w + (size_t)(h0 + c0) * P.d;
    if (bulk) {   // dp == d: the tile's rows are one contiguous block
      if (threadIdx.x == 0) {
        mbar_arrive_tx(bar, cnt * dp * 4);
        bulk_copy(dst, src, cnt * dp * 4, bar);
      } else {
        mbar_arrive(bar);
      }
      return;
    }
    if (P.vec2) {
      for (int i = threadIdx.x; i < P.kt2 * dp / 4; i += THREADS) {
        const int cc = i / (dp / 4), col = (i - cc * (dp / 4)) * 4;
        const bool ok = cc < cnt;
        cp_async16(dst + cc * dp + col, ok ? src + (size_t)cc * P.d + col : fc2_w,
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < P.kt2 * dp; i += THREADS) {
        const int cc = i / dp, col = i - cc * dp;
        const bool ok = cc < cnt && col < P.d;
        cp_async4(dst + i, ok ? src + (size_t)cc * P.d + col : fc2_w, ok);
      }
    }
  }
  cp_async_arrive(bar);
}

template <typename T, int ROWS, int TN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1) transfer_rows_kernel(
    const T* __restrict__ last, const T* __restrict__ hat,
    const float* __restrict__ conv1_w, const float* __restrict__ conv1_b,
    const float* __restrict__ conv2_w, const float* __restrict__ conv2_b,
    const float* __restrict__ fc1_w, const float* __restrict__ fc1_b,
    const float* __restrict__ fc2_w, const float* __restrict__ fc2_b,
    float* __restrict__ out, int n, int d, int c1, int c2, int h) {
  using S = Tile<ROWS, TN, STAGES>;
  extern __shared__ __align__(16) float smem[];
  const Layout L(ROWS, S::STAGE, STAGES, d);
  const int dpx = d + 1;                   // odd pitch for even d
  float* xt = smem + L.xt;                 // [ROWS][dpx]
  float* xh = smem + L.xh;
  float* rinv = smem + L.rinv;             // [ROWS] 1/||x_t|| (0 if zero)
  float* cw = smem + L.cw;                 // conv1_w (c1 x 3), conv1_b
  float* chunks = smem + L.chunk;          // 2 x [CHUNK][PITCH], k-major
  float* ring = smem + L.ring;             // [STAGES][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.mbar);   // [STAGES]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  Plan P;
  P.d = d;
  P.c2 = c2;
  P.h = h;
  const int njb = (d + KT - 1) / KT;       // column blocks of 16
  const int ngr = (c2 + EB - 1) / EB;      // conv2 channel groups of 8
  const int cpp = njb * ngr;               // chunks per pass
  P.nt1 = njb * c2;
  P.dp = round4(d);
  P.kt2 = min(HC, S::STAGE / P.dp);
  const int hp0 = min(S::HP, h);
  P.per_pass = P.nt1 + (hp0 + P.kt2 - 1) / P.kt2;
  const int passes = (h + S::HP - 1) / S::HP;
  const int hp_last = h - (passes - 1) * S::HP;
  P.total = (passes - 1) * P.per_pass + P.nt1 + (hp_last + P.kt2 - 1) / P.kt2;
  P.vec1 = (h % 4) == 0 && (reinterpret_cast<uintptr_t>(fc1_w) & 15) == 0;
  P.vec2 = (d % 4) == 0 && (reinterpret_cast<uintptr_t>(fc2_w) & 15) == 0;
  const int n_chunks = passes * cpp;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first weight tiles fly while the rows are staged
  for (int s = 0; s < STAGES - 1 && s < P.total; ++s)
    issue_tile<S::HP>(ring + s * S::STAGE, full + s, s, P, fc1_w, fc2_w);

  for (int i = tid; i < c1 * 4; i += THREADS)
    cw[i] = i < c1 * 3 ? conv1_w[i] : conv1_b[i - c1 * 3];
  const bool vec_rows = (d % 4) == 0 &&
      (reinterpret_cast<uintptr_t>(last) % (4 * sizeof(T))) == 0 &&
      (reinterpret_cast<uintptr_t>(hat) % (4 * sizeof(T))) == 0;
  if (vec_rows) {
    const int d4 = d / 4;
    for (int i = tid; i < ROWS * d4; i += THREADS) {
      const int r = i / d4, j = (i - r * d4) * 4, gr = row0 + r;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (gr < n) {
        a = load4(last + (size_t)gr * d + j);
        b = load4(hat + (size_t)gr * d + j);
      }
      float* pa = xt + r * dpx + j;
      float* pb = xh + r * dpx + j;
      pa[0] = a.x; pa[1] = a.y; pa[2] = a.z; pa[3] = a.w;
      pb[0] = b.x; pb[1] = b.y; pb[2] = b.z; pb[3] = b.w;
    }
  } else {
    for (int i = tid; i < ROWS * d; i += THREADS) {
      const int r = i / d, j = i - r * d, gr = row0 + r;
      const size_t off = (size_t)gr * d + j;
      xt[r * dpx + j] = gr < n ? widen(last, off) : 0.f;
      xh[r * dpx + j] = gr < n ? widen(hat, off) : 0.f;
    }
  }
  __syncthreads();
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s = fmaf(xt[r * dpx + j], xt[r * dpx + j], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rinv[r] = s > 0.f ? 1.0f / sqrtf(s) : 0.f;
  }
  __syncthreads();

  // Items [lo, hi) of this thread for chunk g (columns 16*jb .. +15 x
  // conv2 channels 8*eg .. +7 of every row) into buf, several at a time for
  // the latency (IP at once): item (r, jj) runs conv1 once and conv2 for the group's
  // channels; slot el*16 + jj holds flat[e*d + 16*jb + jj], zero past d.
  auto make_items = [&](int g, float* buf, int lo, int hi) {
    const int gc = g % cpp, jb = gc / ngr, e0 = (gc - jb * ngr) * EB;
    for (int it = lo; it < hi; it += IP) {
      float a[IP], b[IP], com[IP];
      float* dst[IP];
      bool live[IP];
#pragma unroll
      for (int k = 0; k < IP; ++k) {
        const int item = tid + min(it + k, hi - 1) * THREADS;
        const int r = item % ROWS, jj = item / ROWS, j = jb * KT + jj;
        live[k] = it + k < hi && j < d;
        dst[k] = buf + jj * S::PITCH + r;
        a[k] = live[k] ? xt[r * dpx + j] : 0.f;
        b[k] = live[k] ? xh[r * dpx + j] : 0.f;
        com[k] = (a[k] * b[k]) * rinv[r];
      }
      float h1[IP][MAX_C1];
#pragma unroll
      for (int c = 0; c < MAX_C1; ++c)
#pragma unroll
        for (int k = 0; k < IP; ++k) {
          h1[k][c] = 0.f;
          if (c < c1)
            h1[k][c] = gelu_sig(fmaf(cw[c * 3 + 2], com[k],
                                     fmaf(cw[c * 3 + 1], b[k], cw[c * 3] * a[k])) +
                                cw[c1 * 3 + c]);
        }
#pragma unroll
      for (int el = 0; el < EB; ++el) {
        const int e = e0 + el;
        if (e < c2) {
          const float* w2 = conv2_w + e * c1;
          const float bias = __ldg(conv2_b + e);
          float v[IP];
#pragma unroll
          for (int k = 0; k < IP; ++k) v[k] = bias;
#pragma unroll
          for (int c = 0; c < MAX_C1; ++c)
            if (c < c1) {
              const float w = __ldg(w2 + c);
#pragma unroll
              for (int k = 0; k < IP; ++k) v[k] = fmaf(w, h1[k][c], v[k]);
            }
#pragma unroll
          for (int k = 0; k < IP; ++k)
            if (it + k < hi)
              dst[k][el * KT * S::PITCH] = live[k] ? gelu_sig(v[k]) : 0.f;
        } else {
#pragma unroll
          for (int k = 0; k < IP; ++k)
            if (it + k < hi) dst[k][el * KT * S::PITCH] = 0.f;
        }
      }
    }
  };
  make_items(0, chunks, 0, S::IPT);   // the first chunk
  __syncthreads();

  // fc1 thread tile: rows rg*8 .. rg*8+7; hidden units m*CG*4 + cg*4 + 0..3
  const int wr = warp / (S::CG / S::WCG), wc = warp % (S::CG / S::WCG);
  const int rg = wr * S::WRG + lane / S::WCG;
  const int cg = wc * S::WCG + lane % S::WCG;
  // fc2 thread tile: split sp of ks, rows rg2*8 .. +7, columns fg*4 .. +3
  const int fgn = P.dp / 4, tps = S::RG * fgn, ks = THREADS / tps;
  const int sp = tid / tps, rg2 = (tid - sp * tps) / fgn;
  const int fg = tid - sp * tps - rg2 * fgn;
  float acc2[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc2[i][u] = 0.f;

  int t = 0;   // position in the weight stream
  int g = 0;   // chunk being consumed
  for (int h0 = 0; h0 < h; h0 += S::HP) {
    const int hp = min(S::HP, h - h0);
    float acc1[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc1[i][j] = 0.f;

    for (int jb = 0; jb < njb; ++jb) {
      for (int e = 0; e < c2; ++e, ++t) {
        const int el = e % EB;
        if (el == 0 && (jb | e) != 0) ++g;
        // this tile's share of the next chunk's items, in pairs
        const int nte = min(EB, c2 - (e - el));
        const int per = IP * ((S::IPT + IP * nte - 1) / (IP * nte));
        const int lo = min(S::IPT, el * per), hi = min(S::IPT, lo + per);
        if (t + STAGES - 1 < P.total) {
          const int tn = t + STAGES - 1;   // its stage was read out by t - 1
          issue_tile<S::HP>(ring + (tn % STAGES) * S::STAGE, full + tn % STAGES,
                            tn, P, fc1_w, fc2_w);
        }
        mbar_wait(full + t % STAGES, (t / STAGES) & 1);
        const float* w = ring + (t % STAGES) * S::STAGE + cg * 4;
        const float* f = chunks + (g & 1) * CHUNK * S::PITCH +
                         el * KT * S::PITCH + rg * 8;
#pragma unroll
        for (int qq = 0; qq < KT; ++qq) {
          const float4 a0 = *reinterpret_cast<const float4*>(f + qq * S::PITCH);
          const float4 a1 =
              *reinterpret_cast<const float4*>(f + qq * S::PITCH + 4);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int m = 0; m < TN / 4; ++m) {
            const float4 b = *reinterpret_cast<const float4*>(
                w + qq * S::HP + m * S::CG * 4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc1[i][m * 4 + 0] = fmaf(a[i], b.x, acc1[i][m * 4 + 0]);
              acc1[i][m * 4 + 1] = fmaf(a[i], b.y, acc1[i][m * 4 + 1]);
              acc1[i][m * 4 + 2] = fmaf(a[i], b.z, acc1[i][m * 4 + 2]);
              acc1[i][m * 4 + 3] = fmaf(a[i], b.w, acc1[i][m * 4 + 3]);
            }
          }
        }
        if (g + 1 < n_chunks && lo < hi)
          make_items(g + 1, chunks + ((g + 1) & 1) * CHUNK * S::PITCH, lo, hi);
        __syncthreads();   // stage read out; chunk g + 1 complete when due
      }
    }

    // fc2 over the pass: gelu(fc1 + b1) of kt2 hidden units at a time goes
    // to chunk g's buffer (read out by now), then into the fc2 sums
    float* h3 = chunks + (g & 1) * CHUNK * S::PITCH;
    const int nt2 = (hp + P.kt2 - 1) / P.kt2;
    for (int i2 = 0; i2 < nt2; ++i2, ++t) {
      const int c0 = i2 * P.kt2;
      const int cnt = min(P.kt2, hp - c0);
#pragma unroll
      for (int m = 0; m < TN / 4; ++m)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = m * S::CG * 4 + cg * 4 + u;
          if (c >= c0 && c < c0 + cnt) {
            const float bias = __ldg(fc1_b + h0 + c);
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = gelu_sig(acc1[i][m * 4 + u] + bias);
            float* dst = h3 + (c - c0) * S::PITCH + rg * 8;
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
          }
        }
      if (t + STAGES - 1 < P.total) {
        const int tn = t + STAGES - 1;
        issue_tile<S::HP>(ring + (tn % STAGES) * S::STAGE, full + tn % STAGES,
                          tn, P, fc1_w, fc2_w);
      }
      mbar_wait(full + t % STAGES, (t / STAGES) & 1);
      __syncthreads();   // this h3 tile written
      if (sp < ks) {
        const float* w = ring + (t % STAGES) * S::STAGE + fg * 4;
        const float* hv = h3 + rg2 * 8;
#pragma unroll 4
        for (int cc = sp; cc < cnt; cc += ks) {
          const float4 g0 = *reinterpret_cast<const float4*>(hv + cc * S::PITCH);
          const float4 g1 =
              *reinterpret_cast<const float4*>(hv + cc * S::PITCH + 4);
          const float4 wv = *reinterpret_cast<const float4*>(w + cc * P.dp);
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc2[i][0] = fmaf(gv[i], wv.x, acc2[i][0]);
            acc2[i][1] = fmaf(gv[i], wv.y, acc2[i][1]);
            acc2[i][2] = fmaf(gv[i], wv.z, acc2[i][2]);
            acc2[i][3] = fmaf(gv[i], wv.w, acc2[i][3]);
          }
        }
      }
      __syncthreads();
    }
    ++g;
  }

  // the splits of the hidden sum meet in the (now idle) ring
  float* red = ring;                       // [ks][ROWS][dp]
  if (sp < ks) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(red + (sp * ROWS + rg2 * 8 + i) * P.dp + fg * 4) =
          make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * d; i += THREADS) {
    const int r = i / d, col = i - r * d;
    if (row0 + r >= n) break;
    float v = red[r * P.dp + col];
    for (int k = 1; k < ks; ++k) v += red[(k * ROWS + r) * P.dp + col];
    out[(size_t)(row0 + r) * d + col] = v + __ldg(fc2_b + col);
  }
}

template <int ROWS, int TN, int STAGES>
struct Shape {};

// The row tile by width: 64 rows (8 x 16 fc1 tiles) up to d = 128 (a
// 2-stage ring past 64), then 32 rows (8 x 8) up to 256 and 16 rows (8 x 4)
// up to MAX_D, so that shared memory and the fc2 tiles fit;
// f(Shape<ROWS, TN, STAGES>{}).
template <typename F>
int by_width(int d, F&& f) {
  if (d <= 64) return f(Shape<64, 16, 3>{});
  if (d <= 128) return f(Shape<64, 16, 2>{});
  if (d <= 256) return f(Shape<32, 8, 3>{});
  return f(Shape<16, 4, 3>{});
}

template <int ROWS, int TN, int STAGES>
size_t smem_bytes(Shape<ROWS, TN, STAGES>, int d) {
  return (size_t)Layout(ROWS, Tile<ROWS, TN, STAGES>::STAGE, STAGES, d).total *
         sizeof(float);
}

template <typename T, int ROWS, int TN, int STAGES>
int launch(Shape<ROWS, TN, STAGES> shape, const void* last, const void* hat,
           const float* const* w, float* out, int n, int d, int c1, int c2,
           int h, cudaStream_t stream) {
  static std::atomic<uint64_t> smem_ready{0};
  const size_t smem = smem_bytes(shape, d);
  if (round4(d) > Tile<ROWS, TN, STAGES>::MAXD || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      allow_max_smem(transfer_rows_kernel<T, ROWS, TN, STAGES>, smem_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + ROWS - 1) / ROWS);
  transfer_rows_kernel<T, ROWS, TN, STAGES><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(last), static_cast<const T*>(hat), w[0], w[1],
      w[2], w[3], w[4], w[5], w[6], w[7], out, n, d, c1, c2, h);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) of one block at width d, 0 past MAX_D.
extern "C" int sml_transfer_smem_bytes(int d) {
  if (d <= 0 || d > MAX_D) return 0;
  return by_width(d, [&](auto shape) { return (int)smem_bytes(shape, d); });
}

// last, hat: (n, d) f32 (in_bf16 = 0) or bf16 (in_bf16 = 1), row-major;
// weights f32 in the JAX package's layout; out: (n, d) f32. d <= 512,
// c1 <= 16.
extern "C" int sml_transfer_rows(const void* last, const void* hat,
                                 int in_bf16, const void* conv1_w,
                                 const void* conv1_b, const void* conv2_w,
                                 const void* conv2_b, const void* fc1_w,
                                 const void* fc1_b, const void* fc2_w,
                                 const void* fc2_b, void* out, int n, int d,
                                 int c1, int c2, int h, void* stream) {
  if (n < 0 || d <= 0 || d > MAX_D || c1 <= 0 || c1 > MAX_C1 || c2 <= 0 ||
      h <= 0 || (long long)c2 * d > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* w[8] = {
      static_cast<const float*>(conv1_w), static_cast<const float*>(conv1_b),
      static_cast<const float*>(conv2_w), static_cast<const float*>(conv2_b),
      static_cast<const float*>(fc1_w), static_cast<const float*>(fc1_b),
      static_cast<const float*>(fc2_w), static_cast<const float*>(fc2_b)};
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return by_width(d, [&](auto shape) {
    return in_bf16 ? launch<__nv_bfloat16>(shape, last, hat, w, o, n, d, c1,
                                           c2, h, s)
                   : launch<float>(shape, last, hat, w, o, n, d, c1, c2, h, s);
  });
}
