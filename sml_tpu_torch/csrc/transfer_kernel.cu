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
// kernel is bound by operations, 0.72 ms for 120,000 rows.
//
// Design: one block of 256 threads per 64 rows. Only last, hat and out
// touch HBM; every intermediate stays in shared memory or registers:
//   * the rows are staged as f32 (bf16 snapshots are widened here), the
//     x_com norm is a warp reduction, and conv1/conv2 run per element into
//     a shared `flat` tile stored k-major, flatT[C2*d][64];
//   * fc1 runs in chunks of 64 hidden units: the fc1_w chunk (C2*d x 64)
//     and the matching fc2_w rows (64 x d) are staged in shared memory
//     (float4 loads), each thread computes an 8-row x 2-column register
//     tile of the chunk (4 shared loads per 16 FMAs), gelu writes it to a
//     64x64 shared tile, and that tile is folded straight into the fc2
//     accumulators, which stay in registers across chunks;
//   * 64 rows per block halve the weight staging per row against 32.
// All arithmetic is IEEE f32 (fmaf, expf; no tensor cores, no TF32). At
// d=64 the block uses ~193 KB of shared memory, so one block runs per SM.
// Limits: d <= 128 and C1 <= 16 (register arrays), shared memory <= 227 KB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS = 64;       // table rows per block
constexpr int THREADS = 256;   // 8 warps; warp w owns rows 8w..8w+7 in fc1/fc2
constexpr int RT = ROWS / (THREADS / 32);   // rows per thread tile (8)
constexpr int HC = 64;         // hidden units per fc1 chunk
constexpr int MAX_C1 = 16;
constexpr int MAX_DG = 4;      // column groups of 32: d <= 128

__device__ __forceinline__ float gelu_sig(float v) {
  return v * (1.0f / (1.0f + expf(-1.702f * v)));
}

__device__ __forceinline__ float widen(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float widen(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// shared-memory layout, in floats; every region starts on a 16-byte boundary
struct Layout {
  int flat, w1, w2, h3, conv, norm, total;
  __host__ __device__ Layout(int d, int c1, int c2) {
    const int K = c2 * d;
    const int rows_f32 = 2 * ROWS * (d + 1);     // x_t, x_hat (aliases w1)
    const int w1_size = K * HC > rows_f32 ? K * HC : rows_f32;
    const int conv_size = ((c1 * 4 + c2 * c1 + c2) + 3) / 4 * 4;
    flat = 0;
    w1 = flat + K * ROWS;
    w2 = w1 + w1_size;
    h3 = w2 + HC * d;
    conv = h3 + HC * ROWS;
    norm = conv + conv_size;
    total = norm + ROWS;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) transfer_rows_kernel(
    const T* __restrict__ last, const T* __restrict__ hat,
    const float* __restrict__ conv1_w, const float* __restrict__ conv1_b,
    const float* __restrict__ conv2_w, const float* __restrict__ conv2_b,
    const float* __restrict__ fc1_w, const float* __restrict__ fc1_b,
    const float* __restrict__ fc2_w, const float* __restrict__ fc2_b,
    float* __restrict__ out, int n, int d, int c1, int c2, int h) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(d, c1, c2);
  const int K = c2 * d;
  const int dp = d + 1;                    // padded pitch of the row tiles
  float* flatT = smem + L.flat;            // [K][ROWS]
  float* w1s = smem + L.w1;                // [K][HC]
  float* w2s = smem + L.w2;                // [HC][d]
  float* h3T = smem + L.h3;                // [HC][ROWS]
  float* cw = smem + L.conv;               // conv1_w, conv1_b, conv2_w, conv2_b
  float* rnorm = smem + L.norm;            // [ROWS]
  float* xt = w1s;                         // [ROWS][dp], phase 1 only
  float* xh = w1s + ROWS * dp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;

  const int n_conv = c1 * 4 + c2 * c1 + c2;
  for (int i = tid; i < n_conv; i += THREADS) {
    float v;
    if (i < c1 * 3) v = conv1_w[i];
    else if (i < c1 * 4) v = conv1_b[i - c1 * 3];
    else if (i < c1 * 4 + c2 * c1) v = conv2_w[i - c1 * 4];
    else v = conv2_b[i - c1 * 4 - c2 * c1];
    cw[i] = v;
  }
  const float* s_w1 = cw;
  const float* s_b1 = cw + c1 * 3;
  const float* s_w2 = cw + c1 * 4;
  const float* s_b2 = s_w2 + c2 * c1;

  // ---- phase 1: stage the rows as f32 (rows past n are zero)
  for (int i = tid; i < ROWS * d; i += THREADS) {
    const int r = i / d, j = i - r * d;
    const int gr = row0 + r;
    float a = 0.f, b = 0.f;
    if (gr < n) {
      const size_t off = (size_t)gr * d + j;
      a = widen(last, off);
      b = widen(hat, off);
    }
    xt[r * dp + j] = a;
    xh[r * dp + j] = b;
  }
  __syncthreads();
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    float s = 0.f;
    for (int j = lane; j < d; j += 32) s = fmaf(xt[r * dp + j], xt[r * dp + j], s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rnorm[r] = sqrtf(s);
  }
  __syncthreads();

  // ---- conv1 + conv2 per element (r, j); consecutive threads take
  // consecutive rows so the k-major flatT writes hit distinct banks
  for (int i = tid; i < ROWS * d; i += THREADS) {
    const int r = i % ROWS, j = i / ROWS;
    const float a = xt[r * dp + j], b = xh[r * dp + j];
    const float nrm = rnorm[r];
    const float com = nrm > 0.f ? (a * b) / nrm : 0.f;
    float h1[MAX_C1];
#pragma unroll
    for (int c = 0; c < MAX_C1; ++c) {
      if (c < c1) {
        const float v = s_w1[c * 3] * a + s_w1[c * 3 + 1] * b
                        + s_w1[c * 3 + 2] * com;
        h1[c] = gelu_sig(v + s_b1[c]);
      }
    }
    for (int e = 0; e < c2; ++e) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < MAX_C1; ++c)
        if (c < c1) v = fmaf(s_w2[e * c1 + c], h1[c], v);
      flatT[(e * d + j) * ROWS + r] = gelu_sig(v + s_b2[e]);
    }
  }
  __syncthreads();

  // ---- phase 2: fc1 in chunks of HC hidden units, folded into fc2
  const int ty = warp;                    // rows ty*RT .. ty*RT+RT-1
  const int tx = lane;
  float acc[RT][MAX_DG];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int m = 0; m < MAX_DG; ++m) acc[r][m] = 0.f;
  // float4 staging when every chunk row starts on a 16-byte boundary
  const bool vec1 = (h % 4) == 0;
  const bool vec2 = (d % 4) == 0;

  for (int h0 = 0; h0 < h; h0 += HC) {
    const int hc = h - h0 < HC ? h - h0 : HC;
    if (vec1 && hc == HC) {
      for (int i = tid; i < K * HC / 4; i += THREADS) {
        const int k = i / (HC / 4), c4 = i - k * (HC / 4);
        *reinterpret_cast<float4*>(&w1s[k * HC + c4 * 4]) =
            *reinterpret_cast<const float4*>(&fc1_w[(size_t)k * h + h0 + c4 * 4]);
      }
    } else {
      for (int i = tid; i < K * HC; i += THREADS) {
        const int k = i / HC, c = i - k * HC;
        w1s[i] = c < hc ? fc1_w[(size_t)k * h + h0 + c] : 0.f;
      }
    }
    if (vec2) {
      for (int i = tid; i < HC * d / 4; i += THREADS) {
        const int c = i / (d / 4), j4 = i - c * (d / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c < hc)
          v = *reinterpret_cast<const float4*>(&fc2_w[(size_t)(h0 + c) * d + j4 * 4]);
        *reinterpret_cast<float4*>(&w2s[c * d + j4 * 4]) = v;
      }
    } else {
      for (int i = tid; i < HC * d; i += THREADS) {
        const int c = i / d, j = i - c * d;
        w2s[i] = c < hc ? fc2_w[(size_t)(h0 + c) * d + j] : 0.f;
      }
    }
    __syncthreads();

    float a1[RT][2];
#pragma unroll
    for (int r = 0; r < RT; ++r) a1[r][0] = a1[r][1] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 f0 = *reinterpret_cast<const float4*>(&flatT[k * ROWS + ty * RT]);
      const float4 f1 = *reinterpret_cast<const float4*>(&flatT[k * ROWS + ty * RT + 4]);
      const float f[RT] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
      const float w0 = w1s[k * HC + tx];
      const float w1 = w1s[k * HC + tx + 32];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        a1[r][0] = fmaf(f[r], w0, a1[r][0]);
        a1[r][1] = fmaf(f[r], w1, a1[r][1]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = tx + 32 * q;
      const float bias = c < hc ? fc1_b[h0 + c] : 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r)
        h3T[c * ROWS + ty * RT + r] = c < hc ? gelu_sig(a1[r][q] + bias) : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < HC; ++c) {
      const float4 g0 = *reinterpret_cast<const float4*>(&h3T[c * ROWS + ty * RT]);
      const float4 g1 = *reinterpret_cast<const float4*>(&h3T[c * ROWS + ty * RT + 4]);
      const float g[RT] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int m = 0; m < MAX_DG; ++m) {
        const int col = tx + 32 * m;
        if (col < d) {
          const float w = w2s[c * d + col];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][m] = fmaf(g[r], w, acc[r][m]);
        }
      }
    }
    __syncthreads();   // the next chunk overwrites w1s, w2s and h3T
  }

#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int gr = row0 + ty * RT + r;
    if (gr >= n) continue;
#pragma unroll
    for (int m = 0; m < MAX_DG; ++m) {
      const int col = tx + 32 * m;
      if (col < d) out[(size_t)gr * d + col] = acc[r][m] + fc2_b[col];
    }
  }
}

template <typename T>
int launch(const void* last, const void* hat, const float* c1w,
           const float* c1b, const float* c2w, const float* c2b,
           const float* f1w, const float* f1b, const float* f2w,
           const float* f2b, float* out, int n, int d, int c1, int c2, int h,
           cudaStream_t stream, size_t smem) {
  static std::atomic<uint64_t> smem_ready{0};
  const cudaError_t err = allow_max_smem(transfer_rows_kernel<T>, smem_ready);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + ROWS - 1) / ROWS);
  transfer_rows_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(last), static_cast<const T*>(hat), c1w, c1b, c2w,
      c2b, f1w, f1b, f2w, f2b, out, n, d, c1, c2, h);
  return (int)cudaGetLastError();
}

}  // namespace

// last, hat: (n, d) f32 (in_bf16 = 0) or bf16 (in_bf16 = 1), row-major;
// weights f32 in the JAX package's layout; out: (n, d) f32.
extern "C" int sml_transfer_rows(const void* last, const void* hat,
                                 int in_bf16, const void* conv1_w,
                                 const void* conv1_b, const void* conv2_w,
                                 const void* conv2_b, const void* fc1_w,
                                 const void* fc1_b, const void* fc2_w,
                                 const void* fc2_b, void* out, int n, int d,
                                 int c1, int c2, int h, void* stream) {
  if (n < 0 || d <= 0 || d > 32 * MAX_DG || c1 <= 0 || c1 > MAX_C1 ||
      c2 <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Layout(d, c1, c2).total * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const auto* c1w = static_cast<const float*>(conv1_w);
  const auto* c1b = static_cast<const float*>(conv1_b);
  const auto* c2w = static_cast<const float*>(conv2_w);
  const auto* c2b = static_cast<const float*>(conv2_b);
  const auto* f1w = static_cast<const float*>(fc1_w);
  const auto* f1b = static_cast<const float*>(fc1_b);
  const auto* f2w = static_cast<const float*>(fc2_w);
  const auto* f2b = static_cast<const float*>(fc2_b);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return launch<__nv_bfloat16>(last, hat, c1w, c1b, c2w, c2b, f1w, f1b,
                                 f2w, f2b, o, n, d, c1, c2, h, s, smem);
  return launch<float>(last, hat, c1w, c1b, c2w, c2b, f1w, f1b, f2w, f2b, o,
                       n, d, c1, c2, h, s, smem);
}
