// K3 decay_adam_kernel: one g=0 dense-Adam step over every leaf of a model,
// in place, in one launch.
//
// Replaces the Pallas TPU kernel sml_tpu/ops/adam_kernel.py
// fused_decay_adam (kernel body _kernel, :34-42). Per element:
//
//   mu <- b1*mu;  nu <- b2*nu;
//   p  <- p + (-lr) * ((mu/bc1) / (sqrt(nu/bc2) + eps))
//
// the full-table pass of the row-sparse dense-Adam update
// (train/optim.py sparse_dense_adam_update): every row's moments decay and
// every row moves on its momentum each step, as torch's dense nn.Embedding
// gradient makes Adam do; the touched rows are fixed up afterwards by the
// caller. The TPU kernel runs once per table; here one launch takes up to
// MAX_LEAVES tables (the MF step's two embedding tables and two bias
// columns), so a step pays one launch instead of four.
//
// Bound on an H100 SXM: bytes. Each element is read and written once in
// each of p, mu and nu (24 bytes) for 8 operations, so at 3.35 TB/s the
// pass over the Yelp tables (100,000 + 20,000 rows x 64, plus the two bias
// columns: 7.8M elements, 187.2 MB) cannot take less than 0.0559 ms; the
// operations (62 MFLOP) would take ~0.001 ms at 67 TFLOP/s.
//
// Design: the leaves' pointers, lengths and offsets travel by value in the
// kernel parameters (__grid_constant__, read from the constant bank), and
// one flat index space of 4-element units runs over all of them. The grid
// is one wave (SMs x resident blocks per SM, queried once per device); each
// thread strides over the space UNROLL units at a time and issues every
// load of its units (UNROLL float4 groups of each of p, mu, nu: 96 bytes in
// flight) before any arithmetic, then stores them; the 16-byte loads and
// stores carry the streaming (evict-first) cache hint, since every byte is
// touched once and the 187 MB exceed the 50 MB L2. A unit takes 16-byte
// loads when its leaf's three pointers are 16-byte aligned and the unit is
// whole, and scalar loads otherwise (a leaf's last, partial unit; a view
// that starts off a 16-byte boundary). Nothing is staged in shared memory.
// It works in place, as the TPU kernel aliases its outputs onto p, mu, nu.
// Every operation is an explicitly rounded intrinsic (__fmul_rn, __fdiv_rn,
// __fsqrt_rn, __fadd_rn), so nvcc cannot contract a multiply and an add
// into an FMA: each element is rounded exactly as the plain PyTorch
// version's separate f32 ops round it, and the two agree bit for bit.
// bc1 = 1 - b1^t and bc2 = 1 - b2^t are computed on the host in f32 from
// the integer step count and are read on the card through two device
// pointers when the kernel runs: a step captured into a CUDA graph reads
// each replay's values from a buffer the host refills before the replay
// (train/optim.py BiasTable), where a by-value argument would repeat the
// captured step's numbers. Unlike the TPU kernel (>= 2^20
// elements, a multiple of 128 lanes, >= 256-row blocks) it takes any
// length, so the bias tables go through it too.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEAVES = 8;
constexpr int UNROLL = 2;       // 4-element units per thread per trip

struct DecayArgs {
  float neg_lr, b1, b2, eps;
  const float* bc1;   // one f32 each on the tables' device, read at launch
  const float* bc2;
};

// Leaf l owns units [start[l], start[l + 1]) of the flat index space.
struct LeafTable {
  float* p[MAX_LEAVES];
  float* mu[MAX_LEAVES];
  float* nu[MAX_LEAVES];
  int64_t n[MAX_LEAVES];
  int64_t start[MAX_LEAVES + 1];
  int vec[MAX_LEAVES];          // p, mu and nu all 16-byte aligned
  int count;
};

__device__ __forceinline__ void decay_one(float& p, float& mu, float& nu,
                                          const DecayArgs& a, float bc1,
                                          float bc2) {
  const float m = __fmul_rn(a.b1, mu);
  const float v = __fmul_rn(a.b2, nu);
  const float mh = __fdiv_rn(m, bc1);
  const float vh = __fdiv_rn(v, bc2);
  const float den = __fadd_rn(__fsqrt_rn(vh), a.eps);
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, __fdiv_rn(mh, den)));
  mu = m;
  nu = v;
}

// the `len` (0-4) elements of x from e, as one float4 when `vec`; the
// vector loads and stores are marked streaming (evict first): each byte is
// touched once per step, and the tables exceed the L2
__device__ __forceinline__ void load4(const float* x, int64_t e, int len,
                                      bool vec, float (&out)[4]) {
  if (vec) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(x + e));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = i < len ? x[e + i] : 0.f;
}

__device__ __forceinline__ void store4(float* x, int64_t e, int len,
                                       bool vec, const float (&in)[4]) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(x + e),
           make_float4(in[0], in[1], in[2], in[3]));
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < len) x[e + i] = in[i];
}

__global__ void __launch_bounds__(THREADS) decay_adam_kernel(
    const __grid_constant__ LeafTable t, const DecayArgs a) {
  const float bc1 = *a.bc1, bc2 = *a.bc2;
  const int64_t total = t.start[t.count];
  const int64_t chunk = (int64_t)THREADS * UNROLL;
  for (int64_t c0 = (int64_t)blockIdx.x * chunk; c0 < total;
       c0 += (int64_t)gridDim.x * chunk) {
    float P[UNROLL][4], M[UNROLL][4], V[UNROLL][4];
    int leaf[UNROLL], len[UNROLL];
    int64_t e[UNROLL];
    bool vec[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int64_t u = c0 + j * THREADS + threadIdx.x;
      int l = 0;
      while (l + 1 < t.count && u >= t.start[l + 1]) ++l;
      leaf[j] = l;
      e[j] = 4 * (u - t.start[l]);
      const int64_t left = u < total ? t.n[l] - e[j] : 0;
      len[j] = left < 4 ? (int)left : 4;
      vec[j] = len[j] == 4 && t.vec[l] != 0;
      load4(t.p[l], e[j], len[j], vec[j], P[j]);
      load4(t.mu[l], e[j], len[j], vec[j], M[j]);
      load4(t.nu[l], e[j], len[j], vec[j], V[j]);
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        decay_one(P[j][i], M[j][i], V[j][i], a, bc1, bc2);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int l = leaf[j];
      store4(t.p[l], e[j], len[j], vec[j], P[j]);
      store4(t.mu[l], e[j], len[j], vec[j], M[j]);
      store4(t.nu[l], e[j], len[j], vec[j], V[j]);
    }
  }
}

// Blocks of one full wave on the current device: SMs x resident blocks per
// SM, queried once per device.
cudaError_t wave_blocks(int& blocks) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (blocks = cache[dev].load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decay_adam_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 64) cache[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

int launch_decay(const int64_t* leaves, int n_leaves, const DecayArgs& a,
                 void* stream) {
  if (n_leaves < 0 || n_leaves > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  LeafTable t{};
  t.count = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* row = leaves + 4 * l;
    if (row[3] < 0) return (int)cudaErrorInvalidValue;
    t.p[l] = reinterpret_cast<float*>(row[0]);
    t.mu[l] = reinterpret_cast<float*>(row[1]);
    t.nu[l] = reinterpret_cast<float*>(row[2]);
    t.n[l] = row[3];
    t.vec[l] = ((row[0] | row[1] | row[2]) & 15) == 0;
    t.start[l + 1] = t.start[l] + (row[3] + 3) / 4;
  }
  const int64_t total = t.start[n_leaves];
  if (total == 0) return (int)cudaSuccess;
  int wave = 0;
  const cudaError_t err = wave_blocks(wave);
  if (err != cudaSuccess) return (int)err;
  const int64_t chunk = (int64_t)THREADS * UNROLL;
  int64_t blocks = (total + chunk - 1) / chunk;
  if (blocks > wave) blocks = wave;
  decay_adam_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(t, a);
  return (int)cudaGetLastError();
}

}  // namespace

// leaves: n_leaves (<= 8) rows of four int64 (p, mu, nu, n): three distinct
// buffers of n contiguous f32 values each, updated in place. bc1_ptr and
// bc2_ptr: one f32 each on the tables' device, read when the kernel runs.
// Returns cudaGetLastError() after the launch.
extern "C" int sml_decay_adam(const int64_t* leaves, int n_leaves,
                                  float lr, float b1, float b2, float eps,
                                  const float* bc1_ptr, const float* bc2_ptr,
                                  void* stream) {
  if (bc1_ptr == nullptr || bc2_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_decay(leaves, n_leaves,
                      DecayArgs{-lr, b1, b2, eps, bc1_ptr, bc2_ptr}, stream);
}
