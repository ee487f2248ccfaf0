// K3 decay_adam_kernel: one g=0 dense-Adam step over a whole table, in place.
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
// caller.
//
// Bound on an H100 SXM: bytes. Each element is read and written once in
// each of p, mu and nu (24 bytes) for 8 operations, so at 3.35 TB/s the
// pass over the Yelp tables (100,000 + 20,000 rows x 64, plus the two bias
// columns: 7.8M elements, 187.2 MB) cannot take less than 0.0559 ms; the
// operations (62 MFLOP) would take ~0.001 ms at 67 TFLOP/s.
//
// Design: a grid-stride streaming pass over the flat table with 16-byte
// (float4) loads and stores for the body and a scalar tail, nothing staged
// in shared memory. It works in place, as the TPU kernel aliases its
// outputs onto p, mu, nu. Every operation is an explicitly rounded
// intrinsic (__fmul_rn, __fdiv_rn, __fsqrt_rn, __fadd_rn), so nvcc cannot
// contract a multiply and an add into an FMA: each element is rounded
// exactly as the plain PyTorch version's separate f32 ops round it, and the
// two agree bit for bit. bc1 = 1 - b1^t and bc2 = 1 - b2^t come by value,
// computed on the host in f32 from the integer step count. Unlike the TPU
// kernel (>= 2^20 elements, a multiple of 128 lanes, >= 256-row blocks)
// it takes any length, so the bias tables go through it too.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int64_t MAX_BLOCKS = 8192;   // the grid strides beyond this

struct DecayArgs {
  float neg_lr, b1, b2, eps, bc1, bc2;
};

__device__ __forceinline__ void decay_one(float& p, float& mu, float& nu,
                                          const DecayArgs& a) {
  const float m = __fmul_rn(a.b1, mu);
  const float v = __fmul_rn(a.b2, nu);
  const float mh = __fdiv_rn(m, a.bc1);
  const float vh = __fdiv_rn(v, a.bc2);
  const float den = __fadd_rn(__fsqrt_rn(vh), a.eps);
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, __fdiv_rn(mh, den)));
  mu = m;
  nu = v;
}

__device__ __forceinline__ void decay_vec(float4& p, float4& mu, float4& nu,
                                          const DecayArgs& a) {
  decay_one(p.x, mu.x, nu.x, a);
  decay_one(p.y, mu.y, nu.y, a);
  decay_one(p.z, mu.z, nu.z, a);
  decay_one(p.w, mu.w, nu.w, a);
}

// n_vec float4 groups from the start, then the scalar elements from
// 4*n_vec to n (n_vec = 0 when a pointer is not 16-byte aligned)
__global__ void __launch_bounds__(THREADS) decay_adam_kernel(
    float* __restrict__ p, float* __restrict__ mu, float* __restrict__ nu,
    int64_t n, int64_t n_vec, DecayArgs a) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float4* __restrict__ p4 = reinterpret_cast<float4*>(p);
  float4* __restrict__ mu4 = reinterpret_cast<float4*>(mu);
  float4* __restrict__ nu4 = reinterpret_cast<float4*>(nu);
  for (int64_t k = first; k < n_vec; k += stride) {
    float4 pv = p4[k];
    float4 mv = mu4[k];
    float4 vv = nu4[k];
    decay_vec(pv, mv, vv, a);
    p4[k] = pv;
    mu4[k] = mv;
    nu4[k] = vv;
  }
  for (int64_t k = 4 * n_vec + first; k < n; k += stride) {
    float pv = p[k];
    float mv = mu[k];
    float vv = nu[k];
    decay_one(pv, mv, vv, a);
    p[k] = pv;
    mu[k] = mv;
    nu[k] = vv;
  }
}

}  // namespace

// p, mu, nu: n contiguous f32 values each, distinct buffers, updated in
// place. vec: all three pointers are 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int sml_decay_adam(void* p, void* mu, void* nu, int64_t n,
                              int vec, float lr, float b1, float b2,
                              float eps, float bc1, float bc2, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t n_vec = vec ? n / 4 : 0;
  const int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  DecayArgs a{-lr, b1, b2, eps, bc1, bc2};
  decay_adam_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(mu),
      static_cast<float*>(nu), n, n_vec, a);
  return (int)cudaGetLastError();
}
