// Fused SGD-with-momentum update, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sgd.py (fused_sgd:
// _sgd_kernel). There one grid step holds a (32, 128) tile of p, g and v in
// VMEM and writes v' = mu * v + g and p' = p - lr * v' as new arrays (the
// wrapper donates p and v). Here the leaf stays flat and is updated in
// place: each thread of a grid-stride loop reads p[i], g[i], v[i] once and
// writes v[i], p[i] once.
//
// Bound: device-memory bytes. An f32 element moves 20 bytes (three reads,
// two writes) for three operations, far below the card's rate; the design
// is one pass with coalesced scalar loads, so nothing is read twice. Loads
// need no alignment beyond their type, so any view of a leaf works.
//
// Bits: v' = __fadd_rn(__fmul_rn(mu, v), g) and
// p' = __fsub_rn(p, __fmul_rn(lr, v')), each rounded to nearest and never
// contracted (the build passes -fmad=false too), then p' is cast back to p's
// type with round to nearest. That is PyTorch's
// v.mul_(mu).add_(g); p.sub_(v * lr) on f32 operands, bit for bit.
// p is f32 or bf16, g f32 or bf16, v f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;   // 8 resident blocks on each of 132 SMs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ v,
                 int64_t n, float lr, float mu) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const float vi = __fadd_rn(__fmul_rn(mu, v[i]), to_f32(g[i]));
    v[i] = vi;
    p[i] = from_f32<P>(__fsub_rn(to_f32(p[i]), __fmul_rn(lr, vi)));
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, void* v, int64_t n, float lr, float mu, cudaStream_t s) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(need < kMaxBlocks ? need : kMaxBlocks);
  fused_sgd_kernel<P, G><<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<P*>(p), reinterpret_cast<const G*>(g), reinterpret_cast<float*>(v), n,
      lr, mu);
  return (int)cudaGetLastError();
}

}  // namespace

// p: n elements of f32 (p_bf16 = 0) or bf16 (1); g likewise (g_bf16); v: n f32.
// Updates v and p in place. Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a type code other than 0 or 1.
extern "C" int fused_sgd_launch(void* p, int p_bf16, const void* g, int g_bf16, void* v,
                                int64_t n, float lr, float mu, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (p_bf16 == 0 && g_bf16 == 0) return launch<float, float>(p, g, v, n, lr, mu, s);
  if (p_bf16 == 0 && g_bf16 == 1) return launch<float, __nv_bfloat16>(p, g, v, n, lr, mu, s);
  if (p_bf16 == 1 && g_bf16 == 0) return launch<__nv_bfloat16, float>(p, g, v, n, lr, mu, s);
  if (p_bf16 == 1 && g_bf16 == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, v, n, lr, mu, s);
  return (int)cudaErrorInvalidValue;
}
