// Fused RMSNorm over the rows of a (rows, d) matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm:
// _rmsnorm_kernel). There one grid step holds an 8-row block with its whole
// d_model in VMEM: var = mean(x^2) per row, out = x * rsqrt(var + eps) *
// gamma in f32, cast to x's type.
//
// Here one block normalises one row (d <= 8192). Each of 256 threads sums
// the squares of a strided part of the row in f32; the partial sums are
// reduced with warp shuffles and then across the 8 warps in shared memory,
// in a fixed order, so every thread reads the same total. Then each thread
// writes its part of the output: (x * r) * gamma, r = rsqrtf(var + eps),
// var = sum / d with an IEEE divide. r is also written per row (f32), for
// the backward pass, which is plain PyTorch.
//
// Bound: device-memory bytes for large inputs (one read of x and gamma, one
// write of the output); at the trainer's (512, 2048) bf16 the call is bound
// by the launch. The second pass re-reads the row, which a block of 8 KB or
// less finds in L1/L2. Loads are scalar and need no alignment beyond their
// type.
//
// Numbers: the sum is taken in a different order than torch.mean's, so the
// result agrees with the plain version to a tolerance, not bit for bit.
// x is f32 or bf16; gamma f32 or bf16; the output has x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename X, typename G>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const X* __restrict__ x, const G* __restrict__ gamma, X* __restrict__ out,
               float* __restrict__ rstd, int d, float eps) {
  __shared__ float warp_sum[kWarps];
  const int64_t row = blockIdx.x;
  const X* xr = x + row * d;
  X* yr = out + row * d;
  const int t = threadIdx.x;

  float s = 0.0f;
  for (int j = t; j < d; j += kThreads) {
    const float v = to_f32(xr[j]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((t & 31) == 0) warp_sum[t >> 5] = s;
  __syncthreads();
  float total = warp_sum[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, warp_sum[w]);

  const float var = __fdiv_rn(total, (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (t == 0 && rstd != nullptr) rstd[row] = r;
  for (int j = t; j < d; j += kThreads)
    yr[j] = from_f32<X>(__fmul_rn(__fmul_rn(to_f32(xr[j]), r), to_f32(gamma[j])));
}

template <typename X, typename G>
int launch(const void* x, const void* gamma, void* out, void* rstd, int64_t rows, int d,
           float eps, cudaStream_t s) {
  rmsnorm_kernel<X, G><<<(unsigned)rows, kThreads, 0, s>>>(
      reinterpret_cast<const X*>(x), reinterpret_cast<const G*>(gamma),
      reinterpret_cast<X*>(out), reinterpret_cast<float*>(rstd), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: rows * d contiguous elements, f32 (x_bf16 = 0) or bf16 (1); gamma:
// d elements, f32 (g_bf16 = 0) or bf16 (1); rstd: rows f32, or null. Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for d outside 1..8192 or an unknown type code.
extern "C" int rmsnorm_launch(const void* x, int x_bf16, const void* gamma, int g_bf16,
                              void* out, void* rstd, int64_t rows, int d, float eps,
                              void* stream) {
  if (rows <= 0) return 0;
  if (d < 1 || d > kMaxD || rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16 == 0 && g_bf16 == 0)
    return launch<float, float>(x, gamma, out, rstd, rows, d, eps, s);
  if (x_bf16 == 0 && g_bf16 == 1)
    return launch<float, __nv_bfloat16>(x, gamma, out, rstd, rows, d, eps, s);
  if (x_bf16 == 1 && g_bf16 == 0)
    return launch<__nv_bfloat16, float>(x, gamma, out, rstd, rows, d, eps, s);
  if (x_bf16 == 1 && g_bf16 == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, out, rstd, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
