// Fused RMSNorm over the rows of a (rows, d) matrix, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm:
// _rmsnorm_kernel). There one grid step holds an 8-row block with its whole
// d_model in VMEM: var = mean(x^2) per row, out = x * rsqrt(var + eps) *
// gamma in f32, cast to x's type.
//
// Bound: device-memory bytes, one read of x and gamma and one write of the
// output and the per-row rstd: 4,204,544 bytes, 1.255 us at 3.35 TB/s, at
// the trainer's (512, 2048) bf16 with f32 gamma. At that size a call is
// short enough that latency decides its time, so the design keeps the
// chain from the first load to the last store short:
//
// * One block a row, 128 threads up to d = 2048 (16 values a thread) and
//   256 above, up to d = 8192 (32 values a thread): 512 rows are 512
//   blocks over all 132 SMs, several blocks each.
// * The row is read once, into registers, every load issued at once; so is
//   the thread's part of gamma, straight into registers (one row a block
//   reads gamma once per block). Staging gamma through shared memory for
//   several rows a block put a load, a store and a barrier before the
//   first output and was slower.
// * Loads and stores of x and the output are 16 bytes wide (8 bf16 or 4
//   f32) when x's start, its row stride in bytes and d * itemsize allow it,
//   and element by element otherwise; gamma is read 16 (or 8) bytes at a
//   time when it is aligned with unit stride. No input is copied; rows may
//   be strided (stride(1) must be 1).
// * The sum of squares: four partial sums a thread, warp shuffles, then the
//   warp sums through shared memory in a fixed order (the one barrier).
//
// r = rsqrtf(var + eps), var = sum / d with an IEEE divide, out = (x * r) *
// gamma; r is also written per row (f32) for the backward pass, which is
// plain PyTorch.
//
// Numbers: the sum is taken in a different order than torch.mean's, so the
// result agrees with the plain version to a tolerance, not bit for bit.
// x is f32 or bf16; gamma f32 or bf16; the output has x's type.
//
// The split route (tensor parallelism: a row cut over the ranks of the model
// axis, as Mamba-2's gated norm over a split d_inner) is two more entry
// points over the same device code: rmsnorm_sumsq_launch writes each row's
// f32 sum of squares over the rank's block (the whole-row kernel's load and
// sum), the caller all-reduces it over the ranks, and rmsnorm_scale_launch
// writes out = x * rsqrt(ssq / d_total + eps) * gamma and rstd from it, with
// no reduction of its own. Bounds: the first reads the block and writes 4
// bytes a row; the second reads the block, gamma and 4 bytes a row and
// writes the output and 4 bytes a row. With one block (d_total = d) the
// route's sum is the whole-row kernel's, bit for bit. rmsnorm_launch keeps
// its signature and its bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8192;
constexpr int kSmallD = 2048;       // 128 threads a row up to this d
constexpr int kSmallThreads = 128;
constexpr int kLargeThreads = 256;  // 256 above it

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// 16 bytes of X <-> W floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x); f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
  f[4] = bf16_lo(u.z); f[5] = bf16_hi(u.z); f[6] = bf16_lo(u.w); f[7] = bf16_hi(u.w);
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// gamma[j .. j + W) as f32: W-wide loads when g_vec (unit stride, 16-byte
// aligned start; j is a multiple of W), element by element otherwise.
template <int W>
__device__ __forceinline__ void load_gamma(const void* __restrict__ gamma, int g_bf16,
                                           int g_vec, int64_t g_stride, int j, float* f) {
  const float* gf = reinterpret_cast<const float*>(gamma);
  const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(gamma);
  if constexpr (W > 1) {
    if (g_vec) {
      if (g_bf16) {
        if constexpr (W == 8) {
          unpack(*reinterpret_cast<const uint4*>(gb + j), f, __nv_bfloat16());
        } else {
          const uint2 u = *reinterpret_cast<const uint2*>(gb + j);
          f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x); f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
        }
      } else {
#pragma unroll
        for (int c = 0; c < W; c += 4) {
          const float4 q = *reinterpret_cast<const float4*>(gf + j + c);
          f[c] = q.x; f[c + 1] = q.y; f[c + 2] = q.z; f[c + 3] = q.w;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < W; ++c)
    f[c] = g_bf16 ? __bfloat162float(gb[(j + c) * g_stride]) : gf[(j + c) * g_stride];
}

// The row's part of thread t, into registers: element j = (t + TPR * i) * W + c
// of the row is v[i * W + c], zero beyond d. VEC: 16-byte loads.
template <typename X, int TPR, int VPT, bool VEC>
__device__ __forceinline__ void load_row(const X* __restrict__ xr, int d, int t, float* v) {
  constexpr int W = VEC ? 16 / (int)sizeof(X) : 1;  // elements a load
  constexpr int NL = VPT / W;                       // loads a thread
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int j = (t + TPR * i) * W;
    if (j < d) {
      if constexpr (VEC) {
        unpack(*reinterpret_cast<const uint4*>(xr + j), v + i * W, X());
      } else {
        v[i] = to_f32(xr[j]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c) v[i * W + c] = 0.0f;
    }
  }
}

// gamma at the same positions as load_row's v.
template <typename X, int TPR, int VPT, bool VEC>
__device__ __forceinline__ void load_row_gamma(const void* __restrict__ gamma, int g_bf16,
                                               int g_vec, int64_t g_stride, int d, int t,
                                               float* gm) {
  constexpr int W = VEC ? 16 / (int)sizeof(X) : 1;
  constexpr int NL = VPT / W;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int j = (t + TPR * i) * W;
    if (j < d) load_gamma<W>(gamma, g_bf16, g_vec, g_stride, j, gm + i * W);
  }
}

// The row's sum of squares, the same value in every thread of the block: four
// partial sums a thread, warp shuffles, then the warp sums through shared
// memory in a fixed order (the one barrier).
template <int TPR, int VPT>
__device__ __forceinline__ float row_sumsq(const float* v, float* warp_sum, int t) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
  for (int k = 0; k < VPT; k += 4) {
    s0 = __fadd_rn(s0, __fmul_rn(v[k], v[k]));
    s1 = __fadd_rn(s1, __fmul_rn(v[k + 1], v[k + 1]));
    s2 = __fadd_rn(s2, __fmul_rn(v[k + 2], v[k + 2]));
    s3 = __fadd_rn(s3, __fmul_rn(v[k + 3], v[k + 3]));
  }
  float s = __fadd_rn(__fadd_rn(s0, s1), __fadd_rn(s2, s3));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((t & 31) == 0) warp_sum[t >> 5] = s;
  __syncthreads();
  s = warp_sum[0];
#pragma unroll
  for (int w = 1; w < TPR / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
  return s;
}

// out = (x * r) * gamma, in x's type, at load_row's positions.
template <typename X, int TPR, int VPT, bool VEC>
__device__ __forceinline__ void store_row(X* __restrict__ yr, const float* v, const float* gm,
                                         float r, int d, int t) {
  constexpr int W = VEC ? 16 / (int)sizeof(X) : 1;
  constexpr int NL = VPT / W;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int j = (t + TPR * i) * W;
    if (j < d) {
      float y[W];
#pragma unroll
      for (int c = 0; c < W; ++c)
        y[c] = __fmul_rn(__fmul_rn(v[i * W + c], r), gm[i * W + c]);
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(yr + j) = pack(y, X());
      } else {
        yr[j] = from_f32<X>(y[0]);
      }
    }
  }
}

// One block of TPR threads a row, VPT values a thread at most; VEC: 16-byte
// loads and stores of x and the output.
template <typename X, int TPR, int VPT, bool VEC>
__global__ void __launch_bounds__(TPR)
rmsnorm_kernel(const X* __restrict__ x, int64_t x_stride, const void* __restrict__ gamma,
               int g_bf16, int g_vec, int64_t g_stride, X* __restrict__ out,
               float* __restrict__ rstd, int d, float eps) {
  __shared__ float warp_sum[TPR / 32];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  float v[VPT], gm[VPT];
  load_row<X, TPR, VPT, VEC>(x + row * x_stride, d, t, v);
  load_row_gamma<X, TPR, VPT, VEC>(gamma, g_bf16, g_vec, g_stride, d, t, gm);
  const float s = row_sumsq<TPR, VPT>(v, warp_sum, t);
  const float var = __fdiv_rn(s, (float)d);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (t == 0 && rstd != nullptr) rstd[row] = r;
  store_row<X, TPR, VPT, VEC>(out + row * (int64_t)d, v, gm, r, d, t);
}

// The split route, step 1: each row's sum of squares over this rank's block
// of the row, the whole-row kernel's load and sum.
template <typename X, int TPR, int VPT, bool VEC>
__global__ void __launch_bounds__(TPR)
rmsnorm_sumsq_kernel(const X* __restrict__ x, int64_t x_stride, float* __restrict__ ssq,
                     int d) {
  __shared__ float warp_sum[TPR / 32];
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  float v[VPT];
  load_row<X, TPR, VPT, VEC>(x + row * x_stride, d, t, v);
  const float s = row_sumsq<TPR, VPT>(v, warp_sum, t);
  if (t == 0) ssq[row] = s;
}

// The split route, step 2: the block's output from the row's sum of squares
// over all d_total elements (summed over the ranks by the caller); no
// reduction, so no barrier.
template <typename X, int TPR, int VPT, bool VEC>
__global__ void __launch_bounds__(TPR)
rmsnorm_scale_kernel(const X* __restrict__ x, int64_t x_stride, const float* __restrict__ ssq,
                     const void* __restrict__ gamma, int g_bf16, int g_vec, int64_t g_stride,
                     X* __restrict__ out, float* __restrict__ rstd, int d, float d_total,
                     float eps) {
  const int t = threadIdx.x;
  const int64_t row = blockIdx.x;
  float v[VPT], gm[VPT];
  load_row<X, TPR, VPT, VEC>(x + row * x_stride, d, t, v);
  load_row_gamma<X, TPR, VPT, VEC>(gamma, g_bf16, g_vec, g_stride, d, t, gm);
  const float var = __fdiv_rn(ssq[row], d_total);
  const float r = rsqrtf(__fadd_rn(var, eps));
  if (t == 0) rstd[row] = r;
  store_row<X, TPR, VPT, VEC>(out + row * (int64_t)d, v, gm, r, d, t);
}

template <typename X, int TPR, int VPT>
void run(bool vec, int64_t rows, const void* x, int64_t xs, const void* g, int g_bf16,
         int g_vec, int64_t gs, void* out, void* rstd, int d, float eps, cudaStream_t s) {
  const auto kernel =
      vec ? rmsnorm_kernel<X, TPR, VPT, true> : rmsnorm_kernel<X, TPR, VPT, false>;
  kernel<<<(unsigned)rows, TPR, 0, s>>>(reinterpret_cast<const X*>(x), xs, g, g_bf16, g_vec,
                                        gs, reinterpret_cast<X*>(out),
                                        reinterpret_cast<float*>(rstd), d, eps);
}

template <typename X>
bool vec_rows(const void* x, int64_t xs, int d) {
  constexpr int W = 16 / (int)sizeof(X);
  return (reinterpret_cast<uintptr_t>(x) & 15) == 0 && ((xs * (int64_t)sizeof(X)) & 15) == 0 &&
         d % W == 0;
}

template <typename X>
int launch(const void* x, int64_t xs, const void* g, int g_bf16, int64_t gs, void* out,
           void* rstd, int64_t rows, int d, float eps, cudaStream_t s) {
  const bool vec = vec_rows<X>(x, xs, d) && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int g_vec = gs == 1 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (d <= kSmallD)
    run<X, kSmallThreads, kSmallD / kSmallThreads>(vec, rows, x, xs, g, g_bf16, g_vec, gs,
                                                   out, rstd, d, eps, s);
  else
    run<X, kLargeThreads, kMaxD / kLargeThreads>(vec, rows, x, xs, g, g_bf16, g_vec, gs, out,
                                                 rstd, d, eps, s);
  return (int)cudaGetLastError();
}

template <typename X, int TPR, int VPT>
void run_sumsq(bool vec, int64_t rows, const void* x, int64_t xs, void* ssq, int d,
               cudaStream_t s) {
  const auto kernel = vec ? rmsnorm_sumsq_kernel<X, TPR, VPT, true>
                          : rmsnorm_sumsq_kernel<X, TPR, VPT, false>;
  kernel<<<(unsigned)rows, TPR, 0, s>>>(reinterpret_cast<const X*>(x), xs,
                                        reinterpret_cast<float*>(ssq), d);
}

template <typename X>
int launch_sumsq(const void* x, int64_t xs, void* ssq, int64_t rows, int d, cudaStream_t s) {
  const bool vec = vec_rows<X>(x, xs, d);
  if (d <= kSmallD)
    run_sumsq<X, kSmallThreads, kSmallD / kSmallThreads>(vec, rows, x, xs, ssq, d, s);
  else
    run_sumsq<X, kLargeThreads, kMaxD / kLargeThreads>(vec, rows, x, xs, ssq, d, s);
  return (int)cudaGetLastError();
}

template <typename X, int TPR, int VPT>
void run_scale(bool vec, int64_t rows, const void* x, int64_t xs, const void* ssq,
               const void* g, int g_bf16, int g_vec, int64_t gs, void* out, void* rstd, int d,
               float d_total, float eps, cudaStream_t s) {
  const auto kernel = vec ? rmsnorm_scale_kernel<X, TPR, VPT, true>
                          : rmsnorm_scale_kernel<X, TPR, VPT, false>;
  kernel<<<(unsigned)rows, TPR, 0, s>>>(reinterpret_cast<const X*>(x), xs,
                                        reinterpret_cast<const float*>(ssq), g, g_bf16, g_vec,
                                        gs, reinterpret_cast<X*>(out),
                                        reinterpret_cast<float*>(rstd), d, d_total, eps);
}

template <typename X>
int launch_scale(const void* x, int64_t xs, const void* ssq, const void* g, int g_bf16,
                 int64_t gs, void* out, void* rstd, int64_t rows, int d, float d_total,
                 float eps, cudaStream_t s) {
  const bool vec = vec_rows<X>(x, xs, d) && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int g_vec = gs == 1 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  if (d <= kSmallD)
    run_scale<X, kSmallThreads, kSmallD / kSmallThreads>(vec, rows, x, xs, ssq, g, g_bf16,
                                                         g_vec, gs, out, rstd, d, d_total,
                                                         eps, s);
  else
    run_scale<X, kLargeThreads, kMaxD / kLargeThreads>(vec, rows, x, xs, ssq, g, g_bf16, g_vec,
                                                       gs, out, rstd, d, d_total, eps, s);
  return (int)cudaGetLastError();
}

}  // namespace

// x: rows of d elements, row r at x + r * x_stride (elements), f32 (x_bf16 =
// 0) or bf16 (1); gamma: d elements g_stride apart, f32 (g_bf16 = 0) or bf16
// (1); out: rows * d contiguous elements of x's type; rstd: rows f32, or
// null. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for d outside 1..8192, too many rows or an unknown
// type code.
extern "C" int rmsnorm_launch(const void* x, int x_bf16, int64_t x_stride, const void* gamma,
                              int g_bf16, int64_t g_stride, void* out, void* rstd,
                              int64_t rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d < 1 || d > kMaxD || rows > 0x7fffffffLL || (x_bf16 >> 1) || (g_bf16 >> 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, x_stride, gamma, g_bf16, g_stride, out, rstd, rows, d, eps,
                                 s);
  return launch<float>(x, x_stride, gamma, g_bf16, g_stride, out, rstd, rows, d, eps, s);
}

// The split route, step 1. x as for rmsnorm_launch (a rank's block of each
// row, d <= 8192 elements); ssq: rows f32, each row's sum of squares over the
// block, in the whole-row kernel's order. Returns as rmsnorm_launch does.
extern "C" int rmsnorm_sumsq_launch(const void* x, int x_bf16, int64_t x_stride, void* ssq,
                                    int64_t rows, int d, void* stream) {
  if (rows <= 0) return 0;
  if (d < 1 || d > kMaxD || rows > 0x7fffffffLL || (x_bf16 >> 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16) return launch_sumsq<__nv_bfloat16>(x, x_stride, ssq, rows, d, s);
  return launch_sumsq<float>(x, x_stride, ssq, rows, d, s);
}

// The split route, step 2. x and gamma as for rmsnorm_launch (gamma: the
// block's d elements); ssq: rows f32, each row's sum of squares over the
// whole row of d_total >= d elements; out: rows * d contiguous elements of
// x's type, out = x * rsqrt(ssq / d_total + eps) * gamma; rstd: rows f32.
extern "C" int rmsnorm_scale_launch(const void* x, int x_bf16, int64_t x_stride,
                                    const void* ssq, const void* gamma, int g_bf16,
                                    int64_t g_stride, void* out, void* rstd, int64_t rows,
                                    int d, int64_t d_total, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d < 1 || d > kMaxD || d_total < d || d_total > (1LL << 24) || rows > 0x7fffffffLL ||
      (x_bf16 >> 1) || (g_bf16 >> 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_scale<__nv_bfloat16>(x, x_stride, ssq, gamma, g_bf16, g_stride, out, rstd,
                                       rows, d, (float)d_total, eps, s);
  return launch_scale<float>(x, x_stride, ssq, gamma, g_bf16, g_stride, out, rstd, rows, d,
                             (float)d_total, eps, s);
}
