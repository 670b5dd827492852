// Rotary position embedding (RoPE), forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference rotates with jnp ops
// (src/repro/models/layers.py: apply_rope), and the port ran the same chain
// as some nine elementwise launches a call each way, over f32 copies of q
// and k, plus nine more to build the cos/sin table. Added for the trace of
// gpt2-large.fedlm, where the chain held 2,016 of a local step's ~4,800
// launches.
//
// x is (B, S, H, hd) in f32, bf16 or f16, contiguous; the table is the plain
// path's own (P, hd/2) f32 cos and sin, P = S (row s for position s) or P = 1
// (one position for every s, the decode step). Each thread rotates W pairs of one head: x1 = x[.., j],
// x2 = x[.., hd/2 + j], in f32 (every product and sum an _rn intrinsic under
// -fmad=false, so nothing is contracted into an FMA):
//
//   forward   out1 = rn(rn(x1 c) - rn(x2 s)),  out2 = rn(rn(x1 s) + rn(x2 c))
//   backward  dx1  = rn(rn(g1 c) + rn(g2 s)),  dx2  = rn(rn(g2 c) - rn(g1 s))
//
// then rounds to x's type (round to nearest even). The forward is the plain
// chain's arithmetic; the backward is what autograd does through it (a
// two-term sum, whose order cannot change its bits; (-g1) s is -(g1 s)
// exactly). So both give the plain path's bits. The output is contiguous, as
// the plain chain's torch.cat makes it.
//
// Bound: device-memory bytes, one read of x and one write of the output
// (the table, 256 KB at GPT-2 Large's S = 1,024, stays in L2): 21 MB at
// (4, 1,024, 20, 64) bf16, 6.3 us at 3.35 TB/s. One thread a vector of W
// pairs, 256 threads a block, with no loop: the loads of x and of the table
// go out at once. W is 16 bytes of x (8 bf16 or f16, 4 f32) where the
// pointers and hd/2 allow it, and 1 otherwise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;      // (B, S, H, hd) contiguous
  void* out;          // (B, S, H, hd) contiguous
  const float* cos;   // (P, hd/2) contiguous
  const float* sin;
  unsigned S, H;
  int half;           // hd / 2
  int pos_step;       // 1: table row s; 0: row 0 for every s
  unsigned nv;        // vectors a half-row, half / W
  unsigned total;     // B * S * H * nv
};

// One element of type T <-> f32 (round to nearest even on the way back, as
// torch's casts on the card), and 16 bits of a 2-byte type.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float lo16(unsigned w, __nv_bfloat16) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(unsigned w, __nv_bfloat16) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float lo16(unsigned w, __half) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float hi16(unsigned w, __half) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}
__device__ __forceinline__ unsigned bits16(float v, __nv_bfloat16) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned bits16(float v, __half) {
  return __half_as_ushort(__float2half_rn(v));
}

// W values of type T at p (16-byte aligned when W > 1) <-> W floats
template <typename T, int W>
__device__ __forceinline__ void load(const T* __restrict__ p, float* f) {
  if constexpr (W == 1) {
    f[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = lo16(w[k], T());
      f[2 * k + 1] = hi16(w[k], T());
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void store(T* __restrict__ p, const float* f) {
  if constexpr (W == 1) {
    p[0] = from_f32<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bits16(f[2 * k], T()) | (bits16(f[2 * k + 1], T()) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// W table values at p (16-byte aligned when W > 1)
template <int W>
__device__ __forceinline__ void load_table(const float* __restrict__ p, float* f) {
  if constexpr (W == 1) {
    f[0] = p[0];
  } else {
#pragma unroll
    for (int k = 0; k < W; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      f[k] = q.x; f[k + 1] = q.y; f[k + 2] = q.z; f[k + 3] = q.w;
    }
  }
}

template <typename T, int W, bool BWD>
__global__ void __launch_bounds__(kThreads) rope_rotate_kernel(const Params p) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p.total) return;
  // i enumerates (b, s, h, vector) in that order; a row is one head
  const unsigned row = i / p.nv;
  const int j = (int)(i - row * p.nv) * W;
  const unsigned s = (row / p.H) % p.S;

  const T* xr = static_cast<const T*>(p.x) + (int64_t)row * (2 * p.half);
  T* outr = static_cast<T*>(p.out) + (int64_t)row * (2 * p.half);
  const int64_t t = (int64_t)(s * p.pos_step) * p.half + j;

  float x1[W], x2[W], c[W], sn[W];
  load<T, W>(xr + j, x1);
  load<T, W>(xr + p.half + j, x2);
  load_table<W>(p.cos + t, c);
  load_table<W>(p.sin + t, sn);

  float o1[W], o2[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if constexpr (BWD) {
      o1[k] = __fadd_rn(__fmul_rn(x1[k], c[k]), __fmul_rn(x2[k], sn[k]));
      o2[k] = __fsub_rn(__fmul_rn(x2[k], c[k]), __fmul_rn(x1[k], sn[k]));
    } else {
      o1[k] = __fsub_rn(__fmul_rn(x1[k], c[k]), __fmul_rn(x2[k], sn[k]));
      o2[k] = __fadd_rn(__fmul_rn(x1[k], sn[k]), __fmul_rn(x2[k], c[k]));
    }
  }
  store<T, W>(outr + j, o1);
  store<T, W>(outr + p.half + j, o2);
}

template <typename T, int W>
void launch(Params p, unsigned rows, bool backward, cudaStream_t stream) {
  p.nv = (unsigned)(p.half / W);
  p.total = rows * p.nv;
  const unsigned blocks = (p.total + kThreads - 1) / kThreads;
  if (backward)
    rope_rotate_kernel<T, W, true><<<blocks, kThreads, 0, stream>>>(p);
  else
    rope_rotate_kernel<T, W, false><<<blocks, kThreads, 0, stream>>>(p);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

template <typename T>
void dispatch(const Params& p, unsigned rows, bool backward, cudaStream_t stream) {
  constexpr int W = 16 / (int)sizeof(T);
  const bool vec = p.half % W == 0 && aligned16(p.x) && aligned16(p.out) &&
                   aligned16(p.cos) && aligned16(p.sin);
  if (vec)
    launch<T, W>(p, rows, backward, stream);
  else
    launch<T, 1>(p, rows, backward, stream);
}

}  // namespace

// Rotate x (dtype 0 f32, 1 bf16, 2 f16) by the table into out; backward != 0
// applies the transposed rotation (the gradient). B * S * H * hd / 2 must be
// below 2^32 and every size positive (the wrapper checks). Returns the CUDA
// error of the launch (0 on success).
extern "C" int rope_rotate_launch(const void* x, int dtype, const float* cos,
                                  const float* sin, int pos_step, void* out, int B, int S,
                                  int H, int half, int backward, cudaStream_t stream) {
  const Params p{x, out, cos, sin, (unsigned)S, (unsigned)H, half, pos_step, 0u, 0u};
  const unsigned rows = (unsigned)B * (unsigned)S * (unsigned)H;
  if (dtype == 0)
    dispatch<float>(p, rows, backward != 0, stream);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(p, rows, backward != 0, stream);
  else if (dtype == 2)
    dispatch<__half>(p, rows, backward != 0, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
