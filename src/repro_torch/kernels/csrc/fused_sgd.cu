// Fused SGD-with-momentum update, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_sgd.py (fused_sgd:
// _sgd_kernel). There one grid step holds a (32, 128) tile of p, g and v in
// VMEM and writes v' = mu * v + g and p' = p - lr * v' as new arrays (the
// wrapper donates p and v). Here the leaf stays flat and is updated in
// place: each element of p, g and v is read once and v, p written once.
//
// Bound: device-memory bytes. An f32 element moves 20 bytes (three reads,
// two writes) for three operations, far below the card's rate. The first
// port read every element with a scalar 4-byte load in a grid-stride loop,
// one element a thread an iteration: 80 % of the bound, behind
// torch.optim.SGD(fused=True) (NVIDIA H100 80GB HBM3, 700 W, PERF.md). Here
// the body moves 16 bytes a load: a float4 of v and of an f32 p or g, 8
// bytes (4 values) of a bf16 p or g, so 4 elements a thread match one
// float4 of v; each thread has two such vectors of all three in flight an
// iteration, and the grid is 4 blocks of 256 threads on each SM. A scalar
// head runs up to the first index where p, g and v are all aligned, a
// scalar tail over the ragged end. When the three offsets disagree modulo
// the vector, no index aligns them all, and the whole leaf runs the scalar
// loop: still this kernel, any view of a leaf works.
//
// tools/kernel_ab.py --kernels fused_sgd, one step over the 12 full-width
// tinyllama-1.1b leaves, device ms (NVIDIA H100 80GB HBM3, 700 W): 7.71
// here against 8.31 for the scalar source, 85 % of the 6.567 ms bound;
// torch.optim.SGD(fused=True)'s kernels 8.12. Unrolling 1, 2 or 4 vectors,
// 2, 4 or 8 blocks an SM and evict-first hints all read 7.66-7.77 but 4
// vectors at 4 blocks (8.03): the bytes bound it, not the instruction rate.
//
// Bits: v' = __fadd_rn(__fmul_rn(mu, v), g) and
// p' = __fsub_rn(p, __fmul_rn(lr, v')), each rounded to nearest and never
// contracted (the build passes -fmad=false too), then p' is cast back to p's
// type with round to nearest. That is PyTorch's
// v.mul_(mu).add_(g); p.sub_(v * lr) on f32 operands, bit for bit, whatever
// the route or the vector width.
// p is f32 or bf16, g f32 or bf16, v f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;   // 1,024 threads an SM
constexpr int kVec = 4;           // elements a vector
constexpr int kUnroll = 2;        // vectors in flight a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One element's update, the arithmetic of every route.
__device__ __forceinline__ void sgd1(float& p, float g, float& v, float lr, float mu) {
  v = __fadd_rn(__fmul_rn(mu, v), g);
  p = __fsub_rn(p, __fmul_rn(lr, v));
}

template <typename P, typename G>
__device__ __forceinline__ void scalar_step(P* __restrict__ p, const G* __restrict__ g,
                                            float* __restrict__ v, int64_t i, float lr,
                                            float mu) {
  float pi = to_f32(p[i]), vi = v[i];
  sgd1(pi, to_f32(g[i]), vi, lr, mu);
  v[i] = vi;
  p[i] = from_f32<P>(pi);
}

// 4 values of T as one aligned load: float4 for f32, 8 bytes for bf16.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  __device__ static void unpack(const float4& a, float (&x)[kVec]) {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static float4 pack(const float (&x)[kVec]) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  using type = uint2;
  __device__ static void unpack(const uint2& a, float (&x)[kVec]) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&a.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&a.y);
    x[0] = __low2float(lo); x[1] = __high2float(lo);
    x[2] = __low2float(hi); x[3] = __high2float(hi);
  }
  __device__ static uint2 pack(const float (&x)[kVec]) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(x[0]),
                                                 __float2bfloat16_rn(x[1]));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(x[2]),
                                                 __float2bfloat16_rn(x[3]));
    uint2 a;
    a.x = *reinterpret_cast<const uint32_t*>(&lo);
    a.y = *reinterpret_cast<const uint32_t*>(&hi);
    return a;
  }
};

template <typename P, typename G>
__device__ __forceinline__ void vec_step(typename Vec<P>::type& pv,
                                         const typename Vec<G>::type& gv, float4& vv,
                                         float lr, float mu) {
  float p[kVec], g[kVec];
  float v[kVec] = {vv.x, vv.y, vv.z, vv.w};
  Vec<P>::unpack(pv, p);
  Vec<G>::unpack(gv, g);
#pragma unroll
  for (int k = 0; k < kVec; ++k) sgd1(p[k], g[k], v[k], lr, mu);
  vv = make_float4(v[0], v[1], v[2], v[3]);
  pv = Vec<P>::pack(p);
}

// Elements [0, head) and [head + kVec * nvec, n) one a thread; the nvec
// vectors from head kUnroll a thread an iteration, all loaded before any is
// updated. head is where p, g and v are all vector-aligned.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
fused_sgd_vec_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ v,
                     int64_t n, int64_t head, float lr, float mu) {
  using PV = typename Vec<P>::type;
  using GV = typename Vec<G>::type;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t nthreads = (int64_t)gridDim.x * kThreads;
  const int64_t nvec = (n - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  if (tid < head) scalar_step(p, g, v, tid, lr, mu);
  if (tid < n - tail) scalar_step(p, g, v, tail + tid, lr, mu);
  PV* pv = reinterpret_cast<PV*>(p + head);
  const GV* gv = reinterpret_cast<const GV*>(g + head);
  float4* vv = reinterpret_cast<float4*>(v + head);
  for (int64_t i = tid; i < nvec; i += kUnroll * nthreads) {
    PV pa[kUnroll];
    GV ga[kUnroll];
    float4 va[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * nthreads;
      if (j < nvec) {
        pa[u] = pv[j];
        ga[u] = gv[j];
        va[u] = vv[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * nthreads;
      if (j < nvec) {
        vec_step<P, G>(pa[u], ga[u], va[u], lr, mu);
        vv[j] = va[u];
        pv[j] = pa[u];
      }
    }
  }
}

// Every element, one a thread an iteration: leaves whose offsets no index
// aligns.
template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
fused_sgd_kernel(P* __restrict__ p, const G* __restrict__ g, float* __restrict__ v,
                 int64_t n, float lr, float mu) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    scalar_step(p, g, v, i, lr, mu);
}

int sm_count() {
  static int sms = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 132;
    return count;
  }();
  return sms;
}

// The first index in [0, kVec) at which p, g and v all start a vector, or
// -1 when none does.
template <typename P, typename G>
int64_t aligned_head(const void* p, const void* g, const void* v) {
  for (int64_t h = 0; h < kVec; ++h) {
    const uintptr_t ap = reinterpret_cast<uintptr_t>(p) + h * sizeof(P);
    const uintptr_t ag = reinterpret_cast<uintptr_t>(g) + h * sizeof(G);
    const uintptr_t av = reinterpret_cast<uintptr_t>(v) + h * sizeof(float);
    if (ap % (kVec * sizeof(P)) == 0 && ag % (kVec * sizeof(G)) == 0 &&
        av % (kVec * sizeof(float)) == 0)
      return h;
  }
  return -1;
}

template <typename P, typename G>
int launch(void* p, const void* g, void* v, int64_t n, float lr, float mu, cudaStream_t s) {
  const int64_t max_blocks = (int64_t)sm_count() * kBlocksPerSm;
  P* pp = reinterpret_cast<P*>(p);
  const G* gp = reinterpret_cast<const G*>(g);
  float* vp = reinterpret_cast<float*>(v);
  const int64_t head = aligned_head<P, G>(p, g, v);
  if (head >= 0 && head <= n) {
    // kUnroll vectors a thread; at least enough threads for head and tail
    const int64_t per_block = (int64_t)kUnroll * kThreads;
    const int64_t need = ((n - head) / kVec + per_block - 1) / per_block;
    const int blocks = (int)(need < 1 ? 1 : need < max_blocks ? need : max_blocks);
    fused_sgd_vec_kernel<P, G><<<blocks, kThreads, 0, s>>>(pp, gp, vp, n, head, lr, mu);
  } else {
    const int64_t need = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(need < max_blocks ? need : max_blocks);
    fused_sgd_kernel<P, G><<<blocks, kThreads, 0, s>>>(pp, gp, vp, n, lr, mu);
  }
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
