// Per-tile magnitude top-k sparsification for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sparsify.py
// (topk_sparsify: _topk_kernel). There one grid step holds a (32, 128) f32
// tile in VMEM and bisects for the threshold: lo = 0, hi = max|x| + 1e-12,
// 24 times mid = 0.5 * (lo + hi), and lo = mid while at least k elements
// have |x| >= mid, else hi = mid; then every element with |x| < lo is zeroed.
//
// Here a tile is 4096 consecutive elements of the flat input (the last one
// ragged), and one block of 256 threads holds it in registers, 16 elements a
// thread, element k of thread t at tile[k * 256 + t] so that warps load and
// store contiguous runs. Each bisection step counts |x| >= mid in integers:
// a per-thread count, a warp sum (__reduce_add_sync), then the 8 warp sums
// through shared memory, which every thread adds in the same order. Integer
// sums do not depend on order, so every thread holds the same lo and hi and
// the control flow stays uniform. The shared buffer alternates between two
// halves, so one __syncthreads() per step is enough.
//
// Elements past the end of the input load as 0 and are not stored. They do
// not change the result: zeros cannot raise amax, and every mid is at least
// half of hi > 0, so a zero is never counted.
//
// Bound: device-memory bytes. The kernel reads 4 bytes and writes 4 per
// element; its 24 compare-and-count steps run on the registers, so device
// memory sees each element once each way.
//
// Bits: __fadd_rn / __fmul_rn in the reference's order, in f32, so the
// threshold, and with it the output, equal the reference's numpy mirror and
// Pallas kernel bit for bit. Loads and stores are scalar: no alignment
// beyond the type is assumed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;     // 32 rows x 128 lanes, the reference's tile
constexpr int kThreads = 256;
constexpr int kEpt = kTile / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 24;

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, int64_t n, int k_keep, float* __restrict__ out) {
  __shared__ float warp_max[kWarps];
  __shared__ int warp_count[2][kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  float v[kEpt];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int64_t i = base + k * kThreads + t;
    v[k] = i < n ? x[i] : 0.0f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, warp_max[w]);

  float lo = 0.0f;
  float hi = __fadd_rn(amax, 1e-12f);
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
#pragma unroll
    for (int k = 0; k < kEpt; ++k) c += fabsf(v[k]) >= mid ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    int* buf = warp_count[it & 1];
    if (lane == 0) buf[warp] = (int)c;
    __syncthreads();
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) count += buf[w];
    if (count >= k_keep) lo = mid;
    else hi = mid;
  }

#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int64_t i = base + k * kThreads + t;
    if (i < n) out[i] = fabsf(v[k]) >= lo ? v[k] : 0.0f;
  }
}

}  // namespace

// x, out: n f32 elements; keeps ~k_keep of each 4096-element tile.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int topk_sparsify_launch(const void* x, int64_t n, int k_keep, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  topk_kernel<<<(unsigned)tiles, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(x), n, k_keep, reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}
