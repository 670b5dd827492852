// Per-tile magnitude top-k sparsification for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_sparsify.py
// (topk_sparsify: _topk_kernel). There one grid step holds a (32, 128) f32
// tile in VMEM and bisects for the threshold: lo = 0, hi = max|x| + 1e-12,
// 24 times mid = 0.5 * (lo + hi), and lo = mid while at least k elements
// have |x| >= mid, else hi = mid; then every element with |x| < lo is zeroed.
//
// Here a tile is 4096 consecutive elements of the flat input (the last one
// ragged). Bound: device-memory bytes, 4 read and 4 written per element
// (0.080 ms for one 33.5 M-element VGG-16 shard at 3.35 TB/s). The design
// keeps the search off the memory's critical path:
//
// * A persistent grid: as many 128-thread blocks as fit on the SMs (6 on an
//   H100; the SM count and the occupancy are queried once and cached), each
//   walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ...; a thread
//   holds 32 elements of its tile in registers.
// * Double buffering in dynamic shared memory (the same buffers declared
//   static ran slower on an H100; a deeper ring too, as fewer blocks fit
//   on an SM): while a block searches tile i from registers, tile i + 1
//   streams in with 16-byte cp.async. A view that is not 16-byte
//   aligned (any start offset is taken) lands shifted by the same 0..3
//   floats, so that its body still moves in 16-byte copies; the partial
//   chunks at a tile's ends and the ragged last tile move in 4-byte
//   copies. No input is copied.
// * A narrowed search. Each block-wide step counts |x| >= mid over the tile
//   (a warp reduction, then the warp sums through shared memory), so every
//   thread knows c(lo), the count of positive |x| >= lo, and c(hi), exact
//   once a step has set hi. When at most 256 positive |x| lie in [lo, hi)
//   (all those >= lo while hi has not moved), they are compacted into
//   shared memory and warp 0 runs the remaining steps on them alone, 8 a
//   lane, one warp reduction for every two steps and no block barrier:
//   count(|x| >= mid) = c(hi) + count(list >= mid) exactly, as every later
//   mid lies in [lo, hi]. A moved hi above 1e38, where lo + hi could
//   overflow to inf, keeps the steps block-wide. Whole Gaussian tiles
//   take at most 4 block-wide steps instead of 24
//   (tests/test_torch_codec_kernels.py holds a numpy model of this search).
//   The same kernel with all 24 steps block-wide ran 1.5x slower on an
//   H100, slower than the one-block-a-tile kernel before it: the 24
//   barriers a tile serialise each block, and a persistent grid has too
//   few blocks to hide them (PERF.md, tools/kernel_ab.py).
// * Stores are 16 bytes wide from registers (the output is a fresh
//   allocation); the ragged last tile stores element by element.
//
// Non-finite tiles follow the reference: amax is the largest bit pattern of
// |x| taken as an unsigned integer, which puts NaN above inf, so a tile with
// a NaN has hi = NaN, no count reaches k (for k >= 1), lo stays 0, every
// non-NaN element is kept and NaN (|NaN| >= 0 is false) is zeroed. Zeros,
// the ragged tile's missing elements among them, are never counted: every
// mid is positive.
//
// Bits: __fadd_rn / __fmul_rn in the reference's order, in f32, each step
// decided by the exact integer count, so the threshold, and with it the
// output, equal the reference's numpy mirror and Pallas kernel bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;        // 32 rows x 128 lanes, the reference's tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kTile / (4 * kThreads);   // float4s a thread holds: 8
constexpr int kEpt = 4 * kVecs;                 // elements a thread holds: 32
constexpr int kChunks = kTile / 4 + 1;          // 16-byte chunks, shifted tile
constexpr int kBuf = 4 * kChunks;               // floats a stage holds
constexpr int kBisectIters = 24;
constexpr int kListCap = 256;                   // candidates warp 0 takes
constexpr int kListPerLane = kListCap / 32;
constexpr int kStageBytes = 2 * kBuf * sizeof(float);  // the double buffer

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until only the newest group may be in flight
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of tile `tile` into `buf`: element j lands at buf[shift +
// j], so global 16-byte chunks meet 16-byte aligned shared addresses.
__device__ __forceinline__ void issue_tile(const float* __restrict__ x, int64_t n,
                                           int64_t tile, int shift, float* buf) {
  const int64_t base = tile * kTile;
  const int len = n - base < kTile ? (int)(n - base) : kTile;
  const float* g = x + base - shift;  // g[c * 4 + e] is element c * 4 + e - shift
  if (shift == 0 && len == kTile) {  // a whole, aligned tile
#pragma unroll
    for (int i = 0; i < kTile / 4 / kThreads; ++i) {
      const int c = threadIdx.x + kThreads * i;
      cp_async16(buf + 4 * c, g + 4 * c);
    }
    return;
  }
  const int chunks = (shift + len + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int j0 = 4 * c - shift;
    if (j0 >= 0 && j0 + 3 < len) {
      cp_async16(buf + 4 * c, g + 4 * c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e >= 0 && j0 + e < len) cp_async4(buf + 4 * c + e, g + 4 * c + e);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 6)
topk_kernel(const float* __restrict__ x, int64_t n, int64_t tiles, int k_keep,
            float* __restrict__ out) {
  extern __shared__ float4 stage4[];  // 2 x kBuf floats
  float* const stage = reinterpret_cast<float*>(stage4);
  __shared__ float list[kListCap];
  __shared__ unsigned red_a[kWarps], red_b[kWarps];  // amax, positive count
  __shared__ unsigned red_c[kWarps];                 // list sizes
  __shared__ int counts[2][kWarps];
  __shared__ float shared_lo;

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int shift = (int)((reinterpret_cast<uintptr_t>(x) >> 2) & 3);
  const bool out_vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  int64_t tile = blockIdx.x;
  if (tile < tiles) issue_tile(x, n, tile, shift, stage);
  cp_async_commit();

  for (int s = 0; tile < tiles; tile += gridDim.x, s ^= 1) {
    // the other stage, read in the previous iteration, takes the next
    // tile: every thread has passed a barrier since reading it. One group
    // an iteration, empty or not, so that waiting for all but the newest
    // waits for this tile.
    const int64_t next = tile + gridDim.x;
    if (next < tiles) issue_tile(x, n, next, shift, stage + (s ^ 1) * kBuf);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const int64_t base = tile * kTile;
    const int len = n - base < kTile ? (int)(n - base) : kTile;
    const bool whole = len == kTile;
    const float* buf = stage + s * kBuf;
    // element 4 * (t + kThreads * i) + c of the tile is v[4 * i + c]
    float v[kEpt];
    if (whole && shift == 0) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const float4 q = reinterpret_cast<const float4*>(buf)[t + kThreads * i];
        v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * (t + kThreads * i) + c;
          v[4 * i + c] = j < len ? buf[shift + j] : 0.0f;
        }
    }

    // amax (NaN-propagating, as bit patterns) and the count of positive |x|
    unsigned abits = 0, pos = 0;
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      abits = max(abits, __float_as_uint(v[k]) & 0x7fffffffu);
      pos += fabsf(v[k]) > 0.0f ? 1u : 0u;
    }
    abits = __reduce_max_sync(0xffffffffu, abits);
    pos = __reduce_add_sync(0xffffffffu, pos);
    if (lane == 0) {
      red_a[warp] = abits;
      red_b[warp] = pos;
    }
    __syncthreads();  // also: every thread has read this stage
    int c_lo = 0, c_hi = 0;  // count of |x| >= lo (> 0 while lo = 0), >= hi
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      abits = max(abits, red_a[w]);
      c_lo += (int)red_b[w];
    }
    const float amax = __uint_as_float(abits);

    float lo = 0.0f;
    float hi = __fadd_rn(amax, 1e-12f);
    bool hi_moved = false;  // c_hi is exact once a step has set hi
    int it = 0;
    if (amax != amax) {
      // every mid is NaN and every count 0: lo takes mid only if k <= 0
      if (k_keep <= 0) lo = amax;
      it = kBisectIters;
    }
    // block-wide steps while too many elements lie in [lo, hi), or while a
    // later lo + hi could overflow past a moved hi
    for (; it < kBisectIters && (c_lo - c_hi > kListCap || (hi_moved && hi > 1.0e38f));
         ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      unsigned c = 0;
#pragma unroll
      for (int k = 0; k < kEpt; ++k) c += fabsf(v[k]) >= mid ? 1u : 0u;
      c = __reduce_add_sync(0xffffffffu, c);
      int* cb = counts[it & 1];
      if (lane == 0) cb[warp] = (int)c;
      __syncthreads();
      int count = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) count += cb[w];
      if (count >= k_keep) {
        lo = mid;
        c_lo = count;
      } else {
        hi = mid;
        c_hi = count;
        hi_moved = true;
      }
    }

    if (it < kBisectIters) {
      // compact the positive |x| in [lo, hi), or all those >= lo while hi
      // has not moved (then c_hi = 0 is exact); a >= the least subnormal
      // is a > 0
      const float lo_eff = fmaxf(lo, __int_as_float(1));
      const float hi_lim = hi_moved ? hi : __int_as_float(0x7fffffff);  // NaN: no bound
      unsigned act = 0, mask = 0;
#pragma unroll
      for (int k = 0; k < kEpt; ++k) {
        const float a = fabsf(v[k]);
        if (a >= lo_eff && !(a >= hi_lim)) {
          mask |= 1u << k;
          ++act;
        }
      }
      unsigned incl = act;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) red_c[warp] = incl;
      __syncthreads();
      unsigned at = incl - act, m = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) at += red_c[w];
        m += red_c[w];
      }
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (mask & (1u << k)) list[at++] = fabsf(v[k]);
      __syncthreads();
      if (warp == 0) {
        const unsigned c_base = (unsigned)c_hi;
        float e[kListPerLane];
#pragma unroll
        for (int j = 0; j < kListPerLane; ++j) {
          const unsigned idx = lane + 32 * j;
          e[j] = idx < m ? list[idx] : -1.0f;  // -1 never reaches a mid
        }
        // two steps a warp reduction: the count at this step's mid and at
        // the next step's mid for either outcome, 10 bits each (<= 256)
        for (; it + 1 < kBisectIters; it += 2) {
          const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
          const float mid_keep = __fmul_rn(0.5f, __fadd_rn(mid, hi));
          const float mid_drop = __fmul_rn(0.5f, __fadd_rn(lo, mid));
          unsigned c = 0;
#pragma unroll
          for (int j = 0; j < kListPerLane; ++j)
            c += (e[j] >= mid ? 1u : 0u) | (e[j] >= mid_keep ? 1u << 10 : 0u) |
                 (e[j] >= mid_drop ? 1u << 20 : 0u);
          c = __reduce_add_sync(0xffffffffu, c);
          if ((int)(c_base + (c & 1023u)) >= k_keep) {
            lo = mid;
            if ((int)(c_base + ((c >> 10) & 1023u)) >= k_keep) lo = mid_keep;
            else hi = mid_keep;
          } else {
            hi = mid;
            if ((int)(c_base + (c >> 20)) >= k_keep) lo = mid_drop;
            else hi = mid_drop;
          }
        }
        if (it < kBisectIters) {
          const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
          unsigned c = 0;
#pragma unroll
          for (int j = 0; j < kListPerLane; ++j) c += e[j] >= mid ? 1u : 0u;
          if ((int)(c_base + __reduce_add_sync(0xffffffffu, c)) >= k_keep) lo = mid;
          else hi = mid;
        }
        if (lane == 0) shared_lo = lo;
      }
      __syncthreads();
      lo = shared_lo;
    }

    float* o = out + base;
    if (whole && out_vec) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        float4 q;
        q.x = fabsf(v[4 * i]) >= lo ? v[4 * i] : 0.0f;
        q.y = fabsf(v[4 * i + 1]) >= lo ? v[4 * i + 1] : 0.0f;
        q.z = fabsf(v[4 * i + 2]) >= lo ? v[4 * i + 2] : 0.0f;
        q.w = fabsf(v[4 * i + 3]) >= lo ? v[4 * i + 3] : 0.0f;
        reinterpret_cast<float4*>(o)[t + kThreads * i] = q;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVecs; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * (t + kThreads * i) + c;
          if (j < len) o[j] = fabsf(v[4 * i + c]) >= lo ? v[4 * i + c] : 0.0f;
        }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

int g_grid_cap = 0;  // SMs x resident blocks, queried once

}  // namespace

// x, out: n f32 elements (x at any 4-byte aligned address); keeps ~k_keep
// of each 4096-element tile. Returns cudaGetLastError() after the launch
// (0 on success), or the error of the device query.
extern "C" int topk_sparsify_launch(const void* x, int64_t n, int k_keep, void* out,
                                    void* stream) {
  if (n <= 0) return 0;
  if (g_grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel, kThreads,
                                                        kStageBytes);
    if (e != cudaSuccess) return (int)e;
    g_grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t grid = tiles < g_grid_cap ? tiles : g_grid_cap;
  topk_kernel<<<(unsigned)grid, kThreads, kStageBytes, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(x), n, tiles, k_keep, reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}
