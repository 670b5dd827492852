// Streaming FedAvg fold for Hopper (sm_90a): many averaging nodes, one launch,
// and the carry route for one node whose inputs are the rows of a 2-D tensor.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_stream.py
// (fedavg_stream: _fedavg_kernel + _finalize_kernel). There the grid walks
// (row block, client) with the client axis innermost and carries the sum in
// VMEM across grid steps, then a second pass divides. Here each thread owns
// elements of one node and walks the node's clients 0..N-1 in order,
// keeping the sums in registers; the divide ends the same loop. There is
// one pass and the accumulator never touches device memory.
//
// Bound: device-memory bytes. Per node the fold reads N inputs of L
// elements and writes one f32 output: (N+1)*L*4 bytes for f32 inputs, at
// one add (and one multiply when weighted) per input element.
//
// Bits (the reference engine's exact IEEE op sequence per element):
//   mode 0, unweighted f32:  acc = x_0; acc = acc + x_i ...; out = acc / N
//   mode 1, weighted f64:    acc = (f64)x_0*w_0; acc = acc + (f64)x_i*w_i ...;
//                            out = (f32)(acc / total); a weight of exactly
//                            1.0 adds (f64)x_i unmultiplied, as the engines do
//   mode 2, weighted f32:    acc = x_0*w_0; acc = acc + x_i*w_i ...;
//                            out = acc / total   (all in f32)
// Every operation is a round-to-nearest intrinsic, so no multiply-add is
// contracted; there is no split over clients and no atomics.
//
// Carry: a node may start from a carried accumulator (f32 in modes 0 and 2,
// f64 in mode 1) instead of its first input, so acc = carry; acc = acc + x_0
// ...; and a node may skip the divide and store the raw accumulator in the
// carry's type. A long fold then runs as one launch per chunk of clients,
// each chunk carrying the previous one's sum and the last dividing: per
// element the same left fold as one launch over every client, and the same
// as numpy's add.accumulate down the client axis.
//
// Two routes, one arithmetic:
//
// 1. The table kernel (fedavg_fold_kernel), for every call of several
//    nodes or of 1-D inputs: the main fold wave of a round. Each thread
//    owns kEpt elements of one node; loads are scalar and coalesced, so
//    inputs need no alignment beyond their type. At VGG-16 width it runs
//    at 86 % of its bytes bound (NVIDIA H100 80GB HBM3, 700 W, PERF.md),
//    so it is left as it was. Its node table, one int64 array in device
//    memory (f64 values bit-cast):
//      meta[n_nodes][7] = {length, out pointer, first client slot, n clients,
//                          mode, carry pointer (0: none), finalize (0: store
//                          the sum)}
//      div[n_nodes]     = divisor (N, or the host's sum of the weights)
//      ptr[n_slots]     = input base pointer of each (node, client) slot
//      w[n_slots]       = weight of each slot (1.0 when unweighted)
//
// 2. The carry route (fedavg_carry_kernel), for one node whose inputs are
//    the rows of one 2-D tensor: the population's value plane, one launch
//    per 512-row chunk of 4,096-element rows. The table kernel gave that
//    call 4 blocks (1,024 elements each) on 132 SMs, a pointer load before
//    every row's data load and a few loads in flight per thread: it read
//    67.7 us against a 2.51 us bytes bound (NVIDIA H100 80GB HBM3, 700 W),
//    about 132 ns a row, a latency limit; and its wrapper built and copied
//    a table every launch. Here
//    every argument is passed by value (base pointer, row stride, rows,
//    length, carry, output, mode, divisor; weights as a device pointer,
//    null when unweighted or all exactly 1.0), so a row's address is
//    base + i * stride and the wrapper makes no host-to-device copy. A block
//    is one warp over kCols = 32 columns (one 128-byte line of f32 a row),
//    so a 4,096-element chunk runs 128 blocks, one an SM. Each block keeps
//    kStages tiles of kRows rows in flight in a shared-memory ring:
//      - filled by TMA (cp.async.bulk.tensor.2d, mbarrier completion)
//        when the base and the row stride are 16-byte aligned; the tensor
//        map's bounds fill the ragged edge with zeros, which no lane uses;
//      - filled by cp.async otherwise, 4-byte words, one row a warp
//        instruction; bf16 rows at an odd 2-byte offset copy the aligned
//        words that hold them (never past the row's last word).
//    Lane j owns column j and adds the ring's rows into its register sum
//    in order 0..n-1, as the table kernel does: the same _rn operations,
//    no split over rows, no atomics. The f64 forms read the same bytes;
//    only the adds widen. Every call the wrapper routes here is taken: a
//    call the kernel cannot take raises, never quietly runs elsewhere.
//
//    What bounds it now: a column's 512 adds are one dependent chain
//    (about 1 us of f32 adds, 2 of f64), which overlaps the 2.51 us of
//    bytes only after the first tile lands; each tile boundary adds a
//    barrier wait and drains the shared-memory loads the unrolled fold
//    keeps ahead. So few, large stages win: tools/kernel_ab.py
//    --kernels fedavg_carry, one 512 x 4,096 chunk, f32 / f64 device us
//    (NVIDIA H100 80GB HBM3, 700 W): kRows x kStages 32 x 8 5.78 / 7.88,
//    64 x 4 4.19 / 6.39, 64 x 8 4.74 / 6.98, 128 x 2 3.42 / 5.72,
//    128 x 4 3.81 / 6.09, 256 x 2 3.36 / 5.58 (torch.sum 8.51; the table
//    kernel 66.4 / 134.5). 128 x 2 is kept: within 2 % of 256 x 2 on a
//    quarter of its shared memory (34 KB a block), so a wider call still
//    fits several blocks an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEpt = 4;  // elements per thread, strided by kThreads
constexpr int kMetaCols = 7;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// One input's term: (f64)x * w, or (f64)x itself when w is exactly 1.0.
__device__ __forceinline__ double term_f64(float x, double w) {
  return w == 1.0 ? (double)x : __dmul_rn((double)x, w);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_fold_kernel(const int64_t* __restrict__ table, int n_nodes,
                   int64_t n_slots) {
  const int node = blockIdx.y;
  const int64_t* meta = table + (int64_t)node * kMetaCols;
  const int64_t len = meta[0];
  const int64_t base = (int64_t)blockIdx.x * (kThreads * kEpt);
  if (base >= len) return;
  void* out = reinterpret_cast<void*>(meta[1]);
  const int64_t slot0 = meta[2];
  const int nc = (int)meta[3];
  const int mode = (int)meta[4];
  const void* carry = reinterpret_cast<const void*>(meta[5]);
  const bool fin = meta[6] != 0;
  const double div = __longlong_as_double(table[(int64_t)n_nodes * kMetaCols + node]);
  const int64_t* ptrs = table + (int64_t)n_nodes * (kMetaCols + 1) + slot0;
  const int64_t* wbits = table + (int64_t)n_nodes * (kMetaCols + 1) + n_slots + slot0;
  // with a carry every input is added to it; without, input 0 starts the sum
  const int first = carry ? 0 : 1;

  int64_t idx[kEpt];
  bool ok[kEpt];
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    idx[k] = base + (int64_t)k * kThreads + threadIdx.x;
    ok[k] = idx[k] < len;
  }

  if (mode == 1) {
    double acc[kEpt];
    if (carry) {
      const double* c = reinterpret_cast<const double*>(carry);
#pragma unroll
      for (int k = 0; k < kEpt; ++k) acc[k] = ok[k] ? c[idx[k]] : 0.0;
    } else {
      const T* x0 = reinterpret_cast<const T*>(ptrs[0]);
      const double w0 = __longlong_as_double(wbits[0]);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        acc[k] = ok[k] ? term_f64(load_f32(x0, idx[k]), w0) : 0.0;
    }
#pragma unroll 4
    for (int i = first; i < nc; ++i) {
      const T* xi = reinterpret_cast<const T*>(ptrs[i]);
      const double wi = __longlong_as_double(wbits[i]);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (ok[k]) acc[k] = __dadd_rn(acc[k], term_f64(load_f32(xi, idx[k]), wi));
    }
    if (fin) {
      float* o = reinterpret_cast<float*>(out);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (ok[k]) o[idx[k]] = __double2float_rn(__ddiv_rn(acc[k], div));
    } else {
      double* o = reinterpret_cast<double*>(out);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (ok[k]) o[idx[k]] = acc[k];
    }
    return;
  }

  // modes 0 and 2 accumulate in f32
  const bool weighted = mode == 2;
  float acc[kEpt];
  if (carry) {
    const float* c = reinterpret_cast<const float*>(carry);
#pragma unroll
    for (int k = 0; k < kEpt; ++k) acc[k] = ok[k] ? c[idx[k]] : 0.0f;
  } else {
    const T* x0 = reinterpret_cast<const T*>(ptrs[0]);
    const float w0 = (float)__longlong_as_double(wbits[0]);
#pragma unroll
    for (int k = 0; k < kEpt; ++k) {
      const float x = ok[k] ? load_f32(x0, idx[k]) : 0.0f;
      acc[k] = weighted ? __fmul_rn(x, w0) : x;
    }
  }
  if (weighted) {
#pragma unroll 4
    for (int i = first; i < nc; ++i) {
      const T* xi = reinterpret_cast<const T*>(ptrs[i]);
      const float wi = (float)__longlong_as_double(wbits[i]);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (ok[k]) acc[k] = __fadd_rn(acc[k], __fmul_rn(load_f32(xi, idx[k]), wi));
    }
  } else {
#pragma unroll 4
    for (int i = first; i < nc; ++i) {
      const T* xi = reinterpret_cast<const T*>(ptrs[i]);
#pragma unroll
      for (int k = 0; k < kEpt; ++k)
        if (ok[k]) acc[k] = __fadd_rn(acc[k], load_f32(xi, idx[k]));
    }
  }
  float* o = reinterpret_cast<float*>(out);
  const float d = (float)div;
#pragma unroll
  for (int k = 0; k < kEpt; ++k)
    if (ok[k]) o[idx[k]] = fin ? __fdiv_rn(acc[k], d) : acc[k];
}


// ---------------------------------------------------------------------------
// The carry route
// ---------------------------------------------------------------------------

constexpr int kCols = 32;    // columns a block: one warp, one column a lane
constexpr int kRows = 128;   // rows a ring stage
constexpr int kStages = 2;   // stages in flight

// The carry route's modes: the table's three, and mode 1 with every weight
// exactly 1.0 (no weights to read, each (f64)x added unmultiplied).
enum { kSumF32 = 0, kWeightedF64 = 1, kWeightedF32 = 2, kSumF64 = 3 };

struct CarryArgs {
  const char* base;       // row 0, column 0
  int64_t stride;         // bytes from one row to the next
  int64_t n_rows;
  int64_t len;            // columns
  const void* carry;      // accumulator to continue from, or null
  void* out;              // f32 mean, or the raw accumulator
  const double* w;        // per-row weights (modes 1 and 2)
  double div;
  int fin;
};

template <typename T, bool kTma>
struct Ring {
  // a TMA box is dense; a cp.async row holds up to one extra word (bf16 at
  // a 2-byte offset)
  static constexpr int kPitch = kCols * (int)sizeof(T) + (kTma ? 0 : 4);
  static constexpr int kStageBytes = kRows * kPitch;
  // dynamic shared memory: the ring, and room to align it to 128 bytes
  static constexpr int kBytes = kStages * kStageBytes + 128;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the barrier's phase of the given parity. A tile that never
// lands (a fault in the copy) traps after about ten seconds instead of
// hanging the card, so the launch fails where it happened.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// Lane 0 of the warp: ask TMA for tile (c0, r0) into dst, completing on bar.
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                        int c0, int r0, uint32_t bar,
                                        uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
         "r"(bar)
      : "memory");
}

// Every lane: copy the words of rows [r0, r0 + rows) of this block's columns
// into dst, one 4-byte word a lane a row. A row's columns [lo, hi) bytes
// start in the word at (row + lo) & ~3, so the window is at most kCols
// words for f32 (always 4-byte aligned) and 17 for bf16.
template <typename T>
__device__ __forceinline__ void cp_async_tile(char* dst, const CarryArgs& a,
                                              int64_t r0, int rows,
                                              int64_t lo, int64_t hi) {
  const int lane = threadIdx.x;
  for (int r = 0; r < rows; ++r) {
    const uintptr_t row = reinterpret_cast<uintptr_t>(a.base) + (r0 + r) * a.stride;
    const uintptr_t word = ((row + lo) & ~uintptr_t(3)) + 4 * lane;
    if (word < row + hi)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_addr(dst + r * Ring<T, false>::kPitch + 4 * lane)),
                      "l"(word)
                   : "memory");
  }
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int kMode>
struct Acc { using T = float; };
template <> struct Acc<kWeightedF64> { using T = double; };
template <> struct Acc<kSumF64> { using T = double; };

// The first input's term, and one step of the fold, per mode.
template <int kMode>
__device__ __forceinline__ typename Acc<kMode>::T first(float x, const double* w) {
  if constexpr (kMode == kSumF32) return x;
  else if constexpr (kMode == kSumF64) return (double)x;
  else if constexpr (kMode == kWeightedF64) return term_f64(x, w[0]);
  else return __fmul_rn(x, (float)w[0]);
}

template <int kMode>
__device__ __forceinline__ typename Acc<kMode>::T add(typename Acc<kMode>::T acc,
                                                      float x, const double* w,
                                                      int64_t i) {
  if constexpr (kMode == kSumF32) return __fadd_rn(acc, x);
  else if constexpr (kMode == kSumF64) return __dadd_rn(acc, (double)x);
  else if constexpr (kMode == kWeightedF64) return __dadd_rn(acc, term_f64(x, w[i]));
  else return __fadd_rn(acc, __fmul_rn(x, (float)w[i]));
}

template <typename T, bool kTma, int kMode>
__global__ void __launch_bounds__(kCols)
fedavg_carry_kernel(const CarryArgs a, __grid_constant__ const CUtensorMap map) {
  using R = Ring<T, kTma>;
  using A = typename Acc<kMode>::T;
  extern __shared__ char ring_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  // TMA writes to 128-byte aligned shared addresses
  char* const ring0 = ring_raw + ((128 - (smem_addr(ring_raw) & 127)) & 127);
  auto ring = [&](int slot) { return ring0 + slot * R::kStageBytes; };

  const int lane = threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.x * kCols;
  const int64_t col = c0 + lane;
  const bool own = col < a.len;
  const int64_t lo = c0 * (int64_t)sizeof(T);
  const int64_t hi = min(c0 + kCols, a.len) * (int64_t)sizeof(T);
  const int64_t n = a.n_rows;
  const int tiles = (int)((n + kRows - 1) / kRows);

  if (kTma) {
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&full[s])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < kStages && s < tiles; ++s)
        tma_tile(smem_addr(ring(s)), &map, (int)c0, s * kRows,
                 smem_addr(&full[s]), R::kStageBytes);
    }
    __syncwarp();
  } else {
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles) {
        const int64_t r0 = (int64_t)s * kRows;
        cp_async_tile<T>(ring(s), a, r0, (int)min((int64_t)kRows, n - r0), lo, hi);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  }

  A acc = 0;
  if (a.carry && own) acc = reinterpret_cast<const A*>(a.carry)[col];
  for (int t = 0; t < tiles; ++t) {
    const int slot = t % kStages;
    const int64_t r0 = (int64_t)t * kRows;
    const int rows = (int)min((int64_t)kRows, n - r0);
    if (kTma) {
      mbar_wait(smem_addr(&full[slot]), (uint32_t)(t / kStages) & 1u);
    } else {
      const int next = t + kStages - 1;
      if (next < tiles) {
        const int64_t nr0 = (int64_t)next * kRows;
        cp_async_tile<T>(ring(next % kStages), a, nr0,
                         (int)min((int64_t)kRows, n - nr0), lo, hi);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
      __syncwarp();
    }
    const char* s = ring(slot);
    // the byte offset of this lane's element in a ring row: a cp.async row
    // starts at the word holding column c0, so a bf16 row at an odd 2-byte
    // offset sits 2 bytes in
    auto elem = [&](int r) -> float {
      int off = lane * (int)sizeof(T);
      if (!kTma && sizeof(T) == 2)
        off += (int)((reinterpret_cast<uintptr_t>(a.base) + (r0 + r) * a.stride + lo) & 3);
      return widen(*reinterpret_cast<const T*>(s + r * R::kPitch + off));
    };
    // without a carry, row 0 starts the sum
    const int r1 = t == 0 && !a.carry;
    if (r1) acc = first<kMode>(elem(0), a.w);
    if (rows == kRows) {
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (k >= r1) acc = add<kMode>(acc, elem(k), a.w, r0 + k);
    } else {
      for (int r = r1; r < rows; ++r) acc = add<kMode>(acc, elem(r), a.w, r0 + r);
    }
    __syncwarp();   // every lane is done with the slot before it refills
    if (kTma && lane == 0 && t + kStages < tiles)
      tma_tile(smem_addr(ring(slot)), &map, (int)c0, (t + kStages) * kRows,
               smem_addr(&full[slot]), R::kStageBytes);
  }
  if (!own) return;
  float* o = reinterpret_cast<float*>(a.out);
  if (!a.fin)
    reinterpret_cast<A*>(a.out)[col] = acc;
  else if constexpr (sizeof(A) == 8)
    o[col] = __double2float_rn(__ddiv_rn(acc, a.div));
  else
    o[col] = __fdiv_rn(acc, (float)a.div);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (no link against libcuda); null where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) != cudaSuccess)
#endif
      return (EncodeTiled) nullptr;
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : (EncodeTiled) nullptr;
  }();
  return fn;
}

template <typename T, bool kTma, int kMode>
int launch_mode(const CarryArgs& a, const CUtensorMap& map, cudaStream_t s) {
  const auto kernel = fedavg_carry_kernel<T, kTma, kMode>;
  constexpr int bytes = Ring<T, kTma>::kBytes;
  // above 48 KB a kernel takes dynamic shared memory only when allowed
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((a.len + kCols - 1) / kCols), kCols, bytes, s>>>(a, map);
  return (int)cudaGetLastError();
}

template <typename T, bool kTma>
int launch_carry(const CarryArgs& a, int mode, const CUtensorMap& map,
                 cudaStream_t s) {
  switch (mode) {
    case kSumF32: return launch_mode<T, kTma, kSumF32>(a, map, s);
    case kWeightedF64: return launch_mode<T, kTma, kWeightedF64>(a, map, s);
    case kWeightedF32: return launch_mode<T, kTma, kWeightedF32>(a, map, s);
    case kSumF64: return launch_mode<T, kTma, kSumF64>(a, map, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table: device pointer to the node table above. max_len: the longest node.
// in_bf16: 1 when every input is bf16, 0 when every input is f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fedavg_fold_launch(const void* table, int n_nodes, int64_t n_slots,
                                  int64_t max_len, int in_bf16, void* stream) {
  if (n_nodes <= 0 || max_len <= 0) return 0;
  const int64_t per_block = (int64_t)kThreads * kEpt;
  const dim3 grid((unsigned)((max_len + per_block - 1) / per_block), (unsigned)n_nodes);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t* t = reinterpret_cast<const int64_t*>(table);
  if (in_bf16)
    fedavg_fold_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(t, n_nodes, n_slots);
  else
    fedavg_fold_kernel<float><<<grid, kThreads, 0, s>>>(t, n_nodes, n_slots);
  return (int)cudaGetLastError();
}

// The carry route: one node over the n_rows rows of a 2-D tensor (row i at
// base + i * stride bytes, columns contiguous), f32 (in_bf16 = 0) or bf16.
// mode: 0 unweighted f32, 1 weighted f64, 2 weighted f32, 3 f64 with every
// weight exactly 1.0; weights: n_rows f64 in device memory (modes 1 and 2,
// null otherwise). carry: the accumulator to continue (f64 in modes 1 and
// 3, f32 otherwise), or null to start from row 0. out: the f32 mean
// (finalize = 1, dividing by divisor) or the raw accumulator in the carry's
// type. tma = 1 fills the ring with TMA and needs base and stride 16-byte
// aligned; tma = 0 fills it with cp.async. Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" int fedavg_carry_launch(const void* base, int64_t stride, int64_t n_rows,
                                   int64_t len, int in_bf16, int tma,
                                   const void* carry, void* out, int mode,
                                   double divisor, int finalize,
                                   const void* weights, void* stream) {
  if (len <= 0) return 0;
  if (n_rows <= 0 || n_rows > INT32_MAX || len > INT32_MAX || stride < 0 ||
      mode < 0 || mode > 3 || ((mode == 1 || mode == 2) && !weights))
    return (int)cudaErrorInvalidValue;
  const CarryArgs a{static_cast<const char*>(base), stride, n_rows, len, carry, out,
                    static_cast<const double*>(weights), divisor, finalize};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  CUtensorMap map{};
  if (!tma)
    return in_bf16 ? launch_carry<__nv_bfloat16, false>(a, mode, map, s)
                   : launch_carry<float, false>(a, mode, map, s);
  if (reinterpret_cast<uintptr_t>(base) % 16 || stride % 16 || stride == 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)len, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {kCols, kRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, in_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return in_bf16 ? launch_carry<__nv_bfloat16, true>(a, mode, map, s)
                 : launch_carry<float, true>(a, mode, map, s);
}
