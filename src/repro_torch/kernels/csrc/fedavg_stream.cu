// Streaming FedAvg fold for Hopper (sm_90a): many averaging nodes, one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_stream.py
// (fedavg_stream: _fedavg_kernel + _finalize_kernel). There the grid walks
// (row block, client) with the client axis innermost and carries the sum in
// VMEM across grid steps, then a second pass divides. Here each thread owns
// EPT elements of one node and walks the node's clients 0..N-1 in order,
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
// contracted; there is no split over clients and no atomics. Loads are
// scalar and coalesced, so inputs need no alignment beyond their type.
//
// Carry: a node may start from a carried accumulator (f32 in modes 0 and 2,
// f64 in mode 1) instead of its first input, so acc = carry; acc = acc + x_0
// ...; and a node may skip the divide and store the raw accumulator in the
// carry's type. A long fold then runs as one launch per chunk of clients,
// each chunk carrying the previous one's sum and the last dividing: per
// element the same left fold as one launch over every client, and the same
// as numpy's add.accumulate down the client axis.
//
// The node table, one int64 array in device memory (f64 values bit-cast):
//   meta[n_nodes][7] = {length, out pointer, first client slot, n clients, mode,
//                       carry pointer (0: none), finalize (0: store the sum)}
//   div[n_nodes]     = divisor (N, or the host's sum of the weights)
//   ptr[n_slots]     = input base pointer of each (node, client) slot
//   w[n_slots]       = weight of each slot (1.0 when unweighted)

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
