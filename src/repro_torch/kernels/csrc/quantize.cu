// Per-tile symmetric int8 quantization (QSGD, deterministic) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py (quantize:
// _quant_kernel; dequantize: _dequant_kernel). There one grid step holds a
// (32, 128) f32 tile in VMEM: amax, scale = amax / 127 (1 when amax is 0),
// codes = clip(round(x / scale), -127, 127) as int8, one f32 scale per tile;
// the inverse multiplies each code by its tile's scale.
//
// Here the data stays flat: a tile is 4096 consecutive elements of the 1-D
// input, the last one ragged. The wrapper hands the raw vector, codes and
// scales in the layout of the reference's wire payload, so nothing is padded
// or copied in device memory.
//
// Bound: device-memory bytes. Quantize reads 4 bytes and writes 1 per
// element (plus 4 per tile); dequantize reads 1 (plus the scale, cached) and
// writes 4. A few operations per element are far below the card's rate.
//
// quantize: one block per tile, 256 threads x 16 elements each, held in
// registers; element k of thread t is tile[k * 256 + t], so every load and
// store of a warp is one contiguous run. Elements past the end of the input
// load as 0 (they cannot raise amax) and are not stored. amax is a max, so
// the order of the block reduction does not change it.
//
// Non-finite tiles follow the reference (np.max and jnp.max propagate NaN):
// amax is the largest bit pattern of |x| taken as an unsigned integer, which
// orders every finite value and inf as floats do and puts every NaN above
// inf, so a tile that holds a NaN has a NaN amax, fails `amax > 0` and takes
// scale 1.0. A NaN quotient (a NaN element, or inf / inf in a tile whose
// amax is inf) codes to 0, as the mirror's cast does; +-inf clip to +-127.
//
// Bits: every operation is a round-to-nearest intrinsic (__fdiv_rn; rintf
// rounds half to even like jnp.round and np.rint), so the codes and scales
// equal the reference's numpy mirror and Pallas kernel bit for bit. Loads
// and stores are scalar: inputs need no alignment beyond their type.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;     // 32 rows x 128 lanes, the reference's tile
constexpr int kThreads = 256;
constexpr int kEpt = kTile / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr float kQmax = 127.0f;

constexpr int kDqThreads = 256;
constexpr int kDqEpt = 4;       // dequantize elements per thread, strided

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int64_t n, int8_t* __restrict__ codes,
                float* __restrict__ scales) {
  __shared__ unsigned warp_max[kWarps];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int t = threadIdx.x;

  float v[kEpt];
  unsigned abits = 0;              // max of |x|'s bit patterns; NaN > inf
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int64_t i = base + k * kThreads + t;
    v[k] = i < n ? x[i] : 0.0f;
    abits = max(abits, __float_as_uint(v[k]) & 0x7fffffffu);
  }
  abits = __reduce_max_sync(0xffffffffu, abits);
  if ((t & 31) == 0) warp_max[t >> 5] = abits;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) abits = max(abits, warp_max[w]);
  const float amax = __uint_as_float(abits);

  const float scale = amax > 0.0f ? __fdiv_rn(amax, kQmax) : 1.0f;
  if (t == 0) scales[blockIdx.x] = scale;
#pragma unroll
  for (int k = 0; k < kEpt; ++k) {
    const int64_t i = base + k * kThreads + t;
    if (i < n) {
      const float r = rintf(__fdiv_rn(v[k], scale));
      const float q = r != r ? 0.0f : fminf(fmaxf(r, -kQmax), kQmax);
      codes[i] = (int8_t)(int)q;
    }
  }
}

__global__ void __launch_bounds__(kDqThreads)
dequantize_kernel(const int8_t* __restrict__ codes, const float* __restrict__ scales,
                  int64_t start, int64_t n_out, float* __restrict__ out) {
  const int64_t base = (int64_t)blockIdx.x * (kDqThreads * kDqEpt);
#pragma unroll
  for (int k = 0; k < kDqEpt; ++k) {
    const int64_t j = base + k * kDqThreads + threadIdx.x;
    if (j < n_out) {
      const int64_t i = start + j;
      out[j] = __fmul_rn((float)codes[i], scales[i / kTile]);
    }
  }
}

}  // namespace

// x: n f32 elements; codes: n int8; scales: ceil(n / 4096) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qsgd_quantize_launch(const void* x, int64_t n, void* codes, void* scales,
                                    void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  quantize_kernel<<<(unsigned)tiles, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float*>(x), n, reinterpret_cast<int8_t*>(codes),
      reinterpret_cast<float*>(scales));
  return (int)cudaGetLastError();
}

// codes/scales: the whole payload; writes out[j] = codes[start + j] *
// scales[(start + j) / 4096] for j in [0, n_out). Returns cudaGetLastError().
extern "C" int qsgd_dequantize_launch(const void* codes, const void* scales, int64_t start,
                                      int64_t n_out, void* out, void* stream) {
  if (n_out <= 0) return 0;
  const int64_t per_block = (int64_t)kDqThreads * kDqEpt;
  dequantize_kernel<<<(unsigned)((n_out + per_block - 1) / per_block), kDqThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int8_t*>(codes), reinterpret_cast<const float*>(scales), start,
      n_out, reinterpret_cast<float*>(out));
  return (int)cudaGetLastError();
}
