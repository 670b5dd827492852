// Causal self-attention, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes attention with jnp
// einsums (src/repro/models/layers.py: attention_dense), which the port
// ran as f32 einsums over f32 copies of q, k and v. A traced training
// round of GPT-2 Large (36 layers, 20 heads of 64, S = 1,024) put about
// half of the card's time in that path: two f32 GEMMs a product on the
// FFMA units, and the (B, H, S, S) f32 scores written and read by some ten
// elementwise and softmax kernels in each direction. This source computes
// the same function at the same rounding points with bf16 tensor-core
// products and nothing of size S x S in device memory.
//
// Arithmetic (models/layers.py: attention_dense, and its autograd graph):
//   s = (q . k) * scale in f32 (bf16 products are exact in f32, so the
//       tensor core's bf16 MMA with f32 accumulation forms the f32
//       einsum's products); keys after the query are masked (p = 0);
//   p = exp(s - m) / l, m the row max, l = sum exp(s - m), in f32;
//   o = bf16( sum_j bf16(p_j) v_j ), summed in f32;
//   dp = bf16( do . v ) in f32, rounded (the backward of .to(v.dtype));
//   ds = p * (dp - sum_j p_j dp_j) * scale in f32;
//   dq = bf16( ds k ), dk = bf16( ds^T q ), dv = bf16( bf16(p)^T do ).
// ds enters its products at f32 precision: split into hi = bf16(ds) and
// lo = bf16(ds - hi), two MMAs, so 16 of its 24 significand bits take part
// against the one bf16 rounding of dq and dk. Only the order of summation
// differs from the einsums, and the divide by l, which takes 1/l once a
// row (div_by: one ulp off the IEEE quotient in 3 of 10,000 cases). The
// forward saves each row's m and l (not their log-sum-exp), so that the
// backward recomputes p to the bit.
//
// Bound: tensor-core operations. At GPT-2 Large's (4, 1024, 20, 64) a
// layer's forward is 5.4 GFLOP of causal products (QK^T and PV), 5.5 us at
// 989 TFLOP/s; the bytes (q, k, v, o and two f32 a row) are 42 MB, 12.5 us
// at 3.35 TB/s, so the forward alone would be bytes-bound if it did no more
// than the products; the backward reads q, k, v, do and writes dq, dk, dv.
// The design recomputes rather than stores: the forward runs QK^T twice
// (one sweep for the row max and sum, one for p and PV: no rescaling of o),
// the backward's dq kernel sweeps twice (the row term, then dq), and its
// dk/dv kernel once; 14 causal-half products a layer in all.
//
// Design: mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from
// shared memory, tiles streamed from device memory by cp.async into two
// buffers (one in use, one loading), 16-byte chunks XOR-swizzled by row so
// that ldmatrix reads are free of bank conflicts. Four warps a block, 16
// rows each. Tiles wholly above the diagonal are never loaded. No atomics:
// every output element is written by one thread of one block, so a result
// is the same bits on every run.
//   * forward: a block takes 64 query rows of one (batch, head); key tiles
//     of 64; sweep 1 keeps the running max and sum (rescaled per tile),
//     sweep 2 forms p, rounds it to bf16 in registers (the accumulator's
//     layout is the next MMA's A layout) and accumulates PV.
//   * dq kernel: a block takes 64 query rows; sweep 1 forms the row term
//     sum_j p_j dp_j (written for the dk/dv kernel), sweep 2 ds and dq.
//   * dk/dv kernel: a block takes 64 keys of one (batch, kv head) and walks
//     the query tiles at and after its diagonal, for each q head that reads
//     that kv head (grouped-query attention sums them in f32 before the one
//     rounding); s^T = K Q^T so that p^T and ds^T are A operands in place.
// Head dim 64 or 128 (template). The backward streams tiles of 32 rows,
// and at head dim 64 every kernel is held to 168 registers a thread (three
// blocks an SM, against two at the ~240 registers 64-row tiles take): on
// the card that cut the backward's time at GPT-2 Large's shape by 10 %.
//
// Layout: q, do, o and dq (B, S, H, D), k, v, dk and dv (B, S, KH, D),
// bf16, contiguous and 16-byte aligned; m and l
// (B, H, S) f32, and a (2, B, H, S) f32 scratch for the row term and 1/l. Any S >= 1: a ragged last tile is zero-filled
// on load and masked; H a multiple of KH, q head h reads kv head h / (H/KH).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;   // four warps
constexpr int kRows = 64;       // query rows of a forward or dq block, keys of a dk/dv block
constexpr int kBwdTile = 32;    // key tiles of the dq kernel, query tiles of the dk/dv kernel
// blocks an SM each kernel is compiled for: at most 168 registers at head dim 64
template <int D> constexpr int kMinBlocks = D == 64 ? 3 : 1;

struct Params {
  const bf16* q; const bf16* k; const bf16* v; const bf16* dout;
  bf16* o; bf16* dq; bf16* dk; bf16* dv;
  float* m; float* l; float* drow; float* rl;   // rl: 1/l, the dq kernel's for the dk/dv kernel
  int S, H, KH, G;
  long long qsb, qss, qsh, ksb, kss, ksh;   // (batch, seq, head) strides: q and do, k and v
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a b, a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// e / l from r = 1/l (correctly rounded, once a row): e*r with one FMA
// correction of its residual. The IEEE quotient but for one ulp in about 3
// of 10,000 normal draws (2^33 draws of e in (0, 1] and l in [1, 4096) on
// the card), below the ulps by which the row sum's own order of summation
// moves every p; without the IEEE divide's range check and slow-path call,
// a third of the kernels' time at GPT-2 Large's shape.
__device__ __forceinline__ float div_by(float e, float l, float r) {
  const float q = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q, l, e), r, q);
}

// element offset of 16-byte chunk c of row r in a (rows, D) bf16 tile
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows [row0, row0 + ROWS) of a (S, D) matrix with row stride rs, into a
// swizzled tile; rows at or past S are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* base, long long rs, int row0,
                                          int S) {
  constexpr int CH = D / 8;
  static_assert((ROWS * CH) % kThreads == 0, "tile chunks a thread");
#pragma unroll
  for (int n = 0; n < ROWS * CH / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads;
    const int r = i / CH, c = i % CH;
    const int gr = row0 + r;
    const bool ok = gr < S;
    const bf16* src = base + (ok ? gr : 0) * rs + c * 8;
    cp_async16(smem_u32(tile + swz<D>(r, c)), src, ok ? 16 : 0);
  }
}

// the A fragments of a warp's 16 rows of a tile (rows r_base...), all of D
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* tile, int r_base,
                                       int lane) {
  const int r = r_base + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm_x4(smem_u32(tile + swz<D>(r, kc * 2 + (lane >> 4))), a[kc][0], a[kc][1], a[kc][2],
            a[kc][3]);
}

// acc (16 x N) = A (16 x D, fragments) . tile^T, the tile (N, D) rows as columns
template <int D, int N>
__device__ __forceinline__ void product_nt(float (&acc)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(tile + swz<D>(r, kc * 2 + ((lane >> 3) & 1))), b0, b1, b2, b3);
      mma(acc[2 * np], a[kc], b0, b1);
      mma(acc[2 * np + 1], a[kc], b2, b3);
    }
  }
}

// the same with A read from shared memory for each product (the dk/dv
// kernel's resident K and V tiles)
template <int D, int N>
__device__ __forceinline__ void product_nt_s(float (&acc)[N / 8][4], const bf16* a_tile, int r_base,
                                             const bf16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int ra = r_base + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(smem_u32(a_tile + swz<D>(ra, kc * 2 + (lane >> 4))), a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      uint32_t b0, b1, b2, b3;
      ldsm_x4(smem_u32(tile + swz<D>(r, kc * 2 + ((lane >> 3) & 1))), b0, b1, b2, b3);
      mma(acc[2 * np], a, b0, b1);
      mma(acc[2 * np + 1], a, b2, b3);
    }
  }
}

// acc (16 x D) += A (16 x 16, fragment over tile rows kc*16...) . tile rows
// kc*16.. kc*16+15 (the tile (K, D), its rows the reduction)
template <int D>
__device__ __forceinline__ void product_nn(float (&acc)[D / 8][4], const uint32_t* a,
                                           const bf16* tile, int kc, int lane) {
  const int r = kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_t(smem_u32(tile + swz<D>(r, np * 2 + (lane >> 4))), b0, b1, b2, b3);
    mma(acc[2 * np], a, b0, b1);
    mma(acc[2 * np + 1], a, b2, b3);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// scale the scores and mask keys after the query (row i, column j): the
// accumulator element e of n-tile n lies at row r_lo + (e >> 1) * 8 and
// column c_lo + n * 8 + (e & 1)
template <int N>
__device__ __forceinline__ void scale_mask(float (&s)[N / 8][4], float scale, int r_lo, int c_lo,
                                           bool mask) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = s[n][e] * scale;
      if (mask && c_lo + n * 8 + (e & 1) > r_lo + (e >> 1) * 8) s[n][e] = -INFINITY;
    }
}

// ---------------------------------------------------------------------------
// Forward: o, m, l
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) causal_attention_fwd_kernel(const Params p) {
  constexpr int T = 64;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * D;
  bf16* sV = sK + 2 * T * D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;     // the longest rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int S = p.S, r0 = qb * kRows;
  const bf16* qg = p.q + b * p.qsb + h * p.qsh;
  const bf16* kg = p.k + b * p.ksb + kvh * p.ksh;
  const bf16* vg = p.v + b * p.ksb + kvh * p.ksh;
  const int nt = min((r0 + kRows + T - 1) / T, (S + T - 1) / T);
  const int n_it = 2 * nt;                       // sweep 1, then sweep 2
  const int row = r0 + warp * 16 + g;            // this thread's rows: row, row + 8

  load_rows<D, kRows>(sQ, qg, p.qss, r0, S);
  load_rows<D, T>(sK, kg, p.kss, 0, S);
  cp_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, r_r[2];

  for (int it = 0; it < n_it; ++it) {
    const int nx = it + 1;
    if (nx < n_it) {
      const int tn = nx < nt ? nx : nx - nt;
      load_rows<D, T>(sK + (nx & 1) * T * D, kg, p.kss, tn * T, S);
      if (nx >= nt) load_rows<D, T>(sV + (nx & 1) * T * D, vg, p.kss, tn * T, S);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (it == 0) load_a<D>(qf, sQ, warp * 16, lane);
    const int t = it < nt ? it : it - nt;
    float s[T / 8][4];
    product_nt<D, T>(s, qf, sK + (it & 1) * T * D, lane);
    scale_mask<T>(s, p.scale, row, t * T + 2 * tq, t * T + T - 1 > r0);
    if (it < nt) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_r[r];
#pragma unroll
        for (int n = 0; n < T / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = quad_max(mx);
        const float alpha = expf(m_r[r] - mx);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < T / 8; ++n) {
          sum += expf(s[n][2 * r] - mx);
          sum += expf(s[n][2 * r + 1] - mx);
        }
        l_r[r] = l_r[r] * alpha + sum;
        m_r[r] = mx;
      }
      if (it == nt - 1) {
        l_r[0] = quad_sum(l_r[0]);
        l_r[1] = quad_sum(l_r[1]);
        r_r[0] = __frcp_rn(l_r[0]);
        r_r[1] = __frcp_rn(l_r[1]);
      }
    } else {
      const bf16* vt = sV + (it & 1) * T * D;
#pragma unroll
      for (int kc = 0; kc < T / 16; ++kc) {
        uint32_t a[4];
        float pr[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pr[j][e] = div_by(expf(s[2 * kc + j][e] - m_r[e >> 1]), l_r[e >> 1], r_r[e >> 1]);
        a[0] = pack(pr[0][0], pr[0][1]);
        a[1] = pack(pr[0][2], pr[0][3]);
        a[2] = pack(pr[1][0], pr[1][1]);
        a[3] = pack(pr[1][2], pr[1][3]);
        product_nn<D>(o, a, vt, kc, lane);
      }
    }
    __syncthreads();
  }

  const long long ostride = (long long)p.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + r * 8;
    if (i >= S) continue;
    bf16* og = p.o + ((long long)b * S + i) * ostride + (long long)h * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(og + n * 8) = pack(o[n][2 * r], o[n][2 * r + 1]);
    if (tq == 0) {
      p.m[(long long)bh * S + i] = m_r[r];
      p.l[(long long)bh * S + i] = l_r[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq kernel: the row term and dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) causal_attention_dq_kernel(const Params p) {
  constexpr int T = kBwdTile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kRows * D;                     // do
  bf16* sK = sO + kRows * D;
  bf16* sV = sK + 2 * T * D;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int S = p.S, r0 = qb * kRows;
  const bf16* kg = p.k + b * p.ksb + kvh * p.ksh;
  const bf16* vg = p.v + b * p.ksb + kvh * p.ksh;
  const int nt = min((r0 + kRows + T - 1) / T, (S + T - 1) / T);
  const int n_it = 2 * nt;
  const int row = r0 + warp * 16 + g;

  load_rows<D, kRows>(sQ, p.q + b * p.qsb + h * p.qsh, p.qss, r0, S);
  load_rows<D, kRows>(sO, p.dout + b * p.qsb + h * p.qsh, p.qss, r0, S);
  load_rows<D, T>(sK, kg, p.kss, 0, S);
  load_rows<D, T>(sV, vg, p.kss, 0, S);
  cp_commit();

  float m_r[2], l_r[2], r_r[2], d_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + r * 8;
    m_r[r] = i < S ? p.m[(long long)bh * S + i] : 0.f;
    l_r[r] = i < S ? p.l[(long long)bh * S + i] : 1.f;
    r_r[r] = __frcp_rn(l_r[r]);
  }
  uint32_t qf[D / 16][4], of[D / 16][4];
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int nx = it + 1;
    if (nx < n_it) {
      const int tn = nx < nt ? nx : nx - nt;
      load_rows<D, T>(sK + (nx & 1) * T * D, kg, p.kss, tn * T, S);
      load_rows<D, T>(sV + (nx & 1) * T * D, vg, p.kss, tn * T, S);
    }
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (it == 0) {
      load_a<D>(qf, sQ, warp * 16, lane);
      load_a<D>(of, sO, warp * 16, lane);
    }
    const int t = it < nt ? it : it - nt;
    const bf16* kt = sK + (it & 1) * T * D;
    float s[T / 8][4], dp[T / 8][4];
    product_nt<D, T>(s, qf, kt, lane);
    product_nt<D, T>(dp, of, sV + (it & 1) * T * D, lane);
    scale_mask<T>(s, p.scale, row, t * T + 2 * tq, t * T + T - 1 > r0);
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = div_by(expf(s[n][e] - m_r[e >> 1]), l_r[e >> 1], r_r[e >> 1]);     // p
        dp[n][e] = round_bf16(dp[n][e]);
      }
    if (it < nt) {
#pragma unroll
      for (int n = 0; n < T / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) d_r[e >> 1] += s[n][e] * dp[n][e];
      if (it == nt - 1) {
        d_r[0] = quad_sum(d_r[0]);
        d_r[1] = quad_sum(d_r[1]);
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < T / 16; ++kc) {
        float ds[2][4], lo[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 2 * kc + j;
            ds[j][e] = s[n][e] * (dp[n][e] - d_r[e >> 1]) * p.scale;
            lo[j][e] = ds[j][e] - round_bf16(ds[j][e]);
          }
        uint32_t a[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                         pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
        product_nn<D>(dq, a, kt, kc, lane);
        uint32_t b[4] = {pack(lo[0][0], lo[0][1]), pack(lo[0][2], lo[0][3]),
                         pack(lo[1][0], lo[1][1]), pack(lo[1][2], lo[1][3])};
        product_nn<D>(dq, b, kt, kc, lane);
      }
    }
    __syncthreads();
  }

  const long long ostride = (long long)p.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + r * 8;
    if (i >= S) continue;
    bf16* dg = p.dq + ((long long)b * S + i) * ostride + (long long)h * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dg + n * 8) = pack(dq[n][2 * r], dq[n][2 * r + 1]);
    if (tq == 0) {
      p.drow[(long long)bh * S + i] = d_r[r];
      p.rl[(long long)bh * S + i] = r_r[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dk/dv kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>) causal_attention_dkdv_kernel(const Params p) {
  constexpr int T = kBwdTile;    // queries a tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * D;
  bf16* sQ = sV + kRows * D;                     // two buffers each
  bf16* sO = sQ + 2 * T * D;
  float* sStat = reinterpret_cast<float*>(sO + 2 * T * D);   // [2][4][T]: m, l, 1/l, row term

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int kb = blockIdx.x;                     // the most query tiles first
  const int bk = blockIdx.y, b = bk / p.KH, kvh = bk % p.KH;
  const int S = p.S, k0 = kb * kRows;
  const int u0 = k0 / T, nu = (S + T - 1) / T, per = nu - u0;
  const int n_it = p.G * per;
  const int key = k0 + warp * 16 + g;            // this thread's keys: key, key + 8

  auto load_tile = [&](int it, int buf) {
    const int h = kvh * p.G + it / per, u = u0 + it % per;
    load_rows<D, T>(sQ + buf * T * D, p.q + b * p.qsb + h * p.qsh, p.qss, u * T, S);
    load_rows<D, T>(sO + buf * T * D, p.dout + b * p.qsb + h * p.qsh, p.qss, u * T, S);
    const long long base = ((long long)b * p.H + h) * S;
    for (int i = threadIdx.x; i < 4 * T; i += kThreads) {
      const int which = i / T, c = i % T, qi = u * T + c;
      const float* src = which == 0 ? p.m : which == 1 ? p.l : which == 2 ? p.rl : p.drow;
      const bool ok = qi < S;
      cp_async4(smem_u32(sStat + (buf * 4 + which) * T + c), src + base + (ok ? qi : 0),
                ok ? 4 : 0);
    }
  };

  load_rows<D, kRows>(sK, p.k + b * p.ksb + kvh * p.ksh, p.kss, k0, S);
  load_rows<D, kRows>(sV, p.v + b * p.ksb + kvh * p.ksh, p.kss, k0, S);
  if (n_it > 0) load_tile(0, 0);
  cp_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_tile(it + 1, (it + 1) & 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int buf = it & 1, u = u0 + it % per;
    const bf16* qt = sQ + buf * T * D;
    const bf16* ot = sO + buf * T * D;
    const float* st = sStat + buf * 4 * T;
    float s[T / 8][4], dp[T / 8][4];
    product_nt_s<D, T>(s, sK, warp * 16, qt, lane);    // s^T: keys x queries
    product_nt_s<D, T>(dp, sV, warp * 16, ot, lane);   // dp^T
    const bool edge = u * T < k0 + kRows - 1 || u * T + T > S;
#pragma unroll
    for (int n = 0; n < T / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * tq + (e & 1), qi = u * T + c;
        const int j = key + (e >> 1) * 8;
        float pv = div_by(expf(s[n][e] * p.scale - st[c]), st[T + c], st[2 * T + c]);
        if (edge && (j > qi || qi >= S)) pv = 0.f;
        const float dpb = round_bf16(dp[n][e]);
        s[n][e] = pv;
        dp[n][e] = pv * (dpb - st[3 * T + c]) * p.scale;       // ds^T
      }
#pragma unroll
    for (int kc = 0; kc < T / 16; ++kc) {
      const int n0 = 2 * kc, n1 = 2 * kc + 1;
      uint32_t a[4] = {pack(s[n0][0], s[n0][1]), pack(s[n0][2], s[n0][3]),
                       pack(s[n1][0], s[n1][1]), pack(s[n1][2], s[n1][3])};
      product_nn<D>(dv, a, ot, kc, lane);
      float lo[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) lo[j][e] = dp[n0 + j][e] - round_bf16(dp[n0 + j][e]);
      uint32_t hi[4] = {pack(dp[n0][0], dp[n0][1]), pack(dp[n0][2], dp[n0][3]),
                        pack(dp[n1][0], dp[n1][1]), pack(dp[n1][2], dp[n1][3])};
      product_nn<D>(dk, hi, qt, kc, lane);
      uint32_t lw[4] = {pack(lo[0][0], lo[0][1]), pack(lo[0][2], lo[0][3]),
                        pack(lo[1][0], lo[1][1]), pack(lo[1][2], lo[1][3])};
      product_nn<D>(dk, lw, qt, kc, lane);
    }
    __syncthreads();
  }

  const long long kstride = (long long)p.KH * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key + r * 8;
    if (j >= S) continue;
    const long long off = ((long long)b * S + j) * kstride + (long long)kvh * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(p.dk + off + n * 8) = pack(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + n * 8) = pack(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int D> constexpr int fwd_smem() { return (kRows * D + 4 * 64 * D) * 2; }
template <int D> constexpr int dq_smem() { return (2 * kRows * D + 4 * kBwdTile * D) * 2; }
template <int D> constexpr int dkdv_smem() {
  return (2 * kRows * D + 4 * kBwdTile * D) * 2 + 2 * 4 * kBwdTile * 4;
}

template <typename K>
cudaError_t launch(K kernel, int smem, dim3 grid, const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, int S, int H, int KH, int D,
                   float scale) {
  Params p = {};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.S = S; p.H = H; p.KH = KH; p.G = H / KH;
  p.qsh = p.ksh = D;
  p.qss = (long long)H * D; p.qsb = p.qss * S;
  p.kss = (long long)KH * D; p.ksb = p.kss * S;
  p.scale = scale;
  return p;
}

}  // namespace

// q, o: (B, S, H, D) bf16; k, v: (B, S, KH, D) bf16; m, l: (B, H, S) f32;
// all contiguous. One launch.
extern "C" int causal_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                           void* m, void* l, int B, int S, int H, int KH, int D,
                                           float scale, void* stream) {
  Params p = make_params(q, k, v, S, H, KH, D, scale);
  p.o = static_cast<bf16*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch(causal_attention_fwd_kernel<64>, fwd_smem<64>(), grid, p, st);
  if (D == 128) return launch(causal_attention_fwd_kernel<128>, fwd_smem<128>(), grid, p, st);
  return cudaErrorInvalidValue;
}

// the backward: do and dq (B, S, H, D) bf16, dk and dv (B, S, KH, D) bf16,
// all contiguous; m, l from the forward; drow: (2, B, H, S) f32 scratch for
// the row term and 1/l. Two launches on one stream: the dq kernel (which
// writes drow), then the dk/dv kernel.
extern "C" int causal_attention_bwd_launch(const void* q, const void* k, const void* v,
                                           const void* dout, const void* m, const void* l,
                                           void* drow, void* dq, void* dk, void* dv, int B, int S,
                                           int H, int KH, int D, float scale, void* stream) {
  Params p = make_params(q, k, v, S, H, KH, D, scale);
  p.dout = static_cast<const bf16*>(dout);
  p.m = static_cast<float*>(const_cast<void*>(m));
  p.l = static_cast<float*>(const_cast<void*>(l));
  p.drow = static_cast<float*>(drow);
  p.rl = p.drow + (long long)B * H * S;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  const dim3 gq((S + kRows - 1) / kRows, B * H), gk((S + kRows - 1) / kRows, B * KH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch(causal_attention_dq_kernel<64>, dq_smem<64>(), gq, p, st);
    if (err != cudaSuccess) return err;
    return launch(causal_attention_dkdv_kernel<64>, dkdv_smem<64>(), gk, p, st);
  }
  if (D == 128) {
    err = launch(causal_attention_dq_kernel<128>, dq_smem<128>(), gq, p, st);
    if (err != cudaSuccess) return err;
    return launch(causal_attention_dkdv_kernel<128>, dkdv_smem<128>(), gk, p, st);
  }
  return cudaErrorInvalidValue;
}
