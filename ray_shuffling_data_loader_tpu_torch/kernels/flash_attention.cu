// Flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Layout (B, H, S, D), bf16 q/k/v/dO, contiguous; an optional f32 key-side
// bias (B, 1, 1, Sk) (a null pointer is the Pallas `_nobias` variant);
// f32 lse and delta (B, H, Sq). scale = 1/sqrt(D).
//
// Replaces the three Pallas TPU kernels of
// ray_shuffling_data_loader_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd_kernel` :80 / `_fwd_kernel_nobias` :116
//                        (called from `_flash_forward` :305)
//   flash_dq_kernel   <- `_dq_kernel` :122 / `_dq_kernel_nobias` :149
//                        (called from `flash_backward` :410)
//   flash_dkv_kernel  <- `_dkv_kernel` :155 / `_dkv_kernel_nobias` :193
//                        (called from `flash_backward` :448)
//
// On the TPU the innermost grid axis runs in order and carries the online
// softmax / gradient accumulators in VMEM scratch. Here one block of 4 warps
// owns one 64-row tile (a q-tile for forward and dq, a k-tile for dk/dv) and
// loops over the other sequence's 64-row tiles itself; each warp owns 16 rows
// of the block's tile for the whole kernel, so after a tile is staged in
// shared memory a warp needs only __syncwarp() to hand its strip from the
// tensor cores to the row-wise f32 softmax and back. dk/dv blocks own their
// key rows, so dk, dv and the per-head dbias are written without atomics.
//
// What bounds it on an H100: at BERT's S=512, D=64 the work is about 26-52
// GFLOP against 100-150 MB per call, so the dense bf16 tensor-core rate
// (989 TFLOP/s) and the HBM rate (3.35 TB/s) give bounds of the same order
// (~30-52 us); the scores never reach device memory. This version runs
// `nvcuda::wmma` 16x16x16 bf16 fragments with f32 accumulation (mma.sync
// underneath, not wgmma) and is limited by shared-memory traffic and the
// work between the products, not by either bound. What it does about that:
// the row work (max, exp, sums, the bf16 cast of P or dS) is spread over
// all 32 lanes, two per row, with 8-byte accesses and one shuffle per
// reduction; shared-memory rows are padded so that a fragment's rows fall
// on different banks; in the backward kernels the bf16 P and dS overwrite
// the f32 strips they come from, so each block needs ~72 KB at D=64 and
// three blocks fit an SM; the forward skips rescaling its accumulator when
// no row's max moved. What it leaves for later work: the forward's output
// accumulator lives in shared memory so that it can be rescaled row by row
// (wmma fragments have no documented element-to-row map), every warp
// re-reads the whole k/v tile, and tiles are staged with synchronous
// 16-byte loads; wgmma, TMA, double buffering and warp specialisation are
// the next steps.
//
// Numerics: the scores and every product accumulate in f32. P (forward, dk/dv)
// and dS (dq, dk/dv) are rounded to bf16 to feed the tensor cores; the row
// sums, lse and dbias use the unrounded f32 values; exp(x) is exp2f(x log2 e).
// The scale multiplies the f32 scores (the Pallas forward scales q before
// the dot: equal up to f32 rounding). Ragged edges: keys at k >= Sk get a
// -inf score and query rows at q >= Sq a +inf lse, so their probabilities are
// exactly 0, and their rows are not written; this equals the unpadded
// computation (and JAX's padding with a -1e9 bias wherever a row has a real
// key within 1e9 of its maximum). The running max starts at -1e30 and the
// denominator is clamped at 1e-30, as in the Pallas forward.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // rows of a q-tile and of a k-tile
constexpr int kWarps = 4;            // each warp owns kStrip rows of a tile
constexpr int kThreads = kWarps * 32;
constexpr int kStrip = 16;           // = the wmma fragment's M
constexpr float kNegInit = -1e30f;   // running-max init (Pallas `_NEG`)
// Shared-memory row strides, padded so that consecutive rows start 4 banks
// apart (a stride of 128 or 256 bytes would put every row of a fragment
// load on the same banks).
constexpr int kLdS = kTile + 4;      // f32 score tiles (68 floats)
constexpr int kLdH = 2 * kLdS;       // a score row read as bf16 (136)
constexpr int kLdP = kTile + 8;      // bf16 P tile of the forward (72)
template <int D>
__host__ __device__ constexpr int ld_tile() { return D + 8; }  // bf16 q/k/v
template <int D>
__host__ __device__ constexpr int ld_acc() { return D + 4; }   // f32 acc

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr float kLog2e = 1.4426950408889634f;

// Row work: lane l of a warp handles row (l & 15) of the warp's strip and
// the column pairs (c, c + 1), c = 4j + 2 (l >> 4), j < 16, of that row,
// with 8-byte loads and 4-byte bf16x2 stores; the two lanes of a row
// combine with one shuffle. exp(x) is computed as exp2f(x * log2 e).
__device__ __forceinline__ float pair_max(float x) {
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
}

__device__ __forceinline__ float pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float exp_(float x) { return exp2f(x * kLog2e); }

// Stage rows [row0, row0 + kTile) of one (rows, D) bf16 matrix into shared
// memory (row stride ld_tile<D>()) with 16-byte loads; rows at or past
// `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t row0, int64_t rows) {
  constexpr int kVecPerRow = D / 8;
  const int64_t valid = rows - row0;
  const uint4* s = reinterpret_cast<const uint4*>(src + row0 * D);
  for (int i = threadIdx.x; i < kTile * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    *reinterpret_cast<uint4*>(dst + r * ld_tile<D>() + (i % kVecPerRow) * 8) =
        r < valid ? s[i] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// dst[i] = src[row0 + i] for the tile's rows, `fill` past `rows`.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row0, int64_t rows,
                                          float fill) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    dst[i] = row0 + i < rows ? src[row0 + i] : fill;
  }
}

// The key-side bias of keys [k0, k0 + kTile): 0 without a bias, -inf for
// ragged keys (k >= sk), whose probability is then exactly 0.
__device__ __forceinline__ void load_bias(float* dst, const float* bias_row,
                                          int64_t k0, int64_t sk) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int64_t key = k0 + i;
    dst[i] = key >= sk ? -INFINITY
                       : (bias_row == nullptr ? 0.f : bias_row[key]);
  }
}

// out (16 x kTile f32, ld kLdS) = a (16 x D) * bᵀ, b (kTile x D); a and b
// with row stride ld_tile<D>().
template <int D>
__device__ __forceinline__ void strip_abt(float* out, const bf16* a,
                                          const bf16* b) {
  constexpr int kLd = ld_tile<D>();
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLd);
      wmma::load_matrix_sync(fb, b + n * 16 * kLd + kk * 16, kLd);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kLdS, wmma::mem_row_major);
  }
}

// acc (16 x D fragments in registers) += a (16 x kTile bf16, row stride
// lda) * b (kTile x D, row stride ld_tile<D>()).
template <int D>
__device__ __forceinline__ void strip_ab_acc(FragC (&acc)[D / 16],
                                             const bf16* a, int lda,
                                             const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, lda);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * ld_tile<D>() + n * 16,
                             ld_tile<D>());
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The same product accumulated into a 16 x D f32 strip in shared memory
// (row stride ld_acc<D>(): the forward's accumulator, rescaled row by row).
template <int D>
__device__ __forceinline__ void strip_ab_acc_smem(float* acc, const bf16* a,
                                                  const bf16* b) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    wmma::load_matrix_sync(c, acc + n * 16, ld_acc<D>(), wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdP);
      wmma::load_matrix_sync(fb, b + kk * 16 * ld_tile<D>() + n * 16,
                             ld_tile<D>());
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, ld_acc<D>(),
                            wmma::mem_row_major);
  }
}

// Write a warp's 16 x D register accumulator, times `mul`, as bf16 rows
// [row0 + r] of `dst` (ld D) for row0 + r < rows. `scratch` is the warp's
// 16 x kTile f32 strip (ld kLdS).
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, FragC (&acc)[D / 16],
                                            float* scratch, int64_t row0,
                                            int64_t rows, float mul) {
  const int lane = threadIdx.x & 31;
  constexpr int kGroup = kTile / 16;  // fragments that fit the scratch
#pragma unroll
  for (int n0 = 0; n0 < D / 16; n0 += kGroup) {
    constexpr int kWidthMax = kGroup * 16;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (n0 + j < D / 16) {
        wmma::store_matrix_sync(scratch + j * 16, acc[n0 + j], kLdS,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();
    const int width = D - n0 * 16 < kWidthMax ? D - n0 * 16 : kWidthMax;
    for (int r = 0; r < kStrip; ++r) {
      if (row0 + r >= rows) break;
      bf16* out = dst + (row0 + r) * D + n0 * 16;
      for (int c = lane; c < width; c += 32) {
        out[c] = __float2bfloat16_rn(scratch[r * kLdS + c] * mul);
      }
    }
    __syncwarp();
  }
}

// -- forward -----------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 3 * kTile * ld_tile<D>() * sizeof(bf16)  // q, k, v tiles
         + kTile * kLdP * sizeof(bf16)            // P (bf16)
         + kTile * kLdS * sizeof(float)           // S (f32)
         + kTile * ld_acc<D>() * sizeof(float)    // output accumulator
         + 3 * kTile * sizeof(float);             // max, denominator, bias
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, float* __restrict__ lse, int64_t h,
                 int64_t sq, int64_t sk, float scale, int64_t q_tiles) {
  constexpr int kLdT = ld_tile<D>();
  constexpr int kLdA = ld_acc<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLdT;
  bf16* vs = ks + kTile * kLdT;
  bf16* ps = vs + kTile * kLdT;
  float* ss = reinterpret_cast<float*>(ps + kTile * kLdP);
  float* acc = ss + kTile * kLdS;
  float* row_m = acc + kTile * kLdA;
  float* row_l = row_m + kTile;
  float* bias_s = row_l + kTile;

  const int64_t bh = blockIdx.x / q_tiles;
  const int64_t q0 = (blockIdx.x % q_tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kStrip;
  const int r = r0 + (lane & 15);  // this lane's row of the row work
  const int half = lane >> 4;      // and its columns, 2j + half
  const bf16* km = k + bh * sk * D;
  const bf16* vm = v + bh * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + (bh / h) * sk;

  load_tile<D>(qs, q + bh * sq * D, q0, sq);
  for (int i = threadIdx.x; i < kTile * kLdA; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    row_m[i] = kNegInit;
    row_l[i] = 0.f;
  }

  for (int64_t k0 = 0; k0 < sk; k0 += kTile) {
    __syncthreads();  // the previous k/v tile is consumed by every warp
    load_tile<D>(ks, km, k0, sk);
    load_tile<D>(vs, vm, k0, sk);
    load_bias(bias_s, bias_row, k0, sk);
    __syncthreads();
    strip_abt<D>(ss + r0 * kLdS, qs + r0 * kLdT, ks);
    __syncwarp();
    float2 x[kTile / 4];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const int c = 4 * j + 2 * half;
      const float2 sv = ld2(ss + r * kLdS + c);
      const float2 bv = ld2(bias_s + c);
      x[j] = make_float2(sv.x * scale + bv.x, sv.y * scale + bv.y);
      tile_max = fmaxf(tile_max, fmaxf(x[j].x, x[j].y));
    }
    const float m_prev = row_m[r];
    const float m_new = fmaxf(m_prev, pair_max(tile_max));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 4; ++j) {
      const float p0 = exp_(x[j].x - m_new);
      const float p1 = exp_(x[j].y - m_new);
      st2(ps + r * kLdP + 4 * j + 2 * half, p0, p1);
      sum += p0 + p1;
    }
    sum = pair_sum(sum);  // both lanes of the row have read row_m[r]
    const float corr = exp_(m_prev - m_new);
    if (__any_sync(0xffffffffu, corr != 1.f)) {  // some row's max moved
      for (int d = 2 * half; d < D; d += 4) {
        float2* a = reinterpret_cast<float2*>(acc + r * kLdA + d);
        const float2 av = *a;
        *a = make_float2(av.x * corr, av.y * corr);
      }
    }
    if (half == 0) {
      row_m[r] = m_new;
      row_l[r] = row_l[r] * corr + sum;
    }
    __syncwarp();
    strip_ab_acc_smem<D>(acc + r0 * kLdA, ps + r0 * kLdP, vs);
  }
  __syncwarp();
  for (int rr = r0; rr < r0 + kStrip; ++rr) {
    const int64_t qi = q0 + rr;
    if (qi >= sq) break;
    const float l = fmaxf(row_l[rr], 1e-30f);
    bf16* orow = out + (bh * sq + qi) * D;
    for (int c = lane; c < D; c += 32) {
      orow[c] = __float2bfloat16_rn(acc[rr * kLdA + c] / l);
    }
    if (lane == 0) lse[bh * sq + qi] = row_m[rr] + logf(l);
  }
}

// -- dq ----------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem_bytes() {
  return 4 * kTile * ld_tile<D>() * sizeof(bf16)  // q, dO, k, v tiles
         + 2 * kTile * kLdS * sizeof(float)       // S, dP (f32); dS (bf16)
         + 3 * kTile * sizeof(float);             // lse, delta, bias
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int64_t h, int64_t sq, int64_t sk, float scale,
                int64_t q_tiles) {
  constexpr int kLdT = ld_tile<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kTile * kLdT;
  bf16* ks = dos + kTile * kLdT;
  bf16* vs = ks + kTile * kLdT;
  float* ss = reinterpret_cast<float*>(vs + kTile * kLdT);
  float* dps = ss + kTile * kLdS;
  bf16* dss = reinterpret_cast<bf16*>(dps);  // dS overwrites dP, row by row
  float* lse_s = dps + kTile * kLdS;
  float* delta_s = lse_s + kTile;
  float* bias_s = delta_s + kTile;

  const int64_t bh = blockIdx.x / q_tiles;
  const int64_t q0 = (blockIdx.x % q_tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kStrip;
  const int r = r0 + (lane & 15);
  const int half = lane >> 4;
  const bf16* km = k + bh * sk * D;
  const bf16* vm = v + bh * sk * D;
  const float* bias_row = bias == nullptr ? nullptr : bias + (bh / h) * sk;

  load_tile<D>(qs, q + bh * sq * D, q0, sq);
  load_tile<D>(dos, dout + bh * sq * D, q0, sq);
  // Ragged query rows: lse +inf makes their probabilities exactly 0.
  load_rows(lse_s, lse + bh * sq, q0, sq, INFINITY);
  load_rows(delta_s, delta + bh * sq, q0, sq, 0.f);

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int64_t k0 = 0; k0 < sk; k0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, km, k0, sk);
    load_tile<D>(vs, vm, k0, sk);
    load_bias(bias_s, bias_row, k0, sk);
    __syncthreads();
    strip_abt<D>(ss + r0 * kLdS, qs + r0 * kLdT, ks);     // S = q kᵀ
    strip_abt<D>(dps + r0 * kLdS, dos + r0 * kLdT, vs);   // dP = dO vᵀ
    __syncwarp();
    const float lse_r = lse_s[r];
    const float delta_r = delta_s[r];
    // dS (bf16) overwrites the f32 dP strip: every value is read before
    // the bytes it occupies are rewritten (the bf16 pair at columns c,
    // c + 1 lands on f32 column c / 2, read in the same or an earlier
    // chunk).
#pragma unroll
    for (int chunk = 0; chunk < 2; ++chunk) {
      float2 ds[kTile / 8];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int c = 4 * (chunk * kTile / 8 + j) + 2 * half;
        const float2 sv = ld2(ss + r * kLdS + c);
        const float2 dpv = ld2(dps + r * kLdS + c);
        const float2 bv = ld2(bias_s + c);
        ds[j] = make_float2(
            exp_(sv.x * scale + bv.x - lse_r) * (dpv.x - delta_r),
            exp_(sv.y * scale + bv.y - lse_r) * (dpv.y - delta_r));
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int c = 4 * (chunk * kTile / 8 + j) + 2 * half;
        st2(dss + r * kLdH + c, ds[j].x, ds[j].y);
      }
      __syncwarp();
    }
    strip_ab_acc<D>(acc, dss + r0 * kLdH, kLdH, ks);        // dq += dS k
  }
  __syncwarp();
  store_strip<D>(dq + bh * sq * D, acc, ss + r0 * kLdS, q0 + r0, sq, scale);
}

// -- dk / dv (+ per-head dbias) ----------------------------------------------

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 4 * kTile * ld_tile<D>() * sizeof(bf16)  // k, v, q, dO tiles
         + 2 * kTile * kLdS * sizeof(float)       // Sᵀ, dPᵀ; Pᵀ, dSᵀ
         + 4 * kTile * sizeof(float);             // lse, delta, bias, dbias
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, float* __restrict__ dbias, int64_t h,
                 int64_t sq, int64_t sk, float scale, int64_t k_tiles) {
  constexpr int kLdT = ld_tile<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kTile * kLdT;
  bf16* qs = vs + kTile * kLdT;
  bf16* dos = qs + kTile * kLdT;
  float* sts = reinterpret_cast<float*>(dos + kTile * kLdT);
  float* dpts = sts + kTile * kLdS;
  bf16* pts = reinterpret_cast<bf16*>(sts);    // Pᵀ overwrites Sᵀ
  bf16* dsts = reinterpret_cast<bf16*>(dpts);  // dSᵀ overwrites dPᵀ
  float* lse_s = dpts + kTile * kLdS;
  float* delta_s = lse_s + kTile;
  float* bias_s = delta_s + kTile;
  float* dbias_s = bias_s + kTile;

  const int64_t bh = blockIdx.x / k_tiles;
  const int64_t k0 = (blockIdx.x % k_tiles) * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kStrip;
  const int r = r0 + (lane & 15);  // a key row
  const int half = lane >> 4;      // query columns 2j + half
  const bf16* qm = q + bh * sq * D;
  const bf16* dom = dout + bh * sq * D;

  load_tile<D>(ks, k + bh * sk * D, k0, sk);
  load_tile<D>(vs, v + bh * sk * D, k0, sk);
  load_bias(bias_s, bias == nullptr ? nullptr : bias + (bh / h) * sk, k0,
            sk);
  for (int i = threadIdx.x; i < kTile; i += kThreads) dbias_s[i] = 0.f;

  FragC dk_acc[D / 16];
  FragC dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int64_t q0 = 0; q0 < sq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, qm, q0, sq);
    load_tile<D>(dos, dom, q0, sq);
    load_rows(lse_s, lse + bh * sq, q0, sq, INFINITY);
    load_rows(delta_s, delta + bh * sq, q0, sq, 0.f);
    __syncthreads();
    strip_abt<D>(sts + r0 * kLdS, ks + r0 * kLdT, qs);    // Sᵀ = k qᵀ
    strip_abt<D>(dpts + r0 * kLdS, vs + r0 * kLdT, dos);  // dPᵀ = v dOᵀ
    __syncwarp();
    const float bias_r = bias_s[r];
    float ds_sum = 0.f;
    // Pᵀ and dSᵀ (bf16) overwrite the f32 strips they come from, as in
    // the dq kernel.
#pragma unroll
    for (int chunk = 0; chunk < 2; ++chunk) {
      float2 p[kTile / 8];
      float2 ds[kTile / 8];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int c = 4 * (chunk * kTile / 8 + j) + 2 * half;
        const float2 sv = ld2(sts + r * kLdS + c);
        const float2 dpv = ld2(dpts + r * kLdS + c);
        const float2 lv = ld2(lse_s + c);
        const float2 deltav = ld2(delta_s + c);
        p[j] = make_float2(exp_(sv.x * scale + bias_r - lv.x),
                           exp_(sv.y * scale + bias_r - lv.y));
        ds[j] = make_float2(p[j].x * (dpv.x - deltav.x),
                            p[j].y * (dpv.y - deltav.y));
        ds_sum += ds[j].x + ds[j].y;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const int c = 4 * (chunk * kTile / 8 + j) + 2 * half;
        st2(pts + r * kLdH + c, p[j].x, p[j].y);
        st2(dsts + r * kLdH + c, ds[j].x, ds[j].y);
      }
      __syncwarp();
    }
    ds_sum = pair_sum(ds_sum);
    if (half == 0) dbias_s[r] += ds_sum;
    strip_ab_acc<D>(dv_acc, pts + r0 * kLdH, kLdH, dos);   // dv += Pᵀ dO
    strip_ab_acc<D>(dk_acc, dsts + r0 * kLdH, kLdH, qs);   // dk += dSᵀ q
  }
  __syncwarp();
  store_strip<D>(dv + bh * sk * D, dv_acc, sts + r0 * kLdS, k0 + r0, sk,
                 1.f);
  store_strip<D>(dk + bh * sk * D, dk_acc, sts + r0 * kLdS, k0 + r0, sk,
                 scale);
  if (dbias != nullptr) {
    for (int rr = r0 + lane; rr < r0 + kStrip; rr += 32) {
      if (k0 + rr < sk) dbias[bh * sk + k0 + rr] = dbias_s[rr];
    }
  }
}

// -- launch ------------------------------------------------------------------

// Opt each kernel instantiation in to its dynamic shared memory once (a
// function-scope static per launcher), so that a launch captured into a
// CUDA graph is nothing but the launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int64_t tiles(int64_t rows) { return (rows + kTile - 1) / kTile; }

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int64_t b,
                       int64_t h, int64_t sq, int64_t sk, float scale,
                       cudaStream_t stream) {
  const int64_t q_tiles = tiles(sq);
  const int64_t blocks = b * h * q_tiles;
  constexpr size_t smem = fwd_smem_bytes<D>();
  static const cudaError_t smem_ok = allow_smem(flash_fwd_kernel<D>, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(lse), h, sq, sk, scale,
      q_tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dq, int64_t b, int64_t h,
                      int64_t sq, int64_t sk, float scale,
                      cudaStream_t stream) {
  const int64_t q_tiles = tiles(sq);
  const int64_t blocks = b * h * q_tiles;
  constexpr size_t smem = dq_smem_bytes<D>();
  static const cudaError_t smem_ok = allow_smem(flash_dq_kernel<D>, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_dq_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), h, sq, sk,
      scale, q_tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, void* dbias,
                       int64_t b, int64_t h, int64_t sq, int64_t sk,
                       float scale, cudaStream_t stream) {
  const int64_t k_tiles = tiles(sk);
  const int64_t blocks = b * h * k_tiles;
  constexpr size_t smem = dkv_smem_bytes<D>();
  static const cudaError_t smem_ok = allow_smem(flash_dkv_kernel<D>, smem);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_dkv_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dbias), h, sq, sk, scale,
      k_tiles);
  return cudaGetLastError();
}

bool valid_shape(int64_t b, int64_t h, int64_t sq, int64_t sk) {
  return b > 0 && h > 0 && sq > 0 && sk > 0;
}

}  // namespace

extern "C" {

// Each function launches one kernel on `stream`, does not synchronise and
// allocates nothing. d must be 16, 32, 64 or 128; bias and dbias may be
// null. Returns the cudaError_t of the launch (0 on success).

int rsdl_flash_fwd(const void* q, const void* k, const void* v,
                   const void* bias, void* out, void* lse, int64_t b,
                   int64_t h, int64_t sq, int64_t sk, int d, float scale,
                   void* stream) {
  if (!valid_shape(b, h, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_fwd<16>(q, k, v, bias, out, lse, b, h, sq, sk,
                                   scale, s);
    case 32: return launch_fwd<32>(q, k, v, bias, out, lse, b, h, sq, sk,
                                   scale, s);
    case 64: return launch_fwd<64>(q, k, v, bias, out, lse, b, h, sq, sk,
                                   scale, s);
    case 128: return launch_fwd<128>(q, k, v, bias, out, lse, b, h, sq, sk,
                                     scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int rsdl_flash_dq(const void* q, const void* k, const void* v,
                  const void* bias, const void* dout, const void* lse,
                  const void* delta, void* dq, int64_t b, int64_t h,
                  int64_t sq, int64_t sk, int d, float scale, void* stream) {
  if (!valid_shape(b, h, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, bias, dout, lse, delta, dq, b, h,
                                  sq, sk, scale, s);
    case 32: return launch_dq<32>(q, k, v, bias, dout, lse, delta, dq, b, h,
                                  sq, sk, scale, s);
    case 64: return launch_dq<64>(q, k, v, bias, dout, lse, delta, dq, b, h,
                                  sq, sk, scale, s);
    case 128: return launch_dq<128>(q, k, v, bias, dout, lse, delta, dq, b,
                                    h, sq, sk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

int rsdl_flash_dkv(const void* q, const void* k, const void* v,
                   const void* bias, const void* dout, const void* lse,
                   const void* delta, void* dk, void* dv, void* dbias,
                   int64_t b, int64_t h, int64_t sq, int64_t sk, int d,
                   float scale, void* stream) {
  if (!valid_shape(b, h, sq, sk)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, bias, dout, lse, delta, dk, dv,
                                   dbias, b, h, sq, sk, scale, s);
    case 32: return launch_dkv<32>(q, k, v, bias, dout, lse, delta, dk, dv,
                                   dbias, b, h, sq, sk, scale, s);
    case 64: return launch_dkv<64>(q, k, v, bias, dout, lse, delta, dk, dv,
                                   dbias, b, h, sq, sk, scale, s);
    case 128: return launch_dkv<128>(q, k, v, bias, dout, lse, delta, dk, dv,
                                     dbias, b, h, sq, sk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rsdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
