// Flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Layout (B, H, S, D), bf16 q/k/v/dO, contiguous; an optional f32 key-side
// bias (B, 1, 1, Sk) (a null pointer is the Pallas `_nobias` variant);
// f32 lse and delta (B, H, Sq). scale = 1/sqrt(D). D is 16, 32, 64 or 128.
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
// softmax / gradient accumulators in VMEM scratch. Here a block owns a tile
// of one sequence (query rows for forward and dq, key rows for dk/dv) and
// loops over the other sequence's tiles itself, so the accumulators never
// leave the block and dk, dv and the per-head dbias are written without
// atomics.
//
// Bounds on an NVIDIA H100 80GB HBM3 (700 W: 989.4 TFLOP/s dense bf16,
// 3.35 TB/s), at BERT's B=32, H=12, S=512, D=64 (chip_smoke.py's
// `attention` phase computes them): forward 25.8 GFLOP against 101 MB of
// inputs and outputs, 0.030 ms (bytes); dq 38.7 GFLOP, 0.039 ms
// (operations); dk/dv 51.5 GFLOP, 0.052 ms (operations). The scores never
// reach device memory.
//
// One design for the three kernels: wgmma with the softmax in registers,
// fed by TMA. What it does about the bounds:
// - Every product is a warpgroup `wgmma` (m64nNk16, bf16 in, f32
//   accumulate), the only path to the tensor cores' full rate. Operands in
//   shared memory are read through descriptors; each tile is written by
//   TMA in the swizzled layout its descriptor names (hopper.cuh).
// - The scores, P and dS, the online softmax (running max and sum), dbias
//   and the accumulators stay in registers: a thread holds the pairs at
//   rows lane/4 and lane/4 + 8 of its warp's 16 rows, a row's max and sum
//   take two shuffles within the quad, and P, dS (or Pᵀ, dSᵀ) turn into
//   the next product's A operand register to register (the accumulator
//   layout of two adjacent 8-column groups is the A layout of a k16 step).
//   Shared memory holds only the input tiles; no f32 tile reaches it.
// - A block is one warpgroup that owns 64 rows of one sequence: query
//   rows (forward, dq) or keys (dk/dv). Its own tiles (Q; Q and dO; K and
//   V) arrive once by TMA and stay resident; the other sequence's tiles
//   (K/V in the forward and dq, Q/dO in dk/dv) stream through a ring of
//   kStages stages, each with its own mbarrier, and the next tile's copy
//   starts before the current tile's products. Rows past S are
//   zero-filled by the copy engine (a 3-D tensor map over (B*H, S, D)), so
//   no head reads the next; a copy never asks for more rows than S has.
// - Forward: S = Q Kᵀ, O = O corr + P V. dq: S = Q Kᵀ and dP = dO Vᵀ,
//   both operands K-major; dq += dS K reads the same K stage MN-major (the
//   transpose bit), so one tile serves both forms. dk/dv: Sᵀ = K Qᵀ and
//   dPᵀ = V dOᵀ; dV += Pᵀ dO and dK += dSᵀ Q read the Q/dO stage MN-major,
//   and the lse/delta rows of each Q tile follow it by cp.async (dq reads
//   its own rows' lse and delta once, into registers). At D = 128 a dk/dv
//   stage holds 32 query rows, so dk, dv (128 registers) and the score
//   tiles fit without spilling; at D <= 64 dk/dv is held to three blocks
//   per SM (168 registers, no spills), and dq, at 123 registers, fits
//   four.
// Measured at the main shape on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py, chip_flash_ab.py): forward about 0.078 ms, dq about
// 0.083 ms, dk/dv about 0.136 ms. What they leave for later work: no
// warp specialisation (thread 0 of the block starts the copies, every
// thread waits on the stage), no overlap of the softmax (or dS) with the
// next tile's products, 64-row tiles, one block barrier per tile, and
// direct (unstaged) stores of the outputs.
//
// Numerics: the scores and every product accumulate in f32. P (forward,
// dk/dv) and dS (dq, dk/dv) are rounded to bf16 to feed the tensor cores;
// the row sums, lse and dbias use the unrounded f32 values; exp(x) is
// exp2f(x log2 e) (the kernels carry scores, running max and lse in
// log2 units). The scale multiplies the f32 scores (the Pallas forward
// scales q before the dot: equal up to f32 rounding). Ragged edges: keys at
// k >= Sk get a -inf score and query rows at q >= Sq probability 0 (dq: a
// +inf lse), and their rows are not written; this equals the unpadded
// computation (and JAX's padding with a -1e9 bias wherever a row has a real
// key within 1e9 of its maximum). The running max starts at -1e30 and the
// denominator is clamped at 1e-30, as in the Pallas forward.
//
// Plain C interface, loaded with ctypes: no PyTorch headers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;            // rows of a q-tile and of a k-tile
constexpr float kNegInit = -1e30f;   // running-max init (Pallas `_NEG`)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// -- wgmma kernels: shared pieces -------------------------------------------

constexpr int kWgThreads = 128;     // one warpgroup
constexpr int kStages = 2;          // streamed tiles in flight

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t{1023});
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Zeroes bytes [0, bytes) of shared memory (a multiple of 16) for the
// copy engine and the tensor cores: tiles whose copies fill fewer rows
// than the tile has (a sequence shorter than one tile) stay zero there.
__device__ __forceinline__ void zero_tiles(unsigned char* smem, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  hopper::fence_proxy_async();
}

template <int M>
__device__ __forceinline__ void zero(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) d[i] = 0.f;
}

// Store a warpgroup's 64 x D accumulator (column blocks of kBlockCols),
// times `mul` (one factor per row half), as bf16 rows of `dst` (ld D):
// this thread's rows `row` and `row + 8` where they are below `rows`.
template <int D, int N>
__device__ __forceinline__ void store_rows(
    bf16* dst, const float (&acc)[hopper::Layout<D>::kHalves][N],
    const float (&mul)[2], int row, int rows) {
  using L = hopper::Layout<D>;
  const int col = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= rows) continue;
    bf16* out = dst + static_cast<int64_t>(row + 8 * r) * D + col;
#pragma unroll
    for (int h = 0; h < L::kHalves; ++h) {
#pragma unroll
      for (int c = 0; c < L::kBlockCols / 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(out + h * L::kBlockCols + 8 * c) =
            __floats2bfloat162_rn(acc[h][4 * c + 2 * r] * mul[r],
                                  acc[h][4 * c + 2 * r + 1] * mul[r]);
      }
    }
  }
}

// -- forward -----------------------------------------------------------------

template <int D>
struct FwdSmem {
  using L = hopper::Layout<D>;
  static constexpr int kK = L::bytes(kTile);                   // Q at 0
  static constexpr int kV = kK + kStages * L::bytes(kTile);
  static constexpr int kBars = kV + kStages * L::bytes(kTile);  // Q, K/V
  static constexpr int kBytes = kBars + (1 + kStages) * 8 + 1024;  // + align
};

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 float* __restrict__ lse, int h, int sq, int sk, float scale,
                 int q_tiles, int q_box, int kv_box) {
  // q_box, kv_box: rows per copy, min(tile rows, S) (the maps' boxes).
  using L = hopper::Layout<D>;
  using Sm = FwdSmem<D>;
  constexpr int kNB = L::kBlockCols;  // N of one P*V product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + Sm::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + Sm::kV);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* kv_bar = q_bar + 1;  // one per stage

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int k_tiles = (sk + kTile - 1) / kTile;
  const float* bias_row =
      bias == nullptr ? nullptr : bias + static_cast<int64_t>(bh / h) * sk;

  auto load_kv = [&](int j) {  // K/V tile j into its stage (one thread)
    const int st = j % kStages;
    hopper::mbar_expect_tx(&kv_bar[st], 2 * L::bytes(kv_box));
    hopper::tma_tile<D>(ks + st * kTile * D, &k_map, &kv_bar[st], j * kTile,
                        bh, kTile);
    hopper::tma_tile<D>(vs + st * kTile * D, &v_map, &kv_bar[st], j * kTile,
                        bh, kTile);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&kv_bar[st], 1);
    hopper::mbar_fence_init();
  }
  if (q_box < kTile || kv_box < kTile) zero_tiles(smem, Sm::kBars);
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(q_bar, L::bytes(q_box));
    hopper::tma_tile<D>(qs, &q_map, q_bar, q0, bh, kTile);
    for (int j = 0; j < kStages - 1 && j < k_tiles; ++j) load_kv(j);
  }

  const float scale_log2 = scale * kLog2e;
  float o[L::kHalves][kNB / 2];
#pragma unroll
  for (int hb = 0; hb < L::kHalves; ++hb) zero(o[hb]);
  // Running max (log2 units) of rows lane/4 + 8 r, and this thread's
  // share of their running sums (the quad's shares are added at the end).
  float m[2] = {kNegInit * kLog2e, kNegInit * kLog2e};
  float l[2] = {0.f, 0.f};
  hopper::mbar_wait(q_bar, 0);

  for (int j = 0; j < k_tiles; ++j) {
    const int st = j % kStages;
    // Stage (j - 1) % kStages was released by the barrier that ended
    // iteration j - 1: refill it before this tile's products.
    if (threadIdx.x == 0 && j + kStages - 1 < k_tiles) {
      load_kv(j + kStages - 1);
    }
    hopper::mbar_wait(&kv_bar[st], (j / kStages) & 1);
    const bf16* kt = ks + st * kTile * D;
    const bf16* vt = vs + st * kTile * D;

    // S = Q Kᵀ (64 x 64, f32).
    float s[kTile / 2];
    zero(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<kTile>::ss(
          s, hopper::desc_k<D>(qs, kTile, 0, kk),
          hopper::desc_k<D>(kt, kTile, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // Scores in log2 units: s * scale * log2 e (+ bias * log2 e; -inf for
    // keys past sk). Without a bias or ragged keys the scale is folded into
    // the exponent below.
    const int key0 = j * kTile;
    float mul = scale_log2;
    if (bias_row != nullptr || key0 + kTile > sk) {
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * c + 2 * quad + e;
          const float add = key >= sk ? -INFINITY
                            : bias_row == nullptr ? 0.f
                                                  : bias_row[key] * kLog2e;
          s[4 * c + e] = fmaf(s[4 * c + e], scale_log2, add);
          s[4 * c + 2 + e] = fmaf(s[4 * c + 2 + e], scale_log2, add);
        }
      }
      mul = 1.f;
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTile / 8; ++c) {
        mx = fmaxf(mx, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
      }
      const float m_new = fmaxf(m[r], quad_max(mx) * mul);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // P = exp2(score - max), summed in f32 and packed as bf16 A fragments.
    uint32_t p[kTile / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = exp2f(fmaf(s[4 * c + i], mul, -m[i / 2]));
      }
      sum[0] += pv[0] + pv[1];
      sum[1] += pv[2] + pv[3];
      p[c / 2][2 * (c % 2)] = hopper::pack_bf16(pv[0], pv[1]);
      p[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];

    // O = O * corr + P V.
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
#pragma unroll
      for (int i = 0; i < kNB / 2; ++i) o[hb][i] *= corr[(i / 2) % 2];
      hopper::fence_regs(o[hb]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        hopper::Wgmma<kNB>::rs(o[hb], p[kk],
                               hopper::desc_mn<D>(vt, kTile, kk, hb));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) hopper::fence_regs(o[hb]);
    __syncthreads();  // stage st is free for the copy issued next
  }

  const int row = q0 + 16 * warp + lane / 4;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_sum = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / l_sum;
    if (quad == 0 && row + 8 * r < sq) {
      lse[static_cast<int64_t>(bh) * sq + row + 8 * r] =
          m[r] * kLn2 + logf(l_sum);
    }
  }
  store_rows<D>(out + static_cast<int64_t>(bh) * sq * D, o, inv, row, sq);
}

// -- dq ----------------------------------------------------------------------

template <int D>
struct DqSmem {
  using L = hopper::Layout<D>;
  static constexpr int kDo = L::bytes(kTile);                   // Q at 0
  static constexpr int kK = kDo + L::bytes(kTile);
  static constexpr int kV = kK + kStages * L::bytes(kTile);
  static constexpr int kBars = kV + kStages * L::bytes(kTile);  // Q/dO, K/V
  static constexpr int kBytes = kBars + (1 + kStages) * 8 + 1024;  // + align
};

// dq = scale * sum_k dS K, dS = P (dP - delta), P = exp(scale Q Kᵀ +
// bias_k - lse), dP = dO Vᵀ. The lse may be taken over more keys than this
// call has (ring attention's per-hop backward), so P is used as it is and
// never renormalised. At D <= 64 the bound of three blocks per SM (168
// registers) does not bind: the kernel needs 123 at D = 64, so four blocks
// share an SM, and bounds of two, three or four time the same
// (chip_flash_ab.py, NVIDIA H100 80GB HBM3, 700 W). At D = 128 dq (64
// registers), S and dP (32 each) and the dS fragments (16) fit in 156
// registers without spilling.
template <int D>
__global__ void __launch_bounds__(kWgThreads, D <= 64 ? 3 : 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ bias,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int h, int sq, int sk, float scale, int q_tiles, int q_box,
                int kv_box) {
  // q_box, kv_box: rows per copy, min(tile rows, S) (the maps' boxes).
  using L = hopper::Layout<D>;
  using Sm = DqSmem<D>;
  constexpr int kNB = L::kBlockCols;  // N of one dS K product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = reinterpret_cast<bf16*>(smem + Sm::kDo);
  bf16* ks = reinterpret_cast<bf16*>(smem + Sm::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + Sm::kV);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* kv_bar = q_bar + 1;  // one per stage

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int k_tiles = (sk + kTile - 1) / kTile;
  const float* bias_row =
      bias == nullptr ? nullptr : bias + static_cast<int64_t>(bh / h) * sk;

  auto load_kv = [&](int j) {  // K/V tile j into its stage (one thread)
    const int st = j % kStages;
    hopper::mbar_expect_tx(&kv_bar[st], 2 * L::bytes(kv_box));
    hopper::tma_tile<D>(ks + st * kTile * D, &k_map, &kv_bar[st], j * kTile,
                        bh, kTile);
    hopper::tma_tile<D>(vs + st * kTile * D, &v_map, &kv_bar[st], j * kTile,
                        bh, kTile);
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&kv_bar[st], 1);
    hopper::mbar_fence_init();
  }
  if (q_box < kTile || kv_box < kTile) zero_tiles(smem, Sm::kBars);
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(q_bar, 2 * L::bytes(q_box));
    hopper::tma_tile<D>(qs, &q_map, q_bar, q0, bh, kTile);
    hopper::tma_tile<D>(dos, &do_map, q_bar, q0, bh, kTile);
    for (int j = 0; j < kStages - 1 && j < k_tiles; ++j) load_kv(j);
  }

  // This thread's query rows row + 8 r: lse in log2 units (+inf past sq,
  // so that P is 0 there) and delta.
  const int row = q0 + 16 * warp + lane / 4;
  float lse2[2];
  float delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at = static_cast<int64_t>(bh) * sq + row + 8 * r;
    const bool in = row + 8 * r < sq;
    lse2[r] = in ? lse[at] * kLog2e : INFINITY;
    delta_r[r] = in ? delta[at] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  float acc[L::kHalves][kNB / 2];
#pragma unroll
  for (int hb = 0; hb < L::kHalves; ++hb) zero(acc[hb]);
  hopper::mbar_wait(q_bar, 0);

  for (int j = 0; j < k_tiles; ++j) {
    const int st = j % kStages;
    // Stage (j - 1) % kStages was released by the barrier that ended
    // iteration j - 1: refill it before this tile's products.
    if (threadIdx.x == 0 && j + kStages - 1 < k_tiles) {
      load_kv(j + kStages - 1);
    }
    hopper::mbar_wait(&kv_bar[st], (j / kStages) & 1);
    const bf16* kt = ks + st * kTile * D;
    const bf16* vt = vs + st * kTile * D;

    // S = Q Kᵀ and dP = dO Vᵀ (64 x 64, f32), both operands K-major, as
    // two commit groups: P is computed while dP is still in flight.
    float s[kTile / 2];
    float dp[kTile / 2];
    zero(s);
    zero(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<kTile>::ss(
          s, hopper::desc_k<D>(qs, kTile, 0, kk),
          hopper::desc_k<D>(kt, kTile, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<kTile>::ss(
          dp, hopper::desc_k<D>(dos, kTile, 0, kk),
          hopper::desc_k<D>(vt, kTile, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s);

    // P = exp2(s scale log2 e + bias_k log2 e - lse log2 e), over S in
    // place. Keys past sk get a -inf score, so their P and dS are exactly
    // 0. That guard, and not the zero-filled K rows, keeps dq right: P
    // there is exp(-lse), which overflows for a very negative lse, and
    // inf * 0 is NaN.
    const int key0 = j * kTile;
    const bool col_add = bias_row != nullptr || key0 + kTile > sk;
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      float add[2] = {0.f, 0.f};
      if (col_add) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * c + 2 * quad + e;
          add[e] = key >= sk ? -INFINITY
                   : bias_row == nullptr ? 0.f
                                         : bias_row[key] * kLog2e;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[4 * c + i] =
            exp2f(fmaf(s[4 * c + i], scale_log2, add[i % 2] - lse2[i / 2]));
      }
    }
    // dS = P (dP - delta), packed as bf16 A fragments.
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int c = 0; c < kTile / 8; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[i] = s[4 * c + i] * (dp[4 * c + i] - delta_r[i / 2]);
      }
      da[c / 2][2 * (c % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }

    // dq += dS K (the K stage read MN-major).
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) hopper::fence_regs(acc[hb]);
    hopper::wgmma_fence();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        hopper::Wgmma<kNB>::rs(acc[hb], da[kk],
                               hopper::desc_mn<D>(kt, kTile, kk, hb));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) hopper::fence_regs(acc[hb]);
    __syncthreads();  // stage st is free for the next copy
  }

  const float scales[2] = {scale, scale};
  store_rows<D>(dq + static_cast<int64_t>(bh) * sq * D, acc, scales, row,
                sq);
}

// -- dk / dv (+ per-head dbias) ----------------------------------------------

template <int D>
struct DkvSmem {
  using L = hopper::Layout<D>;
  // Query rows per stage: at D = 128, 32 keep dk, dv and the score tiles
  // in registers.
  static constexpr int kQRows = D == 128 ? 32 : 64;
  static constexpr int kV = L::bytes(kTile);                    // K at 0
  static constexpr int kQ = kV + L::bytes(kTile);
  static constexpr int kDo = kQ + kStages * L::bytes(kQRows);
  static constexpr int kLse = kDo + kStages * L::bytes(kQRows);
  static constexpr int kDelta = kLse + kStages * kQRows * 4;
  static constexpr int kBars = kDelta + kStages * kQRows * 4;  // K/V, Q
  static constexpr int kBytes = kBars + (1 + kStages) * 8 + 1024;  // + align
};

// At D <= 64 three blocks share an SM (at most 168 registers, no spills):
// 0.135 ms against 0.158 ms with the two that 200 registers allow at the
// main shape (chip_flash_ab.py, NVIDIA H100 80GB HBM3, 700 W).
template <int D>
__global__ void __launch_bounds__(kWgThreads, D <= 64 ? 3 : 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, float* __restrict__ dbias, int h,
                 int sq, int sk, float scale, int k_tiles, int q_box,
                 int kv_box) {
  // q_box, kv_box: rows per copy, min(tile rows, S) (the maps' boxes).
  using L = hopper::Layout<D>;
  using Sm = DkvSmem<D>;
  constexpr int kQR = Sm::kQRows;
  constexpr int kNB = L::kBlockCols;  // N of one dV or dK product
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + Sm::kV);
  bf16* qs = reinterpret_cast<bf16*>(smem + Sm::kQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + Sm::kDo);
  float* lse_s = reinterpret_cast<float*>(smem + Sm::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + Sm::kDelta);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(smem + Sm::kBars);
  uint64_t* q_bar = kv_bar + 1;  // one per stage

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int q_tiles = (sq + kQR - 1) / kQR;

  auto load_q = [&](int j) {  // Q/dO tile j (one thread)
    const int st = j % kStages;
    hopper::mbar_expect_tx(&q_bar[st], 2 * L::bytes(q_box));
    hopper::tma_tile<D>(qs + st * kQR * D, &q_map, &q_bar[st], j * kQR, bh,
                        kQR);
    hopper::tma_tile<D>(dos + st * kQR * D, &do_map, &q_bar[st], j * kQR, bh,
                        kQR);
  };
  // The lse and delta rows of Q tile j, 4 bytes a thread by cp.async (zero
  // past sq); the issuing threads wait for them before the barrier that
  // ends the iteration (or the prologue).
  const float* lse_bh = lse + static_cast<int64_t>(bh) * sq;
  const float* delta_bh = delta + static_cast<int64_t>(bh) * sq;
  auto load_rows_async = [&](int j) {
    const int st = j % kStages;
    const int i = threadIdx.x % kQR;
    const int row = j * kQR + i;
    const int src = row < sq ? row : sq - 1;
    if (threadIdx.x < kQR) {
      hopper::cp_async_4(lse_s + st * kQR + i, lse_bh + src, row < sq);
    } else if (threadIdx.x < 2 * kQR) {
      hopper::cp_async_4(delta_s + st * kQR + i, delta_bh + src, row < sq);
    }
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_bar, 1);
    for (int st = 0; st < kStages; ++st) hopper::mbar_init(&q_bar[st], 1);
    hopper::mbar_fence_init();
  }
  if (q_box < kQR || kv_box < kTile) zero_tiles(smem, Sm::kLse);
  for (int j = 0; j < kStages - 1 && j < q_tiles; ++j) load_rows_async(j);
  hopper::cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x == 0) {
    hopper::mbar_expect_tx(kv_bar, 2 * L::bytes(kv_box));
    hopper::tma_tile<D>(ks, &k_map, kv_bar, k0, bh, kTile);
    hopper::tma_tile<D>(vs, &v_map, kv_bar, k0, bh, kTile);
    for (int j = 0; j < kStages - 1 && j < q_tiles; ++j) load_q(j);
  }

  // This thread's key rows k0 + key + 8 r: their bias in log2 units, -inf
  // past sk (probability 0).
  const int key = k0 + 16 * warp + lane / 4;
  float bias_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bias_r[r] = key + 8 * r >= sk ? -INFINITY
                : bias == nullptr
                    ? 0.f
                    : bias[static_cast<int64_t>(bh / h) * sk + key + 8 * r] *
                          kLog2e;
  }
  const float scale_log2 = scale * kLog2e;
  float dk_acc[L::kHalves][kNB / 2];
  float dv_acc[L::kHalves][kNB / 2];
#pragma unroll
  for (int hb = 0; hb < L::kHalves; ++hb) {
    zero(dk_acc[hb]);
    zero(dv_acc[hb]);
  }
  float dsum[2] = {0.f, 0.f};  // this thread's share of the rows' dbias
  hopper::mbar_wait(kv_bar, 0);

  for (int j = 0; j < q_tiles; ++j) {
    const int st = j % kStages;
    if (j + kStages - 1 < q_tiles) {
      if (threadIdx.x == 0) load_q(j + kStages - 1);
      load_rows_async(j + kStages - 1);
    }
    hopper::mbar_wait(&q_bar[st], (j / kStages) & 1);
    const bf16* qt = qs + st * kQR * D;
    const bf16* dot = dos + st * kQR * D;
    const float* lt = lse_s + st * kQR;
    const float* dt = delta_s + st * kQR;

    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (64 keys x kQR queries, f32).
    float s[kQR / 2];
    float dp[kQR / 2];
    zero(s);
    zero(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<kQR>::ss(s, hopper::desc_k<D>(ks, kTile, 0, kk),
                             hopper::desc_k<D>(qt, kQR, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      hopper::Wgmma<kQR>::ss(dp, hopper::desc_k<D>(vs, kTile, 0, kk),
                             hopper::desc_k<D>(dot, kQR, 0, kk), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // Pᵀ = exp(s scale + bias_k - lse_q), dSᵀ = Pᵀ (dPᵀ - delta_q), both
    // packed as bf16 A fragments; dbias sums the unrounded dSᵀ.
    const int qbase = j * kQR;
    const bool q_edge = qbase + kQR > sq;
    uint32_t pa[kQR / 16][4];
    uint32_t da[kQR / 16][4];
#pragma unroll
    for (int c = 0; c < kQR / 8; ++c) {
      const float2 lv = *reinterpret_cast<const float2*>(lt + 8 * c +
                                                         2 * quad);
      const float2 dl = *reinterpret_cast<const float2*>(dt + 8 * c +
                                                         2 * quad);
      const float lse2[2] = {lv.x * kLog2e, lv.y * kLog2e};
      const float delta_q[2] = {dl.x, dl.y};
      float pv[4];
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i / 2;
        const int e = i % 2;
        float pp = exp2f(fmaf(s[4 * c + i], scale_log2, bias_r[r] - lse2[e]));
        float ds = pp * (dp[4 * c + i] - delta_q[e]);
        if (q_edge && qbase + 8 * c + 2 * quad + e >= sq) pp = ds = 0.f;
        pv[i] = pp;
        dsv[i] = ds;
        dsum[r] += dsv[i];
      }
      pa[c / 2][2 * (c % 2)] = hopper::pack_bf16(pv[0], pv[1]);
      pa[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(pv[2], pv[3]);
      da[c / 2][2 * (c % 2)] = hopper::pack_bf16(dsv[0], dsv[1]);
      da[c / 2][2 * (c % 2) + 1] = hopper::pack_bf16(dsv[2], dsv[3]);
    }

    // dV += Pᵀ dO, dK += dSᵀ Q (the Q/dO stage read MN-major).
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
      hopper::fence_regs(dv_acc[hb]);
      hopper::fence_regs(dk_acc[hb]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
#pragma unroll
      for (int kk = 0; kk < kQR / 16; ++kk) {
        hopper::Wgmma<kNB>::rs(dv_acc[hb], pa[kk],
                               hopper::desc_mn<D>(dot, kQR, kk, hb));
        hopper::Wgmma<kNB>::rs(dk_acc[hb], da[kk],
                               hopper::desc_mn<D>(qt, kQR, kk, hb));
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int hb = 0; hb < L::kHalves; ++hb) {
      hopper::fence_regs(dv_acc[hb]);
      hopper::fence_regs(dk_acc[hb]);
    }
    hopper::cp_async_wait_all();
    __syncthreads();  // stage st is free for the copies issued next
  }

  const float ones[2] = {1.f, 1.f};
  const float scales[2] = {scale, scale};
  store_rows<D>(dv + static_cast<int64_t>(bh) * sk * D, dv_acc, ones, key,
                sk);
  store_rows<D>(dk + static_cast<int64_t>(bh) * sk * D, dk_acc, scales, key,
                sk);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(dsum[r]);
    if (dbias != nullptr && quad == 0 && key + 8 * r < sk) {
      dbias[static_cast<int64_t>(bh) * sk + key + 8 * r] = total;
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

// cuTensorMapEncodeTiled, found through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (mats, rows, D) bf16 tensor read in boxes of `box_rows` rows and one
// column block, with the swizzle of the block's row width.
template <int D>
cudaError_t encode_rows(CUtensorMap* map, const void* base, int64_t mats,
                        int64_t rows, int box_rows) {
  using L = hopper::Layout<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(mats)};
  const cuuint64_t strides[2] = {2 * D, static_cast<cuuint64_t>(rows) * 2 * D};
  const cuuint32_t box[3] = {L::kBlockCols, static_cast<cuuint32_t>(box_rows),
                             1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The wgmma kernels index rows with 32-bit ints.
bool fits_int32(int64_t b, int64_t h, int64_t sq, int64_t sk) {
  const int64_t rows = b * h * (sq > sk ? sq : sk);
  return rows < (int64_t{1} << 31) - 2 * kTile;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int64_t b,
                       int64_t h, int64_t sq, int64_t sk, float scale,
                       cudaStream_t stream) {
  using Sm = FwdSmem<D>;
  const int64_t q_tiles = tiles(sq);
  static const cudaError_t smem_ok = allow_smem(flash_fwd_kernel<D>,
                                                Sm::kBytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (!fits_int32(b, h, sq, sk)) return cudaErrorInvalidConfiguration;
  // A copy never asks for more rows than the sequence has.
  const int q_box = static_cast<int>(sq < kTile ? sq : kTile);
  const int kv_box = static_cast<int>(sk < kTile ? sk : kTile);
  CUtensorMap q_map, k_map, v_map;
  cudaError_t rc = encode_rows<D>(&q_map, q, b * h, sq, q_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&k_map, k, b * h, sk, kv_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&v_map, v, b * h, sk, kv_box);
  if (rc != cudaSuccess) return rc;
  flash_fwd_kernel<D><<<static_cast<unsigned>(b * h * q_tiles), kWgThreads,
                        Sm::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<const float*>(bias),
      static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<int>(h), static_cast<int>(sq), static_cast<int>(sk), scale,
      static_cast<int>(q_tiles), q_box, kv_box);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* bias, const void* dout, const void* lse,
                      const void* delta, void* dq, int64_t b, int64_t h,
                      int64_t sq, int64_t sk, float scale,
                      cudaStream_t stream) {
  using Sm = DqSmem<D>;
  const int64_t q_tiles = tiles(sq);
  static const cudaError_t smem_ok = allow_smem(flash_dq_kernel<D>,
                                                Sm::kBytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (!fits_int32(b, h, sq, sk)) return cudaErrorInvalidConfiguration;
  const int q_box = static_cast<int>(sq < kTile ? sq : kTile);
  const int kv_box = static_cast<int>(sk < kTile ? sk : kTile);
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t rc = encode_rows<D>(&q_map, q, b * h, sq, q_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&do_map, dout, b * h, sq, q_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&k_map, k, b * h, sk, kv_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&v_map, v, b * h, sk, kv_box);
  if (rc != cudaSuccess) return rc;
  flash_dq_kernel<D><<<static_cast<unsigned>(b * h * q_tiles), kWgThreads,
                       Sm::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(bias),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<int>(h), static_cast<int>(sq),
      static_cast<int>(sk), scale, static_cast<int>(q_tiles), q_box, kv_box);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* bias, const void* dout, const void* lse,
                       const void* delta, void* dk, void* dv, void* dbias,
                       int64_t b, int64_t h, int64_t sq, int64_t sk,
                       float scale, cudaStream_t stream) {
  using Sm = DkvSmem<D>;
  const int64_t k_tiles = tiles(sk);
  static const cudaError_t smem_ok = allow_smem(flash_dkv_kernel<D>,
                                                Sm::kBytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  if (!fits_int32(b, h, sq, sk)) return cudaErrorInvalidConfiguration;
  const int q_box = static_cast<int>(sq < Sm::kQRows ? sq : Sm::kQRows);
  const int kv_box = static_cast<int>(sk < kTile ? sk : kTile);
  CUtensorMap q_map, k_map, v_map, do_map;
  cudaError_t rc = encode_rows<D>(&q_map, q, b * h, sq, q_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&do_map, dout, b * h, sq, q_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&k_map, k, b * h, sk, kv_box);
  if (rc == cudaSuccess) rc = encode_rows<D>(&v_map, v, b * h, sk, kv_box);
  if (rc != cudaSuccess) return rc;
  flash_dkv_kernel<D><<<static_cast<unsigned>(b * h * k_tiles), kWgThreads,
                        Sm::kBytes, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(dbias), static_cast<int>(h), static_cast<int>(sq),
      static_cast<int>(sk), scale, static_cast<int>(k_tiles), q_box, kv_box);
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
