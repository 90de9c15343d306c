// Hopper (sm_90a) building blocks for the flash-attention kernels: shared
// memory addresses, mbarriers, TMA tile loads, wgmma matrix descriptors and
// the wgmma products themselves (PTX inline assembly; no CUTLASS).
//
// Shared-memory tiles. A tile holds R rows of D bf16 values as
// `Layout<D>::kHalves` column blocks of `kRowBytes` bytes per row (one
// block, 2*D bytes wide, for D <= 64; two blocks of 64 columns for
// D = 128), each written by TMA with the swizzle of its row width (32, 64
// or 128 bytes) and read by wgmma through a descriptor that names the same
// swizzle. Every tile starts on a 1024-byte boundary, so the swizzle
// pattern (which the hardware derives from the address) is the same for
// the copy engine and the tensor cores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int D>
struct Layout {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kHalves = 2 * D / kRowBytes;  // column blocks
  static constexpr int kBlockCols = kRowBytes / 2;   // bf16 per block row
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  // swizzle.
  static constexpr int kSwizzle = kRowBytes == 128 ? 1
                                  : kRowBytes == 64 ? 2 : 3;
  // Bytes of one R-row tile.
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * 2 * D;
  }
};

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the copy engine; then sync.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of copies to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Rows [row0, row0 + box) of matrix `mat` of a (mats, S, D) bf16 tensor
// (box = the tensor map's box rows) into a tile of `rows` rows (every
// column block); rows past S arrive as zeros.
template <int D>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int row0, int mat,
                                         int rows) {
#pragma unroll
  for (int h = 0; h < Layout<D>::kHalves; ++h) {
    tma_load_3d(dst + h * rows * Layout<D>::kBlockCols, map, bar,
                h * Layout<D>::kBlockCols, row0, mat);
  }
}

// Orders this thread's generic-proxy writes to shared memory (a zero fill)
// before later reads and writes by the copy engine and the tensor cores.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- cp.async (4 bytes; zero-filled where `valid` is false) -------------------

__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- wgmma descriptors -------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

// K-major operand: rows [r0, r0 + 64) of an R-row tile, k-step kk (columns
// [16 kk, 16 kk + 16)). 8-row groups lie 8 rows apart (SBO); a k-step
// inside a swizzled row is a 32-byte offset of the start address.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile,
                                           int rows, int r0, int kk) {
  using L = Layout<D>;
  const int byte = kk * 32;
  const char* p = reinterpret_cast<const char*>(tile) +
                  (byte / L::kRowBytes) * rows * L::kRowBytes +
                  r0 * L::kRowBytes + byte % L::kRowBytes;
  return make_desc(p, 16, 8 * L::kRowBytes, L::kSwizzle);
}

// MN-major operand (the B of `A * tile`, the tile's rows being the k
// dimension): rows [16 kk, 16 kk + 16) of an R-row tile, column block h.
// 8-row k groups lie 8 rows apart (SBO); column blocks R rows apart (LBO).
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile,
                                            int rows, int kk, int h) {
  using L = Layout<D>;
  const char* p = reinterpret_cast<const char*>(tile) +
                  h * rows * L::kRowBytes + kk * 16 * L::kRowBytes;
  return make_desc(p, rows * L::kRowBytes, 8 * L::kRowBytes, L::kSwizzle);
}

// -- wgmma -------------------------------------------------------------------

// Orders earlier register and shared-memory writes before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous product (call before issuing and after waiting).
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Two f32 as one bf16x2 register (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The products. Accumulator layout of m64nNk16 (thread t of the
// warpgroup, warp w = t / 32, lane l): d[4c + 2r + e] is row
// 16 w + l / 4 + 8 r, column 8 c + 2 (l % 4) + e. The A-register layout of
// a k16 step is the same map over two 8-column groups: a[0..3] hold
// (row, k) = (g, 2q), (g + 8, 2q), (g, 8 + 2q), (g + 8, 8 + 2q) as bf16
// pairs, g = l / 4, q = l % 4.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (64 x 16 f32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // d (64 x 32 f32) (+)= A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 32 f32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64 f32) (+)= A (smem, K-major) * B (smem, K-major)
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d (64 x 64 f32) += A (registers) * B (smem, MN-major)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


}  // namespace hopper
