// Embedding row gather for Hopper (sm_90a):
//   out[b, :] = cast(table[clamp(idx[b], 0, V - 1), :])
//
// Replaces the Pallas TPU kernel `_pallas_gather_impl` in
// ray_shuffling_data_loader_tpu/ops/embedding.py (scalar-prefetched
// indices, one HBM->VMEM row DMA per output row, 8 rows per grid step).
//
// What bounds it on an H100: bytes. A gather does no arithmetic, so the
// least time is (B*E*4 table bytes read + B*E*out_bytes written + B*idx
// bytes read) over the HBM rate. Design: one warp per output row, each lane
// moving 16-byte float4 vectors, so a 128-wide f32 row (512 bytes) is one
// fully coalesced warp-wide load; rows are independent, so the grid is
// simply B / 8 blocks of 8 warps and the card hides the row-fetch latency
// with many rows in flight (the role the TPU kernel's back-to-back DMAs
// played). The f32 -> bf16 cast is fused into the store with
// round-to-nearest-even, so the bf16 result equals gather-then-cast
// (`Tensor.to(torch.bfloat16)`) bit for bit.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so the build
// takes seconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void store_vec(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, float4 v) {
  uint2 packed;
  packed.x = pack_bf16x2(v.x, v.y);
  packed.y = pack_bf16x2(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}

__device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// VEC: E % 4 == 0, so every row starts 16-byte aligned (the table and the
// output come from the caching allocator, which aligns to 512 bytes).
template <typename IdxT, typename OutT, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const float* __restrict__ table,
                   const IdxT* __restrict__ idx, OutT* __restrict__ out,
                   int64_t batch, int64_t vocab, int64_t embed) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= batch) return;
  int64_t r = static_cast<int64_t>(idx[row]);
  r = r < 0 ? 0 : (r >= vocab ? vocab - 1 : r);
  const float* src = table + r * embed;
  OutT* dst = out + row * embed;
  if (VEC) {
    const int64_t nvec = embed >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int64_t c = lane; c < nvec; c += 32) {
      store_vec(dst + 4 * c, __ldg(src4 + c));
    }
  } else {
    for (int64_t c = lane; c < embed; c += 32) {
      store_one(dst + c, __ldg(src + c));
    }
  }
}

template <typename IdxT, typename OutT>
cudaError_t launch_typed(const float* table, const void* idx, void* out,
                         int64_t batch, int64_t vocab, int64_t embed,
                         cudaStream_t stream) {
  const int64_t blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  if (embed % 4 == 0) {
    gather_rows_kernel<IdxT, OutT, true><<<grid, block, 0, stream>>>(
        table, static_cast<const IdxT*>(idx), static_cast<OutT*>(out), batch,
        vocab, embed);
  } else {
    gather_rows_kernel<IdxT, OutT, false><<<grid, block, 0, stream>>>(
        table, static_cast<const IdxT*>(idx), static_cast<OutT*>(out), batch,
        vocab, embed);
  }
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_idx(const float* table, const void* idx, int idx_code,
                       void* out, int64_t batch, int64_t vocab, int64_t embed,
                       cudaStream_t stream) {
  switch (idx_code) {
    case 0:
      return launch_typed<int8_t, OutT>(table, idx, out, batch, vocab, embed,
                                        stream);
    case 1:
      return launch_typed<int16_t, OutT>(table, idx, out, batch, vocab, embed,
                                         stream);
    case 2:
      return launch_typed<int32_t, OutT>(table, idx, out, batch, vocab, embed,
                                         stream);
    case 3:
      return launch_typed<int64_t, OutT>(table, idx, out, batch, vocab, embed,
                                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// idx_code: 0 int8, 1 int16, 2 int32, 3 int64. out_code: 0 f32, 1 bf16.
// Returns the cudaError_t of the launch (0 on success). Launches on
// `stream`, does not synchronise and allocates nothing.
int rsdl_gather_rows(const void* table, const void* idx, int idx_code,
                     void* out, int out_code, int64_t batch, int64_t vocab,
                     int64_t embed, void* stream) {
  if (batch <= 0) return 0;
  if (vocab <= 0 || embed <= 0) return cudaErrorInvalidValue;
  const float* t = static_cast<const float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_code == 0) {
    return launch_idx<float>(t, idx, idx_code, out, batch, vocab, embed, s);
  }
  if (out_code == 1) {
    return launch_idx<__nv_bfloat16>(t, idx, idx_code, out, batch, vocab,
                                     embed, s);
  }
  return cudaErrorInvalidValue;
}

const char* rsdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
