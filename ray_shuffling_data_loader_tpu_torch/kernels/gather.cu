// Grouped embedding row gather for Hopper (sm_90a). One launch serves a
// group of tables that share the batch B, the width E and the output dtype:
//   out_g[b, :] = cast(table_g[clamp(idx_g[b], 0, V_g - 1), :])  for each g
//
// Replaces the Pallas TPU kernel `_pallas_gather_impl` in
// ray_shuffling_data_loader_tpu/ops/embedding.py:64 (scalar-prefetched
// indices, one HBM->VMEM row DMA per output row, 8 rows per grid step,
// one call per table).
//
// What bounds it on an H100: bytes. A gather does no arithmetic, so the
// least time is the sum over the group of (B*E*4 table bytes read +
// B*E*out_bytes written + B*idx bytes read) over the HBM rate: 12.6 MB and
// 3.8 us for the DLRM step's 8 tables at B=2048, E=128, bf16. Such a call
// is small. To run at the HBM rate the card must keep about latency x
// bandwidth (some 2 MB) of reads in flight, and each row waits on a
// dependent index read first. One table per launch (1.6 MB) never fills
// that pipe and pays a launch and two DRAM round trips per table.
//
// Design:
// - One launch for the whole group (up to kMaxGroups tables; Criteo's 26
//   fit). The descriptors travel by value as a `__grid_constant__` kernel
//   parameter, never through a device copy, so the launch can be captured
//   in a CUDA graph. The grid is (row blocks, groups); each group may use
//   its own index dtype (int8/16/32/64) and output row stride.
// - Each warp takes kRows consecutive output rows of one group. Its first
//   kRows lanes read the indices (one load), a shuffle broadcasts them,
//   and every lane then issues kRows independent 16-byte loads before its
//   first store. A 128-wide f32 row is one warp-wide load, so a warp has
//   kRows * 512 bytes in flight and the DLRM step's whole call (16,384
//   rows) is in flight in one wave. Table rows are read once: the loads
//   are `ld.global.nc` with L1 no-allocate and an L2 evict-first policy,
//   so the indices and outputs keep the cache.
// - The f32 -> bf16 cast is fused into the store with round-to-nearest-
//   even, so the bf16 result equals gather-then-cast
//   (`Tensor.to(torch.bfloat16)`) bit for bit.
// - Vector path when E % 4 == 0 and every table, output and output stride
//   is 16-byte (f32 out) or 8-byte (bf16 out) aligned; otherwise scalar
//   loads and stores, one element per lane.
// - A narrow row (E < 128) leaves lanes idle; the DLRM step's E is 128.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so the build
// takes seconds. The Python mirror of the descriptor structs is
// `GatherGroup` / `GatherArgs` in kernels/build.py; the static_asserts
// below state the layout it must match.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Most tables one launch takes.
constexpr int kMaxGroups = 32;

struct RsdlGatherGroup {
  const float* table;  // (vocab, embed) f32, row-major
  const void* idx;     // (batch,) indices of type idx_code
  void* out;           // batch rows of embed values, out_stride apart
  int64_t vocab;
  int64_t out_stride;  // elements between consecutive output rows
  int32_t idx_code;    // 0 int8, 1 int16, 2 int32, 3 int64
  int32_t reserved;
};

struct RsdlGatherArgs {
  RsdlGatherGroup group[kMaxGroups];
  int64_t batch;
  int64_t embed;
  int32_t num_groups;
  int32_t out_code;  // 0 f32, 1 bf16
};

static_assert(sizeof(RsdlGatherGroup) == 48, "RsdlGatherGroup layout");
static_assert(offsetof(RsdlGatherGroup, table) == 0, "table offset");
static_assert(offsetof(RsdlGatherGroup, idx) == 8, "idx offset");
static_assert(offsetof(RsdlGatherGroup, out) == 16, "out offset");
static_assert(offsetof(RsdlGatherGroup, vocab) == 24, "vocab offset");
static_assert(offsetof(RsdlGatherGroup, out_stride) == 32, "stride offset");
static_assert(offsetof(RsdlGatherGroup, idx_code) == 40, "idx_code offset");
static_assert(sizeof(RsdlGatherArgs) == 1560, "RsdlGatherArgs layout");
static_assert(offsetof(RsdlGatherArgs, batch) == 1536, "batch offset");
static_assert(offsetof(RsdlGatherArgs, embed) == 1544, "embed offset");
static_assert(offsetof(RsdlGatherArgs, num_groups) == 1552, "groups offset");
static_assert(offsetof(RsdlGatherArgs, out_code) == 1556, "out_code offset");

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kRows = 4;   // output rows per warp, loaded before any store
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

__device__ __forceinline__ void store_vec(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
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

__device__ __forceinline__ int64_t load_index(const RsdlGatherGroup& g,
                                              int64_t i) {
  switch (g.idx_code) {
    case 0:
      return static_cast<const int8_t*>(g.idx)[i];
    case 1:
      return static_cast<const int16_t*>(g.idx)[i];
    case 2:
      return static_cast<const int32_t*>(g.idx)[i];
    default:
      return static_cast<const int64_t*>(g.idx)[i];
  }
}

// An L2 policy that evicts these lines first.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// A 16-byte load of data read once: no L1 line, first out of L2.
__device__ __forceinline__ float4 load_once(const float4* p,
                                            uint64_t policy) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
      "{%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// Moves a warp's rows (the first `rows` of kRows are real; output row r at
// dst + r * stride) on the vector path: every lane issues its loads of all
// kRows rows before its first store.
template <typename OutT>
__device__ __forceinline__ void copy_rows(const float* const (&src)[kRows],
                                          OutT* dst, int64_t stride,
                                          int rows, int64_t embed, int lane) {
  const uint64_t policy = evict_first_policy();
  const int64_t nvec = embed >> 2;
  // Not unrolled: the rows give each lane its loads in flight, and an
  // unrolled column loop made ptxas spill on the f32 path.
#pragma unroll 1
  for (int64_t c = lane; c < nvec; c += 32) {
    float4 v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[r] = load_once(reinterpret_cast<const float4*>(src[r]) + c, policy);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) store_vec(dst + r * stride + 4 * c, v[r]);
    }
  }
}

template <typename OutT, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const __grid_constant__ RsdlGatherArgs args) {
  const RsdlGatherGroup& g = args.group[blockIdx.y];
  const int lane = threadIdx.x & 31;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRows;
  if (first >= args.batch) return;  // warp-uniform
  const int64_t left = args.batch - first;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;
  long long mine = 0;
  if (lane < rows) {
    mine = load_index(g, first + lane);
    mine = mine < 0 ? 0 : (mine >= g.vocab ? g.vocab - 1 : mine);
  }
  // Rows past `rows` read table row 0 and store nothing.
  const float* src[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long row = __shfl_sync(0xffffffffu, mine, r);
    src[r] = g.table + row * args.embed;
  }
  OutT* dst = static_cast<OutT*>(g.out) + first * g.out_stride;
  if constexpr (VEC) {
    copy_rows<OutT>(src, dst, g.out_stride, rows, args.embed, lane);
  } else {
    for (int64_t c = lane; c < args.embed; c += 32) {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = __ldg(src[r] + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) store_one(dst + r * g.out_stride + c, v[r]);
      }
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename OutT>
cudaError_t launch(const RsdlGatherArgs& args, cudaStream_t stream) {
  const int64_t per_block = kWarps * kRows;
  const int64_t blocks = (args.batch + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  bool vec = args.embed % 4 == 0;
  for (int i = 0; i < args.num_groups; ++i) {
    const RsdlGatherGroup& g = args.group[i];
    vec = vec && aligned(g.table, 16) && aligned(g.out, 4 * sizeof(OutT)) &&
          g.out_stride % 4 == 0;
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(args.num_groups));
  if (vec) {
    gather_rows_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(args);
  } else {
    gather_rows_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(args);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches one gather over `args->num_groups` tables on `stream`; does not
// synchronise and allocates nothing. Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a descriptor it does not take.
int rsdl_gather_rows(const RsdlGatherArgs* args, void* stream) {
  if (args->num_groups < 1 || args->num_groups > kMaxGroups ||
      args->embed <= 0 || args->batch < 0) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < args->num_groups; ++i) {
    const RsdlGatherGroup& g = args->group[i];
    if (g.vocab <= 0 || g.idx_code < 0 || g.idx_code > 3 ||
        g.out_stride < args->embed) {
      return cudaErrorInvalidValue;
    }
  }
  if (args->batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->out_code == 0) return launch<float>(*args, s);
  if (args->out_code == 1) return launch<__nv_bfloat16>(*args, s);
  return cudaErrorInvalidValue;
}

const char* rsdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
