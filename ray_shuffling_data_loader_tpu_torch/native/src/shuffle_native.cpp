// Native host-side kernels of the shuffle (the port's own copy of the JAX
// package's native/src/shuffle_native.cpp; the arithmetic is unchanged, so
// both packages draw the same partition plans and checksums):
//
//   - partition plan: the counter-based splitmix64 row -> reducer
//     assignment fused with a stable counting sort, the counts-only plan
//     and the per-batch destination slots of the streaming map;
//   - scatter_gather: the reduce's fused out[dest[i]] = src[idx[i]];
//   - crc32: zlib-compatible checksum (spill files);
//   - buffer pool: a ref-counted ledger of host bytes (aligned allocations
//     and accounting-only entries) with an exact-size-class free list;
//   - frame_send / read_exact: one GIL-free call per transport frame;
//   - fill_random_*: threaded xoshiro256** fills (the JAX package's data
//     generator; the port does not bind them).
//
// Exposed with a plain C ABI and loaded from Python via ctypes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/uio.h>
#include <unistd.h>

#if defined(__ARM_FEATURE_CRC32)
#include <arm_acle.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Partition kernel
// ---------------------------------------------------------------------------

// Stable counting sort: out_indices[i] receives the row indices assigned to
// reducer i, in original row order. out_indices must have room for n int64s,
// laid out contiguously; out_offsets gets num_reducers+1 entries.
// Returns 0 on success, -1 if any assignment is >= num_reducers (in which
// case no output is written).
int rsdl_partition_indices(const uint32_t* assignments, int64_t n,
                           int64_t num_reducers, int64_t* out_indices,
                           int64_t* out_offsets) {
  if (num_reducers < 1) return -1;
  std::vector<int64_t> counts(num_reducers, 0);
  const uint64_t bound = static_cast<uint64_t>(num_reducers);
  for (int64_t i = 0; i < n; ++i) {
    if (assignments[i] >= bound) return -1;
    counts[assignments[i]]++;
  }
  out_offsets[0] = 0;
  for (int64_t r = 0; r < num_reducers; ++r)
    out_offsets[r + 1] = out_offsets[r] + counts[r];
  std::vector<int64_t> cursor(out_offsets, out_offsets + num_reducers);
  for (int64_t i = 0; i < n; ++i) out_indices[cursor[assignments[i]]++] = i;
  return 0;
}

// ---------------------------------------------------------------------------
// Fused partition plan: per-row RNG -> stable counting sort, one kernel
// ---------------------------------------------------------------------------

// The map stage's assign -> partition pipeline used to materialize a uint32
// assignment array via a numpy Philox draw, cross the ctypes boundary, and
// counting-sort it (rsdl_partition_indices) — three passes over n and two
// kernel launches. This kernel fuses the stages: each row's reducer
// assignment is a stateless splitmix64 hash of (key, row) computed in the
// count pass and stashed in a scratch vector the placement pass re-reads
// (4n scratch bytes stream through cache faster than a second round of
// 64-bit multiplies). The hash is counter-based, so both passes parallelize
// over contiguous row chunks and placement stays stable via per-(chunk,
// reducer) cursors. The Python fallback (native/__init__.py hash_assign)
// vectorizes the identical arithmetic, so native and NumPy plans are
// bit-identical by construction.

static inline uint64_t mix64(uint64_t x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

static inline uint64_t row_assign(uint64_t key, int64_t i, uint64_t bound) {
  // splitmix64 stream: state = key + (i+1) * golden ratio; output = mix.
  // Modulo bias < 2^-40 for the reducer counts involved (same argument as
  // rsdl_fill_random_int64).
  return mix64(key + static_cast<uint64_t>(i + 1) * 0x9e3779b97f4a7c15ULL)
         % bound;
}

int rsdl_plan_partition(int64_t n, int64_t num_reducers, uint64_t key,
                        int64_t* out_indices, int64_t* out_offsets,
                        int nthreads) {
  if (num_reducers < 1 || n < 0) return -1;
  if (nthreads < 1) nthreads = 1;
  if (n < (1 << 16)) nthreads = 1;  // below this the spawn cost dominates
  const uint64_t bound = static_cast<uint64_t>(num_reducers);
  std::vector<uint32_t> assign(static_cast<size_t>(n));
  // counts[chunk][reducer], chunk-major so the prefix walk below is cheap.
  std::vector<std::vector<int64_t>> counts(
      nthreads, std::vector<int64_t>(num_reducers, 0));
  auto count_work = [&](int t) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    auto& local = counts[t];
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t r = static_cast<uint32_t>(row_assign(key, i, bound));
      assign[i] = r;
      local[r]++;
    }
  };
  if (nthreads == 1) {
    count_work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(count_work, t);
    for (auto& th : threads) th.join();
  }
  out_offsets[0] = 0;
  for (int64_t r = 0; r < num_reducers; ++r) {
    int64_t total = 0;
    for (int t = 0; t < nthreads; ++t) total += counts[t][r];
    out_offsets[r + 1] = out_offsets[r] + total;
  }
  // cursor[chunk][reducer]: where chunk t's first row for reducer r lands —
  // reducer start + rows earlier chunks contribute to r. Earlier chunks
  // hold smaller row indices, so within a reducer the output stays in
  // original row order (stability, same contract as rsdl_partition_indices).
  std::vector<std::vector<int64_t>> cursor(
      nthreads, std::vector<int64_t>(num_reducers, 0));
  for (int64_t r = 0; r < num_reducers; ++r) {
    int64_t at = out_offsets[r];
    for (int t = 0; t < nthreads; ++t) {
      cursor[t][r] = at;
      at += counts[t][r];
    }
  }
  auto place_work = [&](int t) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    auto& local = cursor[t];
    for (int64_t i = lo; i < hi; ++i)
      out_indices[local[assign[i]]++] = i;
  };
  if (nthreads == 1) {
    place_work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(place_work, t);
    for (auto& th : threads) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Streaming map pipeline: counts-only plan + per-batch destination assign
// ---------------------------------------------------------------------------
//
// The fused decode->partition->gather map path streams Parquet record
// batches straight into per-reducer output buffers, so it needs the plan in
// two pieces instead of one:
//
//   1. rsdl_partition_counts — per-reducer row counts for the WHOLE file,
//      computed from the hash stream alone (no data, no index array): the
//      assignment is counter-based, so the counts are known before the
//      first batch is decoded. This sizes the per-reducer output regions.
//   2. rsdl_assign_dest — for one record batch starting at global row
//      `row0`, emit each row's destination slot (cursor[r]++ over the
//      running per-reducer cursors). Rows are visited in increasing global
//      row order, so every reducer's region fills in original row order —
//      the same stable order rsdl_plan_partition's counting sort produces,
//      which is what makes the streamed output bit-identical to the legacy
//      plan-then-gather path.
//
// Both use row_assign() above, i.e. the exact (seed, epoch, file) hash
// stream of rsdl_plan_partition and the NumPy hash_assign fallback.

int rsdl_partition_counts(int64_t n, int64_t num_reducers, uint64_t key,
                          int64_t row0, int64_t* out_counts, int nthreads) {
  if (num_reducers < 1 || n < 0 || row0 < 0) return -1;
  if (nthreads < 1) nthreads = 1;
  if (n < (1 << 16)) nthreads = 1;
  const uint64_t bound = static_cast<uint64_t>(num_reducers);
  std::vector<std::vector<int64_t>> counts(
      nthreads, std::vector<int64_t>(num_reducers, 0));
  auto work = [&](int t) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    auto& local = counts[t];
    for (int64_t i = lo; i < hi; ++i)
      local[row_assign(key, row0 + i, bound)]++;
  };
  if (nthreads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (int64_t r = 0; r < num_reducers; ++r) {
    int64_t total = 0;
    for (int t = 0; t < nthreads; ++t) total += counts[t][r];
    out_counts[r] = total;
  }
  return 0;
}

// Serial on purpose: the cursors advance in strict row order (stability),
// and a record batch is ~64K rows — at ~1.5 ns/row the loop is far below
// the decode cost it overlaps with. Returns -1 when a destination slot
// exceeds int32 range (caller falls back to the 64-bit NumPy path).
int rsdl_assign_dest(int64_t n, int64_t num_reducers, uint64_t key,
                     int64_t row0, int64_t* cursors, int32_t* out_dest) {
  if (num_reducers < 1 || n < 0 || row0 < 0) return -1;
  const uint64_t bound = static_cast<uint64_t>(num_reducers);
  for (int64_t i = 0; i < n; ++i) {
    uint64_t r = row_assign(key, row0 + i, bound);
    int64_t d = cursors[r]++;
    if (d > INT32_MAX) return -1;
    out_dest[i] = static_cast<int32_t>(d);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CRC32 (zlib polynomial)
// ---------------------------------------------------------------------------
//
// zlib.crc32-compatible checksum: reflected ISO-HDLC polynomial 0xEDB88320.
// The x86 SSE4.2 `crc32` instruction computes CRC-32C (Castagnoli,
// 0x82F63B78) and can NOT produce zlib-compatible output, so on x86 the
// fast path is slice-by-8 tables (~8 table lookups per 8 bytes, multi-GB/s,
// several times zlib's Python-call throughput once the ctypes call runs
// without the GIL). ARMv8's __crc32* intrinsics implement the zlib
// polynomial directly and are used when the compiler advertises them.

#if !defined(__ARM_FEATURE_CRC32)
namespace {

struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int j = 1; j < 8; ++j)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};

const Crc32Tables g_crc;  // 8 KiB, built once at load

}  // namespace
#endif

uint32_t rsdl_crc32(const void* data, int64_t n, uint32_t init) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint32_t c = ~init;
#if defined(__ARM_FEATURE_CRC32)
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = __crc32d(c, v);
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = __crc32b(c, *p++);
#else
  // Slice-by-8: two 32-bit little-endian loads per iteration (x86/ARM are
  // both little-endian; the byte-at-a-time tail is endian-agnostic).
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    c ^= lo;
    c = g_crc.t[7][c & 0xFF] ^ g_crc.t[6][(c >> 8) & 0xFF] ^
        g_crc.t[5][(c >> 16) & 0xFF] ^ g_crc.t[4][c >> 24] ^
        g_crc.t[3][hi & 0xFF] ^ g_crc.t[2][(hi >> 8) & 0xFF] ^
        g_crc.t[1][(hi >> 16) & 0xFF] ^ g_crc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = g_crc.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
#endif
  return ~c;
}

// ---------------------------------------------------------------------------
// Fused scatter-gather: out[dest[i]] = src[idx[i]]
// ---------------------------------------------------------------------------

// The reduce stage's permute is the shuffle's hottest loop. NumPy evaluates
// out[dest] = src[idx] as a gather into a temporary followed by a scatter
// (two memory passes + an allocation); this kernel is the single fused pass.
// idx == nullptr means "src is already in order" (out[dest[i]] = src[i]).
// dest entries must be unique (they are a slice of a permutation), so
// threads writing disjoint i-ranges never race.
}  // extern "C" (template helper below needs C++ linkage)

template <typename T>
static void scatter_gather_typed(const T* src, const int32_t* idx,
                                 const int32_t* dest, T* out, int64_t n,
                                 int nthreads) {
  auto work = [&](int64_t lo, int64_t hi) {
    if (idx == nullptr) {
      for (int64_t i = lo; i < hi; ++i) out[dest[i]] = src[i];
    } else {
      for (int64_t i = lo; i < hi; ++i) out[dest[i]] = src[idx[i]];
    }
  };
  if (nthreads <= 1 || n < (1 << 16)) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back(work, n * t / nthreads, n * (t + 1) / nthreads);
  for (auto& th : threads) th.join();
}

extern "C" {

// elem_size must be 1, 2, 4, or 8; returns -1 otherwise, 0 on success.
int rsdl_scatter_gather(const void* src, const int32_t* idx,
                        const int32_t* dest, void* out, int64_t n,
                        int32_t elem_size, int nthreads) {
  switch (elem_size) {
    case 1:
      scatter_gather_typed(static_cast<const uint8_t*>(src), idx, dest,
                           static_cast<uint8_t*>(out), n, nthreads);
      return 0;
    case 2:
      scatter_gather_typed(static_cast<const uint16_t*>(src), idx, dest,
                           static_cast<uint16_t*>(out), n, nthreads);
      return 0;
    case 4:
      scatter_gather_typed(static_cast<const uint32_t*>(src), idx, dest,
                           static_cast<uint32_t*>(out), n, nthreads);
      return 0;
    case 8:
      scatter_gather_typed(static_cast<const uint64_t*>(src), idx, dest,
                           static_cast<uint64_t*>(out), n, nthreads);
      return 0;
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// Threaded random fill (xoshiro256**) for synthetic data generation
// ---------------------------------------------------------------------------

static inline uint64_t rotl(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

struct Xoshiro256 {
  uint64_t s[4];
  explicit Xoshiro256(uint64_t seed) {
    // splitmix64 seeding
    uint64_t z = seed;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  inline uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
};

// Fill out[0..n) with uniform int64 in [0, bound) using nthreads threads.
// bound must be >= 1 (validated by the Python wrapper; guarded here too).
void rsdl_fill_random_int64(int64_t* out, int64_t n, int64_t bound,
                            uint64_t seed, int nthreads) {
  if (bound < 1) bound = 1;
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int t) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    Xoshiro256 rng(seed * 0x100000001b3ULL + t + 1);
    // Rejection-free modulo is fine for data generation (bias < 2^-40 for
    // the cardinalities involved).
    for (int64_t i = lo; i < hi; ++i)
      out[i] = static_cast<int64_t>(rng.next() % static_cast<uint64_t>(bound));
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// Fill out[0..n) with uniform doubles in [0, 1).
void rsdl_fill_random_double(double* out, int64_t n, uint64_t seed,
                             int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto work = [&](int t) {
    int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    Xoshiro256 rng(seed * 0x9e3779b97f4a7c15ULL + t + 1);
    for (int64_t i = lo; i < hi; ++i)
      out[i] = (rng.next() >> 11) * 0x1.0p-53;
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Ref-counted host buffer pool
// ---------------------------------------------------------------------------

namespace {

struct Buffer {
  void* data;
  int64_t size;        // bytes requested (what the ledger accounts)
  int64_t alloc_size;  // bytes actually reserved (the size class; 0 for
                       // register()-only entries with no memory)
  std::atomic<int64_t> refcount;
  Buffer(void* d, int64_t s, int64_t a)
      : data(d), size(s), alloc_size(a), refcount(1) {}
};

std::mutex g_pool_mutex;
std::unordered_map<int64_t, Buffer*> g_pool;
int64_t g_next_id = 1;
std::atomic<int64_t> g_bytes_in_use{0};

// Free list: released allocations cached for reuse (plasma-style
// recycling). Steady-state transport recvs allocate similar sizes over and
// over; reusing warm pages skips both mmap and the first-touch page faults
// of a fresh block. Blocks are reserved in power-of-two size classes so
// near-miss sizes still recycle, and insertion over the cap evicts the
// oldest blocks of the fattest class so a burst of stale sizes cannot pin
// the cache forever.
std::unordered_map<int64_t, std::vector<void*>> g_freelist;  // class -> LIFO
int64_t g_freelist_bytes = 0;  // sum of class bytes cached
int64_t g_freelist_cap = 256LL << 20;

int64_t size_class(int64_t size) {
  int64_t c = 4096;
  while (c < size) c <<= 1;  // callers guard size <= 2^62, so no overflow
  return c;
}

// Move whole classes out of the free list until it is under the cap,
// fattest class first. Caller holds g_pool_mutex and frees the returned
// blocks AFTER releasing it (eviction is O(evicted blocks); the scan per
// round touches only the ~30 possible size classes).
std::vector<void*> freelist_evict_until_under_cap() {
  std::vector<void*> evicted;
  while (g_freelist_bytes > g_freelist_cap && !g_freelist.empty()) {
    auto fattest = g_freelist.begin();
    int64_t fattest_bytes = -1;
    for (auto it = g_freelist.begin(); it != g_freelist.end(); ++it) {
      int64_t bytes = it->first * static_cast<int64_t>(it->second.size());
      if (bytes > fattest_bytes) {
        fattest = it;
        fattest_bytes = bytes;
      }
    }
    g_freelist_bytes -= fattest_bytes;
    evicted.insert(evicted.end(), fattest->second.begin(),
                   fattest->second.end());
    g_freelist.erase(fattest);
  }
  return evicted;
}

}  // namespace

// Allocate a 64-byte-aligned buffer; returns an id (0 on failure or
// negative size).
int64_t rsdl_buffer_alloc(int64_t size) {
  // Upper bound guards size_class against shift overflow; a corrupt wire
  // length lands here, so it must fail cleanly, not spin.
  if (size < 0 || size > (1LL << 62)) return 0;
  int64_t cls = size_class(size);
  void* data = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    auto it = g_freelist.find(cls);
    if (it != g_freelist.end() && !it->second.empty()) {
      data = it->second.back();  // LIFO: warmest pages first
      it->second.pop_back();
      g_freelist_bytes -= cls;
      if (it->second.empty()) g_freelist.erase(it);
    }
  }
  if (data == nullptr &&
      posix_memalign(&data, 64, static_cast<size_t>(cls)) != 0)
    return 0;
  auto* buf = new Buffer(data, size, cls);
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  int64_t id = g_next_id++;
  g_pool[id] = buf;
  // Charge the RESERVED bytes (the class) so the budget/spill machinery
  // sees real RSS, not the up-to-2x-smaller requested size.
  g_bytes_in_use.fetch_add(cls);
  return id;
}

// Ledger-only entry: account `size` bytes owned by an EXTERNAL allocator
// (Arrow tables, fsspec buffers) under the pool's refcount lifetime without
// allocating. data() reports nullptr for these; decref at zero only drops
// the ledger entry. This is how the Python layer makes pipeline-wide memory
// (cache + in-flight reducer outputs + transport buffers) observable
// through one counter, plasma-store style.
int64_t rsdl_buffer_register(int64_t size) {
  if (size < 0) return 0;
  auto* buf = new Buffer(nullptr, size, 0);
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  int64_t id = g_next_id++;
  g_pool[id] = buf;
  g_bytes_in_use.fetch_add(size);
  return id;
}

void* rsdl_buffer_data(int64_t id) {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  auto it = g_pool.find(id);
  return it == g_pool.end() ? nullptr : it->second->data;
}

int64_t rsdl_buffer_size(int64_t id) {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  auto it = g_pool.find(id);
  return it == g_pool.end() ? -1 : it->second->size;
}

// Increment refcount; returns new count or -1 if unknown id.
int64_t rsdl_buffer_incref(int64_t id) {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  auto it = g_pool.find(id);
  if (it == g_pool.end()) return -1;
  return it->second->refcount.fetch_add(1) + 1;
}

// Decrement refcount; at zero the block moves to the free list (or is
// freed). Returns new count or -1 if unknown id. One mutex acquisition per
// call; evicted blocks are freed after the lock is released.
int64_t rsdl_buffer_decref(int64_t id) {
  Buffer* to_free = nullptr;
  std::vector<void*> evicted;
  int64_t count;
  {
    std::lock_guard<std::mutex> lock(g_pool_mutex);
    auto it = g_pool.find(id);
    if (it == g_pool.end()) return -1;
    count = it->second->refcount.fetch_sub(1) - 1;
    if (count == 0) {
      to_free = it->second;
      g_pool.erase(it);
      // Symmetric with alloc/register: alloc entries were charged their
      // reserved class bytes, register entries their declared size.
      g_bytes_in_use.fetch_sub(
          to_free->alloc_size > 0 ? to_free->alloc_size : to_free->size);
      if (to_free->data != nullptr && to_free->alloc_size > 0) {
        g_freelist[to_free->alloc_size].push_back(to_free->data);
        g_freelist_bytes += to_free->alloc_size;
        to_free->data = nullptr;  // ownership moved to the free list
        evicted = freelist_evict_until_under_cap();
      }
    }
  }
  for (void* p : evicted) free(p);
  if (to_free != nullptr) {
    free(to_free->data);  // nullptr when the block was cached above
    delete to_free;
  }
  return count;
}

// Drop every cached free-list block (testing / memory-pressure hook).
void rsdl_buffer_trim_freelist() {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  for (auto& entry : g_freelist)
    for (void* p : entry.second) free(p);
  g_freelist.clear();
  g_freelist_bytes = 0;
}

int64_t rsdl_buffer_freelist_bytes() {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  return g_freelist_bytes;
}

// ---------------------------------------------------------------------------
// Transport data pump (DCN plane)
// ---------------------------------------------------------------------------
//
// The Python transport's per-message cost is dominated by GIL round-trips:
// two sendall() calls per frame and one recv_into() per ~MB of payload.
// These two entry points move a whole frame per C call — ctypes releases
// the GIL for the duration, so multi-MB sends/receives run entirely
// outside the interpreter (plasma's raylet-to-raylet object transfer role,
// SURVEY.md §2.3).

// Write header then payload as one scatter-gather stream (writev), looping
// on partial writes and EINTR. Returns 0 on success, -errno on error.
int rsdl_frame_send(int fd, const void* header, int64_t hlen,
                    const void* payload, int64_t plen) {
  struct iovec iov[2];
  iov[0].iov_base = const_cast<void*>(header);
  iov[0].iov_len = static_cast<size_t>(hlen);
  iov[1].iov_base = const_cast<void*>(payload);
  iov[1].iov_len = static_cast<size_t>(plen);
  int iov_idx = 0;
  while (iov_idx < 2) {
    ssize_t wrote = writev(fd, &iov[iov_idx], 2 - iov_idx);
    if (wrote < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    size_t w = static_cast<size_t>(wrote);
    while (iov_idx < 2 && w >= iov[iov_idx].iov_len) {
      w -= iov[iov_idx].iov_len;
      ++iov_idx;
    }
    if (iov_idx < 2 && w > 0) {
      iov[iov_idx].iov_base = static_cast<char*>(iov[iov_idx].iov_base) + w;
      iov[iov_idx].iov_len -= w;
    }
  }
  return 0;
}

// Sentinel for EOF after a partial read. Deliberately far outside the
// errno range (errnos are small positive ints) so a genuine EPIPE errno
// returned by read() stays distinguishable from a clean peer close
// mid-frame.
const int64_t RSDL_EEOF_MID_MESSAGE = 1000000;

// Read exactly n bytes into dst. Returns n on success, 0 on clean EOF
// before the first byte, -RSDL_EEOF_MID_MESSAGE on EOF mid-read,
// -errno on error.
int64_t rsdl_read_exact(int fd, void* dst, int64_t n) {
  int64_t got = 0;
  while (got < n) {
    ssize_t r = read(fd, static_cast<char*>(dst) + got,
                     static_cast<size_t>(n - got));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return got == 0 ? 0 : -RSDL_EEOF_MID_MESSAGE;
    got += r;
  }
  return got;
}

int64_t rsdl_buffer_bytes_in_use() { return g_bytes_in_use.load(); }

int64_t rsdl_buffer_count() {
  std::lock_guard<std::mutex> lock(g_pool_mutex);
  return static_cast<int64_t>(g_pool.size());
}

}  // extern "C"
