// Table gather out = table[idx] for Hopper (sm_90a), two routes.
//
// Replaces the Pallas TPU kernel kaolin_tpu/utils/primitives_bench.py
// (gather_kernel, the primitive-cost probe's "can a kernel fetch from a table
// held on chip at vector rate?"). There the whole (2^20,) float32 table sits
// in VMEM and (512, 128) blocks of int32 indices stream past it.
//
// Semantics, those of jax.jit(lambda t, i: t[i]) and of the plain version
// cuda_gather.table_gather_plain: a negative index wraps once (i + n), then
// every index is clamped to [0, n - 1], so no read leaves the table.
//
// What bounds it on this card: bytes. Each element reads a 4-byte index and
// writes a 4-byte value, 8 bytes of device memory, and the table is read
// once; there is no arithmetic to speak of. A Hopper block has at most
// 227 KB of shared memory (232,448 bytes), so the TPU's 4 MB table cannot be
// held by one block, nor by a 16-block cluster (about 3.6 MB). Hence:
//
// * gather_smem_kernel, for a table of at most 58,112 floats: the counterpart
//   of "the table lives on chip". A persistent grid of one or two blocks per
//   SM; each block stages the whole table in dynamic shared memory once with
//   16-byte loads, then walks the index array with a grid stride: one int4 of
//   indices, four shared-memory reads, one float4 store; the last n % 4
//   indices by one thread. Device memory then sees only the 8 bytes per
//   element (plus the table once per block, from L2 after the first block).
// * gather_l2_kernel, for any other table: the table stays in device memory
//   and L2 (50 MB) serves the random reads. The first design (one
//   thread per 4 indices, one wave of 262,144 threads, __ldg) ran as one
//   chain of latencies: every index load, then every table read, each a
//   random 32-byte sector miss to HBM when cold, then every store. This
//   design:
//   - a persistent grid of two 256-thread blocks per SM walks tiles of
//     1,024 indices (4 KB) with a grid stride;
//   - each block reads its first tile straight from device memory, so its
//     table reads start at once, while its later tiles arrive through a
//     ring of 2 shared-memory slots by 1-D bulk copies (cp.async.bulk,
//     global -> shared, L2 evict-first), issued by one thread and
//     completed on one mbarrier a slot;
//   - at the start each block asks L2 to prefetch its 1/gridDim slice of
//     the table (cp.async.bulk.prefetch.L2), so the table comes from HBM as
//     one stream and not as random sector misses; only when the table is at
//     most 24 MB (half of L2) and there are at least n_tab / 8 indices (a
//     random draw then touches most of the table's 32-byte sectors);
//   - a thread holds two tiles' table reads in flight, 8 in all: it issues
//     tile k + 1's 4 reads before it stores tile k's values (streaming,
//     evict-first float4 stores). The reads carry an L2 evict-last policy
//     when the table was prefetched, evict-normal otherwise;
//   - a tile's indices past its last multiple of 4 (the bulk copy moves
//     whole 16-byte vectors) are read from device memory by the threads
//     that own them, and positions past the count are masked: no tail is
//     left to one thread.
//   Settled on the card (scripts/gather_variants.py times each choice
//   against its alternative, PERF.md has the numbers): the table reads
//   allocate in L1, which serves tables of up to a few hundred KB;
//   L1::no_allocate, four ring slots, 2,048-index tiles, four blocks an SM
//   and an evict-normal hint on the prefetched table each lost.
//   What bounds it is not the 12.6 MB of HBM traffic in the bound: each
//   random 4-byte read costs one L2 sector request (2^20 of them, 33.5 MB
//   of sector traffic at the probe's shape), and every design tried, the
//   first one included, reads within a few percent of the others there.
//   Left out: an L2 persistence window (cudaLimitPersistingL2CacheSize is
//   device-wide and would change every other kernel's L2 in the process);
//   sorting or binning the indices (two more passes over 8 MB cost more than
//   they save at 2^20); a cluster holding the table in distributed shared
//   memory (16 x 227 KB = 3.6 MB < 4 MB, and staging it in 8 clusters would
//   read 29 MB from L2).
//
// The wrapper passes 16-byte-aligned table, index and output pointers.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kSmemThreads = 512;
constexpr int kL2Threads = 256;

__device__ __forceinline__ int wrap_clamp(int i, int n) {
  i = i < 0 ? i + n : i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(kSmemThreads)
gather_smem_kernel(const float* __restrict__ table,  // (n_tab,)
                   const int* __restrict__ idx,      // (n,)
                   float* __restrict__ out,          // (n,)
                   int n_tab, long long n) {
  extern __shared__ float4 s_tab4[];
  float* s_tab = reinterpret_cast<float*>(s_tab4);
  const int n_vec = n_tab / 4;
  const float4* table4 = reinterpret_cast<const float4*>(table);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    s_tab4[i] = __ldg(table4 + i);
  }
  for (int i = 4 * n_vec + threadIdx.x; i < n_tab; i += blockDim.x) {
    s_tab[i] = __ldg(table + i);
  }
  __syncthreads();

  const long long groups = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const int4 q = __ldg(idx4 + g);
    out4[g] = make_float4(s_tab[wrap_clamp(q.x, n_tab)],
                          s_tab[wrap_clamp(q.y, n_tab)],
                          s_tab[wrap_clamp(q.z, n_tab)],
                          s_tab[wrap_clamp(q.w, n_tab)]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (long long i = 4 * groups; i < n; ++i) {
      out[i] = s_tab[wrap_clamp(idx[i], n_tab)];
    }
  }
}

// --- the L2 route's PTX: mbarriers, bulk copies, cache policies ----------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// A read-only table read under an L2 cache policy.
__device__ __forceinline__ float ld_table(const float* p, uint64_t policy) {
  float v;
  // volatile: issued where written, ahead of the stores that wait for it
  asm volatile(
      "ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;\n"
      : "=f"(v)
      : "l"(p), "l"(policy));
  return v;
}

constexpr int kL2BlocksPerSm = 2;
constexpr int kTile = 1024;                     // indices a tile (4 KB)
constexpr int kStages = 2;                      // ring slots a block
constexpr int kPerThread = kTile / kL2Threads;  // reads a tile, a thread
constexpr uint32_t kPrefetchChunk = 1u << 16;   // bytes a prefetch
constexpr long long kPrefetchMaxBytes = 24LL << 20;
static_assert(kPerThread % 4 == 0, "a thread takes whole int4s of a tile");
static_assert(kStages >= 2, "a tile is read while the next one lands");

// Issue tile `t` of the index array into ring slot `slot`: its whole 16-byte
// vectors by one bulk copy (none when the tile holds fewer than 4 indices;
// the mbarrier's phase then completes on the arrival alone). One thread.
__device__ __forceinline__ void issue_tile(long long t, int slot,
                                          const int* __restrict__ idx,
                                          long long n, int (*s_idx)[kTile],
                                          uint64_t* s_bar, uint64_t policy) {
  const long long base = t * kTile;
  const int count = static_cast<int>(min(static_cast<long long>(kTile),
                                         n - base));
  const uint32_t bytes = static_cast<uint32_t>(count & ~3) * 4u;
  // the slot's last reads (ordinary loads) come before these async writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(&s_bar[slot], bytes);
  if (bytes > 0) {
    bulk_copy(s_idx[slot], idx + base, bytes, &s_bar[slot], policy);
  }
}

// A tile's indices at this thread's positions 4 (threadIdx.x + q blockDim)
// + r: from the slot where the bulk copy put them, past its last whole
// 16-byte vector from device memory, past the count 0 (never stored).
__device__ __forceinline__ void tile_indices(const int* s_tile,
                                             const int* __restrict__ idx,
                                             long long base, int count,
                                             int (&i)[kPerThread]) {
  const int whole = count & ~3;
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int j = 4 * (threadIdx.x + q * kL2Threads);
    if (j < whole) {
      const int4 w = *reinterpret_cast<const int4*>(s_tile + j);
      i[4 * q] = w.x;
      i[4 * q + 1] = w.y;
      i[4 * q + 2] = w.z;
      i[4 * q + 3] = w.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        i[4 * q + r] = j + r < count ? __ldcs(idx + base + j + r) : 0;
      }
    }
  }
}

__device__ __forceinline__ void tile_store(float* __restrict__ out,
                                           long long base, int count,
                                           const float (&v)[kPerThread]) {
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int j = 4 * (threadIdx.x + q * kL2Threads);
    if (j + 4 <= count) {
      __stcs(reinterpret_cast<float4*>(out + base + j),
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (j + r < count) __stcs(out + base + j + r, v[4 * q + r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kL2Threads, kL2BlocksPerSm)
gather_l2_kernel(const float* __restrict__ table,  // (n_tab,)
                 const int* __restrict__ idx,      // (n,)
                 float* __restrict__ out,          // (n,)
                 int n_tab, long long n, int prefetch) {
  __shared__ alignas(128) int s_idx[kStages][kTile];
  __shared__ alignas(8) uint64_t s_bar[kStages];
  const long long n_tiles = (n + kTile - 1) / kTile;
  // this block's tiles: blockIdx.x + k * gridDim.x, k < mine (the grid
  // holds no more blocks than tiles). Tile 0 is read straight from device
  // memory, so the table reads start at once; tile k >= 1 lands in ring
  // slot k % kStages by bulk copy, slot 0 first taking tile kStages.
  const long long mine =
      (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const uint64_t stream_policy = policy_evict_first();

  if (threadIdx.x == 0) {
    if (prefetch) {
      // this block's slice of the table's whole 16-byte vectors
      const long long vecs = n_tab / 4;
      const long long per = (vecs + gridDim.x - 1) / gridDim.x;
      const long long v1 = min(vecs, (blockIdx.x + 1) * per);
      for (long long v = blockIdx.x * per; v < v1;
           v += kPrefetchChunk / 16) {
        prefetch_l2(table + 4 * v, static_cast<uint32_t>(min(
                                       static_cast<long long>(kPrefetchChunk),
                                       (v1 - v) * 16)));
      }
    }
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long long k = 1; k <= kStages && k < mine; ++k) {
      issue_tile(blockIdx.x + k * gridDim.x, static_cast<int>(k % kStages),
                 idx, n, s_idx, s_bar, stream_policy);
    }
  }

  const uint64_t table_policy =
      prefetch ? policy_evict_last() : policy_evict_normal();
  // Two tiles in flight a thread: tile k + 1's table reads are issued
  // before tile k's values are stored (which waits for them).
  int i[kPerThread];
  float cur[kPerThread], next[kPerThread];
  long long base = static_cast<long long>(blockIdx.x) * kTile;
  int count = static_cast<int>(min(static_cast<long long>(kTile), n - base));
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int j = 4 * (threadIdx.x + q * kL2Threads);
    if (j + 4 <= count) {
      const int4 w = __ldcs(reinterpret_cast<const int4*>(idx + base + j));
      i[4 * q] = w.x;
      i[4 * q + 1] = w.y;
      i[4 * q + 2] = w.z;
      i[4 * q + 3] = w.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        i[4 * q + r] = j + r < count ? __ldcs(idx + base + j + r) : 0;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    cur[e] = ld_table(table + wrap_clamp(i[e], n_tab), table_policy);
  }
  __syncthreads();  // the mbarriers are initialised
  for (long long k = 0; k < mine; ++k) {
    const long long base_next = base + static_cast<long long>(gridDim.x) *
                                           kTile;
    const int count_next = static_cast<int>(
        min(static_cast<long long>(kTile), n - base_next));
    if (k + 1 < mine) {
      const long long kn = k + 1;
      const int slot = static_cast<int>(kn % kStages);
      // slot 0's first phase holds tile kStages
      mbar_wait(&s_bar[slot], static_cast<uint32_t>(
                                  (kn / kStages - (slot == 0)) & 1));
      tile_indices(s_idx[slot], idx, base_next, count_next, i);
#pragma unroll
      for (int e = 0; e < kPerThread; ++e) {
        next[e] = ld_table(table + wrap_clamp(i[e], n_tab), table_policy);
      }
      // every thread has read tile k + 1's indices: its slot takes the
      // block's tile k + 1 + kStages
      __syncthreads();
      if (threadIdx.x == 0 && kn + kStages < mine) {
        issue_tile(blockIdx.x + (kn + kStages) * gridDim.x, slot, idx, n,
                   s_idx, s_bar, stream_policy);
      }
    }
    tile_store(out, base, count, cur);
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) cur[e] = next[e];
    base = base_next;
    count = count_next;
  }
}

}  // namespace

// The table must fit the block's opt-in shared memory (the wrapper checks
// n_tab * 4 <= 232,448); a refused size comes back as the error status.
extern "C" int kaolin_gather_smem(const void* table, const void* idx,
                                  void* out, int n_tab, long long n,
                                  void* stream) {
  const int smem = n_tab * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gather_smem_kernel, kSmemThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // one or two blocks per SM, and no more blocks than groups of 4 need
  const long long need = (n / 4 + kSmemThreads - 1) / kSmemThreads;
  long long blocks =
      static_cast<long long>(sms) * std::min(std::max(per_sm, 1), 2);
  blocks = std::max(1LL, std::min(blocks, need));
  gather_smem_kernel<<<static_cast<unsigned>(blocks), kSmemThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<float*>(out), n_tab, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kaolin_gather_l2(const void* table, const void* idx, void* out,
                                int n_tab, long long n, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // a persistent grid: two blocks per SM, and no more blocks than tiles
  const long long tiles = (n + kTile - 1) / kTile;
  const long long blocks = std::max(
      1LL, std::min(tiles, static_cast<long long>(sms) * kL2BlocksPerSm));
  // prefetch a table that L2 holds with room to spare, when the indices
  // are many enough to touch most of its sectors
  const int prefetch =
      static_cast<long long>(n_tab) * 4 <= kPrefetchMaxBytes &&
      n >= n_tab / 8;
  gather_l2_kernel<<<static_cast<unsigned>(blocks), kL2Threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(idx),
      static_cast<float*>(out), n_tab, n, prefetch);
  return static_cast<int>(cudaGetLastError());
}
