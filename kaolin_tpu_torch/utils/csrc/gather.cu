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
// * gather_smem_kernel, for a table of at most 58,110 floats (232,440
//   bytes, 8-byte aligned, beside its 8-byte mbarrier: one block's opt-in
//   shared memory): the counterpart of "the table lives on chip". The grid
//   is whole clusters of kSmemCluster blocks, as many as the indices need,
//   at most kSmemBlocksPerSm blocks an SM and the clusters that fit the
//   card at once (cudaOccupancyMaxActiveClusters), at least one. The table
//   is staged once a cluster, not once a block: each block's thread 0
//   copies its 1/kSmemCluster of the table's whole 16-byte vectors by one
//   bulk copy multicast to every block of the cluster (cp.async.bulk ...
//   .multicast::cluster), and each block's mbarrier expects the whole
//   table's bytes. The last n_tab % 4 floats come by ordinary loads from one
//   thread, which then arrives on the same mbarrier. Every thread issues
//   its first batch of kSmemVecs int4 of indices (streaming loads) before
//   it waits for the table, then walks its groups of 4 indices with a grid
//   stride, issuing each next batch before the shared-memory lookups of
//   the current one; streaming float4 stores; the last n % 4 indices are
//   masked by the thread that owns that group. The hazards: the mbarrier
//   is initialised and its expect-tx posted, then fence.mbarrier_init and a
//   release / acquire cluster barrier, before any block copies into a peer;
//   every block of a cluster takes part in the copies and both cluster
//   barriers, one without indices too; the kernel ends on a cluster
//   barrier (arrived at when the block's table has landed), so no block
//   leaves while a peer's copy into it can be in flight. The first design
//   copied the whole table into every block with 16-byte loads and read
//   no index before that copy was done: 264 blocks x 64 KB = 16.9 MB from
//   L2 at the probe's 2^14 table, twice the gather's own 8.45 MB.
//   Settled on the card (scripts/gather_variants.py --route smem rebuilds
//   the kernel with each choice turned the other way and times it, PERF.md
//   has the numbers): clusters of 4 (without a cluster, plain bulk copies,
//   every block asks L2 for the same lines at once and loses at 2^14
//   floats; clusters of 2 lose, of 8 tie), two blocks of
//   512 threads an SM, two int4 in flight a thread (one loses; four, one
//   block an SM and one 1,024-thread block an SM tie or lose at 2^14 and
//   win by about 5% only on the largest tables, where one block an SM
//   fits and a cluster of 4 can leave SMs idle), streaming index loads
//   and stores (__ldg and plain stores tie).
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
// Left out of the shared-memory route: a table split across a cluster's
// blocks and read through distributed shared memory (it would raise the
// size limit C-fold, but (C - 1) / C of the lookups would be remote reads
// across the SM-to-SM network); the tensor form of TMA (a 1-D table needs
// no tensor map).
//
// The wrapper passes 16-byte-aligned table, index and output pointers.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kL2Threads = 256;

__device__ __forceinline__ int wrap_clamp(int i, int n) {
  i = i < 0 ? i + n : i;
  return min(max(i, 0), n - 1);
}

// --- PTX: mbarriers, bulk copies, clusters ---------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// they expect).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
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

// The same copy into this offset of every block of the cluster named in
// `mask`, completing on each one's mbarrier at `bar`'s offset.
__device__ __forceinline__ void bulk_copy_multicast(void* dst, const void* src,
                                                    uint32_t bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

// An arrival that publishes nothing: what it signals (this block's table
// has landed) the mbarrier has already ordered.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

constexpr int kSmemCluster = 4;      // blocks a cluster, staging one table
constexpr int kSmemBlocksPerSm = 2;  // at most
constexpr int kSmemThreads = 512;
constexpr int kSmemVecs = 2;     // int4 of indices a batch, a thread
constexpr int kTailThread = 32;  // loads the table's last n_tab % 4 floats
static_assert(kTailThread < kSmemThreads, "the tail thread is in the block");
static_assert(kSmemCluster == 1 || kSmemCluster == 2 || kSmemCluster == 4 ||
                  kSmemCluster == 8,
              "a portable cluster size");

// The byte offset of the mbarrier behind a table of n_tab floats.
__host__ __device__ constexpr int smem_bar_offset(int n_tab) {
  return (4 * n_tab + 7) / 8 * 8;
}

// Issue the loads of a thread's batch of groups of 4 indices g0 + k stride,
// k < kSmemVecs: a whole group as one int4, the last, partial group by
// scalar loads (0 past the count); groups past the end are left alone.
__device__ __forceinline__ void load_batch(const int* __restrict__ idx,
                                           long long n, long long g0,
                                           long long stride,
                                           int4 (&q)[kSmemVecs]) {
#pragma unroll
  for (int k = 0; k < kSmemVecs; ++k) {
    const long long b = 4 * (g0 + k * stride);
    if (b + 4 <= n) {
      q[k] = __ldcs(reinterpret_cast<const int4*>(idx + b));
    } else if (b < n) {
      q[k] = make_int4(__ldcs(idx + b), b + 1 < n ? __ldcs(idx + b + 1) : 0,
                       b + 2 < n ? __ldcs(idx + b + 2) : 0, 0);
    }
  }
}

// The batch's values from the table in shared memory, stored streaming.
__device__ __forceinline__ void store_batch(const float* s_tab, int n_tab,
                                            float* __restrict__ out,
                                            long long n, long long g0,
                                            long long stride,
                                            const int4 (&q)[kSmemVecs]) {
#pragma unroll
  for (int k = 0; k < kSmemVecs; ++k) {
    const long long b = 4 * (g0 + k * stride);
    const float4 v = make_float4(
        s_tab[wrap_clamp(q[k].x, n_tab)], s_tab[wrap_clamp(q[k].y, n_tab)],
        s_tab[wrap_clamp(q[k].z, n_tab)], s_tab[wrap_clamp(q[k].w, n_tab)]);
    if (b + 4 <= n) {
      __stcs(reinterpret_cast<float4*>(out + b), v);
    } else if (b < n) {
      __stcs(out + b, v.x);
      if (b + 1 < n) __stcs(out + b + 1, v.y);
      if (b + 2 < n) __stcs(out + b + 2, v.z);
    }
  }
}

__global__ void __launch_bounds__(kSmemThreads, kSmemBlocksPerSm)
gather_smem_kernel(const float* __restrict__ table,  // (n_tab,)
                   const int* __restrict__ idx,      // (n,)
                   float* __restrict__ out,          // (n,)
                   int n_tab, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tab = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + smem_bar_offset(n_tab));
  const int n_vec = n_tab / 4;
  const int tail = n_tab - 4 * n_vec;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    // thread 0's arrival expects every block's slice; the tail thread's
    // arrival publishes the tail
    mbar_init(bar, tail ? 2 : 1);
    mbar_expect_tx(bar, 16u * static_cast<uint32_t>(n_vec));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_release();
  // the first batch of indices is in flight while the table lands
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long g0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                 threadIdx.x;
  int4 q[kSmemVecs] = {};
  load_batch(idx, n, g0, stride, q);
  cluster_wait_acquire();  // every block's mbarrier is initialised

  if (threadIdx.x == 0) {
    // this block's run of the table's whole 16-byte vectors
    const int per = (n_vec + kSmemCluster - 1) / kSmemCluster;
    const int v0 = static_cast<int>(rank) * per;
    const int v1 = min(n_vec, v0 + per);
    if (v1 > v0) {
      const uint32_t bytes = 16u * static_cast<uint32_t>(v1 - v0);
      bulk_copy_multicast(s_tab + 4 * v0, table + 4 * v0, bytes, bar,
                          (1u << kSmemCluster) - 1);
    }
  }
  if (tail && threadIdx.x == kTailThread) {
    for (int r = 0; r < tail; ++r) {
      s_tab[4 * n_vec + r] = __ldg(table + 4 * n_vec + r);
    }
    mbar_arrive(bar);
  }
  mbar_wait(bar, 0);
  cluster_arrive_relaxed();  // this block's table has landed

  for (; g0 < groups; g0 += kSmemVecs * stride) {
    const long long g1 = g0 + kSmemVecs * stride;
    int4 next[kSmemVecs] = {};
    if (g1 < groups) load_batch(idx, n, g1, stride, next);
    store_batch(s_tab, n_tab, out, n, g0, stride, q);
#pragma unroll
    for (int k = 0; k < kSmemVecs; ++k) q[k] = next[k];
  }
  // every block of the cluster has its table: no copy into this block, or
  // from it into a peer, is still in flight
  cluster_wait_acquire();
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
    for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[s], 1);
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

namespace {

constexpr int kSmemMaxBytes = 232448;  // one block's opt-in shared memory

// The clusters of cfg that device `dev` holds at once. The query takes
// tens of µs of host time, so its answer is kept for each device and
// shared-memory size.
cudaError_t active_clusters(int dev, const cudaLaunchConfig_t* cfg,
                            int* active) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> known;
  const std::pair<int, size_t> key(dev, cfg->dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(key);
  if (it != known.end()) {
    *active = it->second;
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(active, gather_smem_kernel, cfg);
  if (err == cudaSuccess) known[key] = *active;
  return err;
}

// The shared-memory route's launch for a table of n_tab floats and n
// indices: clusters of kSmemCluster blocks, as many as the groups of 4
// indices need at kSmemVecs int4 a thread, at most kSmemBlocksPerSm blocks
// an SM and the clusters the card holds at once, and at least one cluster
// (whose blocks past the first may get no index). A table too large for a
// block's shared memory beside its mbarrier is an error, as is a card that
// holds no such cluster (cudaErrorInvalidConfiguration).
cudaError_t smem_launch(int n_tab, long long n, cudaStream_t stream,
                        cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  if (n_tab < 1 || n_tab > (kSmemMaxBytes - 8) / 4) {
    return cudaErrorInvalidValue;
  }
  const int smem = smem_bar_offset(n_tab) + 8;
  int dev = 0, sms = 0, active = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           gather_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           smem)) != cudaSuccess ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSmemCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(kSmemCluster);
  cfg->blockDim = dim3(kSmemThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(smem);
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  if ((err = active_clusters(dev, cfg, &active)) != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  const long long groups = (n + 3) / 4;
  const long long per_block = static_cast<long long>(kSmemThreads) * kSmemVecs;
  const long long need = (groups + per_block - 1) / per_block;
  const long long cap = std::max(
      1, std::min(active, sms * kSmemBlocksPerSm / kSmemCluster));
  const long long clusters = std::max(
      1LL, std::min(cap, (need + kSmemCluster - 1) / kSmemCluster));
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * kSmemCluster));
  return cudaSuccess;
}

}  // namespace

// The launch kaolin_gather_smem makes for a table of n_tab floats and n
// indices on the current device → *cluster blocks a cluster, *blocks in
// the grid, *threads a block; an error for what it would refuse.
extern "C" int kaolin_gather_smem_grid(int n_tab, long long n, int* cluster,
                                       int* blocks, int* threads) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  const cudaError_t err = smem_launch(n_tab, n, nullptr, &attr, &cfg);
  if (err == cudaSuccess) {
    *cluster = kSmemCluster;
    *blocks = static_cast<int>(cfg.gridDim.x);
    *threads = kSmemThreads;
  }
  return static_cast<int>(err);
}

// A refused size or cluster launch comes back as the error status.
extern "C" int kaolin_gather_smem(const void* table, const void* idx,
                                  void* out, int n_tab, long long n,
                                  void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = smem_launch(n_tab, n, static_cast<cudaStream_t>(stream),
                                &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&cfg, gather_smem_kernel,
                           static_cast<const float*>(table),
                           static_cast<const int*>(idx),
                           static_cast<float*>(out), n_tab, n);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
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
