// SPC first-hit raster and its untile relayout for Hopper (sm_90a).
//
// raster_tiles_kernel replaces the Pallas TPU kernel
// kaolin_tpu/render/spc/raster.py::_raster_kernel (driven by _raster_frame).
// Per screen tile: pinhole rays from the camera vector, a per-ray
// scene-exit bound from the occupied level-3 cells, then a front-to-back
// walk of the tile's unit list (from the binning in raster._bin_units),
// slab-testing each ray against the 128 leaves of each unit, keeping the
// nearest entry depth and its point-hierarchy id, and stopping early once no
// pixel of the tile can still change. Its plain version is
// raster.raster_tiles_plain.
//
// untile_kernel replaces raster.py::_untile_kernel (driven by _untile): it
// moves the tile-packed (T, P) depth and id images to row-major (H*W,)
// order. Its plain version is raster.untile_plain.
//
// What bounds the tile kernel on this card: ALU work, one slab test (6
// subtractions, 6 products, 12 min/max and the compares, all float32) per
// (pixel, box) pair the walk needs, and the latency of the 4 KB unit loads
// from device memory. Bytes are few: a unit is read once per tile that
// walks it. Only about a third of the tiles of a frame have units binned,
// so a few hundred blocks carry the work. On config 3 (a level-9 shell at
// 512x512) the warps make 38.7 M leaf tests, a third of what the kernel's
// time could issue: each batch's vote waits for the block's slowest warp,
// and at 62 registers a thread an SM holds one 1,024-thread block.
//
// What the design does about it:
// * One block per tile, kSplit threads per pixel (a quad, 4 consecutive
//   lanes; 1024 threads at 16-px tiles). Each lane of a quad tests every
//   fourth group of 4 leaves (32 of a unit's 128) and the level-3 boxes
//   likewise; two xor-shuffles combine the quad with the rule of the plain
//   version (least entry depth, then lowest id; the maximum exit for the
//   bound), which is a total order, so the result does not depend on the
//   split. A busy tile gets four times the threads and each unit a quarter
//   of the serial chain: on config 3 on an H100 the kernel took 0.176 ms
//   against 0.26 ms with one thread a pixel. A tile with no unit binned
//   writes the background and returns at once, which takes the place of
//   the TPU path's active-tile compaction.
// * A per-warp unit cull. Before a unit's leaves, each lane slab-tests its
//   ray against the unit's tight box (RasterSPC.uaabb) with the same slab()
//   op for op; the warp (8 pixels) skips the unit's leaves when no lane's
//   ray enters that box nearer than its best so far. This is exact: the
//   box's lo and hi are the float32 minimum and maximum of its live leaves'
//   own lo and hi, and float subtraction and multiplication round
//   monotonically, so per axis a live leaf's slab interval lies inside the
//   box's, its t_in is at least the box's and its t_out at most the box's.
//   A live leaf that hits with t_in < best therefore makes its lane pass
//   the box test with the box's t_in <= the leaf's < best. Dead lanes
//   (lo = hi = 3e38 on every axis) lie outside the box but never change a
//   result: with a ray origin far below 1e31, (3e38 - o) rounds to 3e38,
//   so a dead lane's three axis values are fl(3e38 * inv_k); a hit needs
//   t_out = min >= max = t_in, so the three are equal and not negative. A
//   finite one needs |inv_k| < 3.41e38 / 3e38 < 1.14, so |d_k| > 0.88 on
//   all three axes, which no unit direction has: the three are +inf, and
//   t_in = +inf is never below any best (<= 3e38).
//   So the values of best, and with them the early-stop slot, are those of
//   the walk without the cull: depths stay bitwise equal to the plain
//   version and ids equal.
// * Units arrive through a ring of two batches of up to 4 units in shared
//   memory, each unit one 4 KB cp.async.bulk (the bulk copy engine, no
//   tensor map needed for a contiguous block) plus its 32-byte box, issued
//   by one thread and completed on the batch's mbarrier: while the block
//   tests batch k, batch k + 1 is in flight. This is the TPU kernel's
//   two-batch DMA ring. The bulk copy was taken over 16-byte cp.async
//   because one thread issues a whole unit and no register of the testing
//   threads is spent on the copy. Before a block returns, every copy it
//   issued has landed, also after an early stop (the TPU kernel drains its
//   ring for the same reason): its shared memory may not be handed to the
//   next block while a copy still writes to it.
// * Leaves are read as float4 from shared memory: 7 vector loads (6
//   coordinate rows and the id row) per 4 leaves, all lanes of a warp on
//   at most 4 neighbouring addresses. The level-3 boxes (at most 512) are
//   staged once and read 4 at a time the same way.
// * After each batch one vote, __syncthreads_and(min(best, bound) < z_lb),
//   stops the tile once every pixel is nearer than the next batch's depth
//   lower bound: the rule of the plain version, so both stop at the same
//   slot. The vote is also the barrier after which the freed ring slot is
//   refilled.
// * The rays and the slab test repeat the plain version op for op with
//   round-to-nearest intrinsics (and the library is built with
//   --fmad=false, no fast math), so depths match it bit for bit. Within a
//   unit ties go to the lowest id; across units only a strictly nearer hit
//   replaces the best, so the unit walked first wins.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kIntBig = 1 << 30;
constexpr int kLanes = 128;                 // leaves per unit
constexpr int kGroups = kLanes / 4;         // float4 groups of leaves per row
constexpr int kUnitFloats = 8 * kLanes;     // one unit, 4 KB
constexpr int kUnitVecs = kUnitFloats / 4;  // as float4
constexpr int kUnitBytes = kUnitFloats * 4;
constexpr int kBoxBytes = 32;               // one uaabb row
constexpr int kSplit = 4;                   // threads per pixel
constexpr unsigned kFullWarp = 0xffffffffu;

struct Ray {
  float ox, oy, oz;  // origin
  float ix, iy, iz;  // inverse direction
};

// The ray through the centre of pixel (row, col), op for op as
// raster._rays. cam: R row-major, t, tan_h, tan_v, x0, y0 and the ray origin,
// which raster._camera_vector computes once per frame.
__device__ Ray pixel_ray(const float* __restrict__ cam, int row, int col,
                         float width, float height) {
  const float tan_h = cam[12], tan_v = cam[13], x0 = cam[14], y0 = cam[15];
  float pix_x = __fadd_rn(static_cast<float>(col), 0.5f);
  float pix_y = __fadd_rn(static_cast<float>(row), 0.5f);
  pix_x = __fsub_rn(pix_x, x0);
  pix_y = __fadd_rn(pix_y, y0);
  const float ndc_x = __fsub_rn(__fmul_rn(2.f, __fdiv_rn(pix_x, width)), 1.f);
  const float ndc_y = __fsub_rn(__fmul_rn(2.f, __fdiv_rn(pix_y, height)), 1.f);
  const float dcx = __fmul_rn(ndc_x, tan_h);
  const float dcy = __fmul_rn(-ndc_y, tan_v);
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = __fadd_rn(__fadd_rn(__fmul_rn(cam[k], dcx), __fmul_rn(cam[3 + k], dcy)),
                     -cam[6 + k]);
  }
  const float nrm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                __fmul_rn(d[2], d[2])));
  float inv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = __fdiv_rn(d[k], nrm);
    const float safe = fabsf(dk) > 1e-12f ? dk : (dk >= 0.f ? 1e-12f : -1e-12f);
    inv[k] = __fdiv_rn(1.f, safe);
  }
  return Ray{cam[16], cam[17], cam[18], inv[0], inv[1], inv[2]};
}

// Slab test, op for op as raster._slab: t0 = (lo - o) * inv,
// t1 = (hi - o) * inv per axis; entry = max of the per-axis minima, exit =
// min of the maxima; a hit when exit >= max(entry, 0).
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float& t_in, float& t_out) {
  const float x0 = __fmul_rn(__fsub_rn(lx, r.ox), r.ix);
  const float x1 = __fmul_rn(__fsub_rn(hx, r.ox), r.ix);
  const float y0 = __fmul_rn(__fsub_rn(ly, r.oy), r.iy);
  const float y1 = __fmul_rn(__fsub_rn(hy, r.oy), r.iy);
  const float z0 = __fmul_rn(__fsub_rn(lz, r.oz), r.iz);
  const float z1 = __fmul_rn(__fsub_rn(hz, r.oz), r.iz);
  t_in = fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1));
  t_out = fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1));
  return t_out >= fmaxf(t_in, 0.f);
}

// One leaf: keep the least entry depth, ties to the lowest id.
__device__ __forceinline__ void leaf(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float id_bits, float& m, int& sel) {
  float t_in, t_exit;
  if (slab(r, lx, ly, lz, hx, hy, hz, t_in, t_exit)) {
    const int id = __float_as_int(id_bits);
    if (t_in < m || (t_in == m && id < sel)) {
      m = t_in;
      sel = id;
    }
  }
}

// The last exit from 4 level-3 boxes; padding rows (lo 2e38) never count.
__device__ __forceinline__ float exit4(const Ray& r, float4 lx, float4 ly,
                                       float4 lz, float4 hx, float4 hy,
                                       float4 hz, float bound) {
  const float lo[3][4] = {{lx.x, lx.y, lx.z, lx.w},
                          {ly.x, ly.y, ly.z, ly.w},
                          {lz.x, lz.y, lz.z, lz.w}};
  const float hi[3][4] = {{hx.x, hx.y, hx.z, hx.w},
                          {hy.x, hy.y, hy.z, hy.w},
                          {hz.x, hz.y, hz.z, hz.w}};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t_in, t_exit;
    if (slab(r, lo[0][j], lo[1][j], lo[2][j], hi[0][j], hi[1][j], hi[2][j],
             t_in, t_exit) &&
        lo[0][j] < 1.0e38f) {
      bound = fmaxf(bound, t_exit);
    }
  }
  return bound;
}

// --- the bulk-copy ring: mbarriers and cp.async.bulk (PTX) ----------------

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
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Issue batch k of the tile's unit list into ring slot k & 1: its units and
// their boxes, completing on that slot's mbarrier. One thread.
__device__ __forceinline__ void issue_batch(
    int k, int batch, int count, int T, int t, const int* __restrict__ tab,
    const float4* __restrict__ units, const float4* __restrict__ uaabb,
    float4* s_unit, float4* s_ubox, uint64_t* s_bar) {
  const int buf = k & 1;
  const int n = min(batch, count - k * batch);
  // the slot's last reads (ordinary loads, before the vote) come before
  // these async-proxy writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(&s_bar[buf], n * (kUnitBytes + kBoxBytes));
  for (int b = 0; b < n; ++b) {
    const int uid = tab[static_cast<size_t>(k * batch + b) * T + t] >> 16;
    const int slot = buf * batch + b;
    bulk_copy(s_unit + static_cast<size_t>(slot) * kUnitVecs,
              units + static_cast<size_t>(uid) * kUnitVecs, kUnitBytes,
              &s_bar[buf]);
    bulk_copy(s_ubox + 2 * slot, uaabb + 2 * static_cast<size_t>(uid),
              kBoxBytes, &s_bar[buf]);
  }
}

// Dynamic shared memory, 16-byte aligned pieces: units [2][batch][8][128],
// unit boxes [2][batch][8], two mbarriers (16 bytes), level-3 boxes [6][M].
__global__ void __launch_bounds__(1024) raster_tiles_kernel(
    const int* __restrict__ tab,       // (c_cap, T): uid << 16 | zq
    const int* __restrict__ counts,    // (T,)
    const float* __restrict__ dz_ptr,  // ()
    const float* __restrict__ cam,     // (19,)
    const float* __restrict__ boxes,   // (M, 8)
    const float4* __restrict__ units,  // (U, 8, 128)
    const float4* __restrict__ uaabb,  // (U, 8)
    float* __restrict__ t_out,         // (T, P)
    int* __restrict__ id_out,          // (T, P)
    int T, int c_cap, int batch, int M, int tile_px, int tx_n, float width,
    float height) {
  extern __shared__ float4 smem[];
  float4* s_unit = smem;
  float4* s_ubox = s_unit + 2 * batch * kUnitVecs;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_ubox + 4 * batch);
  float* s_box = reinterpret_cast<float*>(s_bar + 2);

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int si = tid / kSplit;  // the pixel in the tile
  const int q = tid % kSplit;   // the lane in the pixel's quad
  const size_t out = static_cast<size_t>(t) * (nthreads / kSplit) + si;
  const int count = counts[t];
  if (count == 0) {  // the same for the whole block
    if (q == 0) {
      t_out[out] = kBig;
      id_out[out] = -1;
    }
    return;
  }
  // the lanes of this warp: all 32 but in the last warp of a small tile
  const int warp_lanes = min(32, nthreads - (tid & ~31));
  const unsigned mask = warp_lanes == 32 ? kFullWarp : (1u << warp_lanes) - 1u;
  const int nb = (count + batch - 1) / batch;  // batches in the walk
  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < min(nb, 2); ++k) {
      issue_batch(k, batch, count, T, t, tab, units, uaabb, s_unit, s_ubox,
                  s_bar);
    }
  }
  const Ray ray = pixel_ray(cam, (t / tx_n) * tile_px + si / tile_px,
                            (t % tx_n) * tile_px + si % tile_px, width,
                            height);

  for (int i = tid; i < M; i += nthreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[k * M + i] = boxes[i * 8 + k];
  }
  __syncthreads();  // the boxes and the mbarriers are ready
  const float4* box4 = reinterpret_cast<const float4*>(s_box);
  const int m4 = M / 4;
  float bound = -1.f;  // the last exit from the occupied level-3 cells
  for (int g = q; g < m4; g += kSplit) {
    bound = exit4(ray, box4[g], box4[m4 + g], box4[2 * m4 + g],
                  box4[3 * m4 + g], box4[4 * m4 + g], box4[5 * m4 + g], bound);
  }
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1) {
    bound = fmaxf(bound, __shfl_xor_sync(mask, bound, off));
  }

  const float dz = *dz_ptr;
  float best = kBig;
  int best_id = -1;
  int k = 0;
  for (; k < nb; ++k) {
    const int buf = k & 1;
    mbar_wait(&s_bar[buf], (k >> 1) & 1);
    const int n = min(batch, count - k * batch);
    for (int b = 0; b < n; ++b) {
      const int slot = buf * batch + b;
      // (lo x, lo y, lo z, hi x), (hi y, hi z, 0, 0)
      const float4 a = s_ubox[2 * slot], c = s_ubox[2 * slot + 1];
      float tu_in, tu_out;
      const bool enters =
          slab(ray, a.x, a.y, a.z, a.w, c.x, c.y, tu_in, tu_out) &&
          tu_in < best;
      if (!__any_sync(mask, enters)) continue;  // the same for the warp
      const float4* u = s_unit + static_cast<size_t>(slot) * kUnitVecs;
      float m = kBig;
      int sel = kIntBig;
#pragma unroll 2
      for (int g = q; g < kGroups; g += kSplit) {
        const float4 lx = u[g], ly = u[kGroups + g], lz = u[2 * kGroups + g];
        const float4 hx = u[3 * kGroups + g], hy = u[4 * kGroups + g];
        const float4 hz = u[5 * kGroups + g], id = u[6 * kGroups + g];
        leaf(ray, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, id.x, m, sel);
        leaf(ray, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, id.y, m, sel);
        leaf(ray, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, id.z, m, sel);
        leaf(ray, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, id.w, m, sel);
      }
#pragma unroll
      for (int off = 1; off < kSplit; off <<= 1) {
        const float m2 = __shfl_xor_sync(mask, m, off);
        const int sel2 = __shfl_xor_sync(mask, sel, off);
        if (m2 < m || (m2 == m && sel2 < sel)) {
          m = m2;
          sel = sel2;
        }
      }
      if (m < best) {
        best = m;
        best_id = sel;
      }
    }
    const int next = (k + 1) * batch;
    const float z_lb = __fmul_rn(
        static_cast<float>(tab[static_cast<size_t>(min(next, c_cap - 1)) * T + t] &
                           0xFFFF),
        dz);
    if (__syncthreads_and(fminf(best, bound) < z_lb)) break;
    if (tid == 0 && k + 2 < nb) {  // refill the slot just read
      issue_batch(k + 2, batch, count, T, t, tab, units, uaabb, s_unit, s_ubox,
                  s_bar);
    }
  }
  // drain: after a stop at batch k, batch k + 1 is still in flight
  if (k + 1 < nb) mbar_wait(&s_bar[(k + 1) & 1], ((k + 1) >> 1) & 1);
  if (q == 0) {
    t_out[out] = best;
    id_out[out] = best_id;
  }
}

__global__ void untile_kernel(const float* __restrict__ t_in,
                              const int* __restrict__ id_in,
                              float* __restrict__ t_out,
                              int* __restrict__ id_out, int H, int W,
                              int tile_px, int tx_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int row = i / W;
  const int col = i - row * W;
  const int src = ((row / tile_px) * tx_n + col / tile_px) * tile_px * tile_px +
                  (row % tile_px) * tile_px + col % tile_px;
  t_out[i] = t_in[src];
  id_out[i] = id_in[src];
}

}  // namespace

extern "C" int kaolin_spc_raster_tiles(const void* tab, const void* counts,
                                       const void* dz, const void* cam,
                                       const void* boxes, const void* units,
                                       const void* uaabb, void* t_out,
                                       void* id_out, int T, int c_cap,
                                       int batch, int M, int tile_px,
                                       int tx_n, float width, float height,
                                       void* stream) {
  // at most 2 x 4 x (4096 + 32) + 16 + 24 x 512 = 45,328 bytes: under the
  // 48 KB a launch may take without an opt-in
  const size_t smem =
      2 * static_cast<size_t>(batch) * (kUnitBytes + kBoxBytes) +
      2 * sizeof(uint64_t) + sizeof(float) * 6 * M;
  raster_tiles_kernel<<<T, kSplit * tile_px * tile_px, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int*>(counts),
      static_cast<const float*>(dz), static_cast<const float*>(cam),
      static_cast<const float*>(boxes), static_cast<const float4*>(units),
      static_cast<const float4*>(uaabb), static_cast<float*>(t_out),
      static_cast<int*>(id_out), T, c_cap, batch, M, tile_px, tx_n, width,
      height);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kaolin_spc_untile(const void* t_in, const void* id_in,
                                 void* t_out, void* id_out, int H, int W,
                                 int tile_px, int tx_n, void* stream) {
  constexpr int kThreads = 256;
  const int blocks = (H * W + kThreads - 1) / kThreads;
  untile_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t_in), static_cast<const int*>(id_in),
      static_cast<float*>(t_out), static_cast<int*>(id_out), H, W, tile_px,
      tx_n);
  return static_cast<int>(cudaGetLastError());
}
