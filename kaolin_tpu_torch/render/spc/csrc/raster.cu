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
// (pixel, leaf) pair the walk reaches, and the latency of the 4 KB unit
// loads from device memory, which the TPU design hid behind a two-batch DMA
// ring. Bytes are few: a unit is read once per tile that walks it.
//
// What the design does about it:
// * One block per tile, one thread per pixel (256 threads at 16 px). A tile
//   with no unit binned writes the background and returns at once, which
//   takes the place of the TPU path's active-tile compaction.
// * Units come in batches of 4 (2 or 1 where c_cap is not a multiple of 4):
//   the block loads a batch into shared memory cooperatively, 16 bytes per
//   thread per load, so the loads of a batch are all in flight together;
//   then every thread reads each leaf as a broadcast from shared memory.
//   Slots at or past the tile's count are never loaded or tested.
// * The level-3 boxes (at most 512) are staged in shared memory once, and
//   each thread computes its ray's exit bound before the walk.
// * After each batch one vote, __syncthreads_and(min(best, bound) < z_lb),
//   stops the tile once every pixel is nearer than the next batch's depth
//   lower bound: the rule of the plain version, so both stop at the same
//   slot.
// * The rays and the slab test repeat the plain version op for op with
//   round-to-nearest intrinsics (and the library is built with
//   --fmad=false, no fast math), so depths match it bit for bit. Within a
//   unit ties go to the lowest id; across units only a strictly nearer hit
//   replaces the best, so the unit walked first wins.
// * Left for later work: cp.async or TMA double-buffering of the unit
//   batches, so that the next batch loads while this one is tested, and
//   writing the row-major image from this kernel's store, which would make
//   the untile kernel unnecessary.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kIntBig = 1 << 30;
constexpr int kLanes = 128;                     // leaves per unit
constexpr int kUnitFloats = 8 * kLanes;         // one unit, 4 KB
constexpr int kUnitVecs = kUnitFloats / 4;      // as float4

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

// Dynamic shared memory: [batch][8][128] units, then [6][M] level-3 boxes.
__global__ void raster_tiles_kernel(
    const int* __restrict__ tab,       // (c_cap, T): uid << 16 | zq
    const int* __restrict__ counts,    // (T,)
    const float* __restrict__ dz_ptr,  // ()
    const float* __restrict__ cam,     // (19,)
    const float* __restrict__ boxes,   // (M, 8)
    const float4* __restrict__ units,  // (U, 8, 128)
    float* __restrict__ t_out,         // (T, P)
    int* __restrict__ id_out,          // (T, P)
    int T, int c_cap, int batch, int M, int tile_px, int tx_n, float width,
    float height) {
  extern __shared__ float4 smem[];
  float* s_unit = reinterpret_cast<float*>(smem);
  float* s_box = s_unit + batch * kUnitFloats;

  const int t = blockIdx.x;
  const int si = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t out = static_cast<size_t>(t) * nthreads + si;
  const int count = counts[t];
  if (count == 0) {  // the same for the whole block
    t_out[out] = kBig;
    id_out[out] = -1;
    return;
  }
  const Ray ray = pixel_ray(cam, (t / tx_n) * tile_px + si / tile_px,
                            (t % tx_n) * tile_px + si % tile_px, width,
                            height);

  for (int i = si; i < M; i += nthreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_box[k * M + i] = boxes[i * 8 + k];
  }
  __syncthreads();
  float bound = -1.f;  // the last exit from the occupied level-3 cells
  for (int m = 0; m < M; ++m) {
    const float lx = s_box[m];
    float t_in, t_exit;
    if (slab(ray, lx, s_box[M + m], s_box[2 * M + m], s_box[3 * M + m],
             s_box[4 * M + m], s_box[5 * M + m], t_in, t_exit) &&
        lx < 1.0e38f) {
      bound = fmaxf(bound, t_exit);
    }
  }

  const float dz = *dz_ptr;
  float best = kBig;
  int best_id = -1;
  for (int base = 0; base < count; base += batch) {
    const int n = min(batch, count - base);
    __syncthreads();  // the previous batch is no longer read
    for (int i = si; i < n * kUnitVecs; i += nthreads) {
      const int b = i / kUnitVecs;
      const int uid = tab[static_cast<size_t>(base + b) * T + t] >> 16;
      smem[i] = units[static_cast<size_t>(uid) * kUnitVecs + (i - b * kUnitVecs)];
    }
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float* u = s_unit + b * kUnitFloats;
      float m = kBig;
      int sel = kIntBig;
      for (int l = 0; l < kLanes; ++l) {
        float t_in, t_exit;
        if (slab(ray, u[l], u[kLanes + l], u[2 * kLanes + l], u[3 * kLanes + l],
                 u[4 * kLanes + l], u[5 * kLanes + l], t_in, t_exit)) {
          const int id = __float_as_int(u[6 * kLanes + l]);
          if (t_in < m || (t_in == m && id < sel)) {
            m = t_in;
            sel = id;
          }
        }
      }
      if (m < best) {
        best = m;
        best_id = sel;
      }
    }
    const int next = base + batch;
    const float z_lb = __fmul_rn(
        static_cast<float>(tab[static_cast<size_t>(min(next, c_cap - 1)) * T + t] &
                           0xFFFF),
        dz);
    if (__syncthreads_and(fminf(best, bound) < z_lb)) break;
  }
  t_out[out] = best;
  id_out[out] = best_id;
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
                                       void* t_out, void* id_out, int T,
                                       int c_cap, int batch, int M,
                                       int tile_px, int tx_n, float width,
                                       float height, void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(batch) * kUnitFloats + 6 * M);
  raster_tiles_kernel<<<T, tile_px * tile_px, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tab), static_cast<const int*>(counts),
      static_cast<const float*>(dz), static_cast<const float*>(cam),
      static_cast<const float*>(boxes), static_cast<const float4*>(units),
      static_cast<float*>(t_out), static_cast<int*>(id_out), T, c_cap, batch,
      M, tile_px, tx_n, width, height);
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
