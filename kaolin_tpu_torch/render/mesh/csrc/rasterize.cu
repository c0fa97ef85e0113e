// DIB-R rasterizer winner search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kaolin_tpu/render/mesh/pallas_rasterize.py
// (_winner_kernel, driven by rasterize_search_pallas). Per pixel: 2D
// cross-product barycentrics with signed-eps normalisation, the inside test,
// interpolated z, and the max-z winner; ties go to the lowest face id, and a
// pixel no valid face covers gets -1. A face is tested only at the pixels
// inside its closed bounding box, as in the reference CUDA rasterizer and in
// the plain search. Not differentiable: rasterize() re-gathers the winners'
// vertices and features in PyTorch, and autograd differentiates that.
//
// What bounds it on this card: the arithmetic is about 20 products and sums
// and three IEEE divisions per (pixel, face) pair in a closed box, 11.8 M
// operations on config 2, and the bytes are 1.2 MB: both far below what the
// time shows. What costs is finding the pairs: a busy 16 x 16 tile holds 27
// of config 2's 4,992 faces on average, and a per-face loop over every face
// steps through all of them.
//
// The design (two launches):
// * winner_box_kernel, one thread a face: each face's closed box, empty for
//   a culled face, and each group of 32 faces' box (tiles.cuh, face_boxes).
// * winner_kernel, one block an 8 x 8 tile, two threads a pixel: the block
//   builds the tile's ascending list of live faces in shared memory
//   (tiles.cuh, walk_tile_faces) from the group boxes and the face boxes,
//   stages each listed face's box, vertices, z and id once, and each pixel
//   walks the list, its two threads taking every other face. The list is
//   exact (tiles.cuh) and has no capacity; it takes the place of the TPU
//   path's packed face table and per-(tile, chunk) occupancy bitmap. Of
//   the shapes timed on the card (16 x 16 tiles with one, two or four
//   threads a pixel, 8 x 8 with one to eight, 4 x 4 with four or eight),
//   8 x 8 with two was the fastest.
// * Each thread visits its faces in ascending id order and takes only a
//   strictly greater z, so it keeps its faces' highest z at their lowest
//   id; the threads of a pixel are combined by (larger z, then lower id)
//   with xor-shuffles. That is the max-z winner with ties to the lowest id
//   of the whole list, at any number of threads a pixel.
// * The ids must equal the plain search's, and pixels on a shared edge tie in
//   z to the last bit. So the arithmetic repeats rasterization._barycentrics
//   op for op, division included, with round-to-nearest intrinsics that are
//   never contracted into fused multiply-adds (the library is also compiled
//   with --fmad=false and without fast math).
// * The output is written as a row-major (B, H, W) int32 image, and the
//   ragged edge is masked, so any H and W work.
// * Given the pair counters (tiles.cuh), a block adds its list's length
//   times its tile's in-image pixels: the pairs whose box test it ran.

#include <cuda_runtime.h>

#include <cmath>

#include "tiles.cuh"

namespace {

using namespace kaolin_mesh;

constexpr int kWinnerTile = 8;   // tile side, pixels
constexpr int kWinnerSplit = 2;  // threads a pixel

// One listed face as the pixel loop reads it: four float4.
struct alignas(16) WinnerFace {
  Box box;
  float v[6];
  float z[3];
  int id;
  float pad[2];
};
static_assert(sizeof(WinnerFace) == 64, "four float4");

template <int NT, int K>
struct WinnerFlush {
  const float* __restrict__ fvz;  // this batch element's (F, 3)
  const float* __restrict__ fvi;  // (F, 3, 2)
  WinnerFace* s_face;
  float px, py, eps;
  int lane;
  float best_z;
  int best_id;

  __device__ __forceinline__ void operator()(const int* ids, int n) {
    for (int j = threadIdx.x; j < n; j += NT) {
      const int f = ids[j];
      WinnerFace e;
#pragma unroll
      for (int k = 0; k < 6; ++k) e.v[k] = fvi[static_cast<size_t>(f) * 6 + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) e.z[k] = fvz[static_cast<size_t>(f) * 3 + k];
      e.box = face_box(e.v, 0.f);
      e.id = f;
      e.pad[0] = e.pad[1] = 0.f;
      s_face[j] = e;
    }
    __syncthreads();
    const float4* q = reinterpret_cast<const float4*>(s_face);
    for (int j = lane; j < n; j += K) {
      const float4 box = q[4 * j];
      if (px < box.x || px > box.y || py < box.z || py > box.w) continue;
      const float4 a = q[4 * j + 1];  // x0 y0 x1 y1
      const float4 c = q[4 * j + 2];  // x2 y2 z0 z1
      const float4 d = q[4 * j + 3];  // z2 id
      // rasterization._barycentrics, op for op
      const float ax = __fsub_rn(a.x, px);
      const float ay = __fsub_rn(a.y, py);
      const float bx = __fsub_rn(a.z, px);
      const float by = __fsub_rn(a.w, py);
      const float cx = __fsub_rn(c.x, px);
      const float cy = __fsub_rn(c.y, py);
      float w0 = __fsub_rn(__fmul_rn(bx, cy), __fmul_rn(by, cx));
      float w1 = __fsub_rn(__fmul_rn(cx, ay), __fmul_rn(cy, ax));
      float w2 = __fsub_rn(__fmul_rn(ax, by), __fmul_rn(ay, bx));
      float norm = __fadd_rn(__fadd_rn(w0, w1), w2);
      norm = __fadd_rn(norm, norm >= 0.f ? eps : -eps);
      w0 = __fdiv_rn(w0, norm);
      w1 = __fdiv_rn(w1, norm);
      w2 = __fdiv_rn(w2, norm);
      if (w0 >= 0.f && w1 >= 0.f && w2 >= 0.f) {
        const float z = __fadd_rn(
            __fadd_rn(__fmul_rn(w0, c.z), __fmul_rn(w1, c.w)),
            __fmul_rn(w2, d.x));
        if (z > best_z) {
          best_z = z;
          best_id = __float_as_int(d.y);
        }
      }
    }
    __syncthreads();  // the staged faces are no longer read
  }
};

__global__ void __launch_bounds__(kBoxThreads)
winner_box_kernel(const float* __restrict__ fvi,
                  const unsigned char* __restrict__ valid,
                  float4* __restrict__ boxes, float4* __restrict__ groups,
                  int F, unsigned long long* counters, int reset) {
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    zero_pairs(counters, reset);
  }
  face_boxes(fvi, valid, boxes, groups, F, 0.f);
}

// Dynamic shared memory: kList WinnerFace, then ListSmem<NT>.
template <int TILE, int K>
__global__ void __launch_bounds__(TILE * TILE * K)
winner_kernel(const float* __restrict__ fvz,     // (B, F, 3)
              const float* __restrict__ fvi,     // (B, F, 3, 2)
              const float4* __restrict__ boxes,  // (B, F)
              const float4* __restrict__ groups, // (B, G)
              int* __restrict__ out,             // (B, H, W)
              unsigned long long* pairs,         // or null
              int F, int H, int W, float sx, float sy, float eps) {
  constexpr int NT = TILE * TILE * K;
  extern __shared__ float4 smem[];
  WinnerFace* s_face = reinterpret_cast<WinnerFace*>(smem);
  ListSmem<NT>* s_list = reinterpret_cast<ListSmem<NT>*>(s_face + kList);

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = (F + kGroup - 1) / kGroup;
  groups += static_cast<size_t>(b) * G;
  const int pix = tid / K;  // the pixel in the tile
  const int col = blockIdx.x * TILE + pix % TILE;
  const int row = blockIdx.y * TILE + pix / TILE;

  WinnerFlush<NT, K> flush{fvz + static_cast<size_t>(b) * F * 3,
                           fvi + static_cast<size_t>(b) * F * 6,
                           s_face,
                           pixel_x(col, W, sx),
                           pixel_y(row, H, sy),
                           eps,
                           tid % K,
                           -INFINITY,
                           -1};
  const int listed =
      walk_tile_faces<NT>(boxes + static_cast<size_t>(b) * F, groups, F,
                          tile_rect<TILE>(H, W, sx, sy), *s_list, flush);
  if (pairs != nullptr && tid == 0) {
    const int px = min(TILE, W - static_cast<int>(blockIdx.x) * TILE) *
                   min(TILE, H - static_cast<int>(blockIdx.y) * TILE);
    atomicAdd(pairs, static_cast<unsigned long long>(listed) * px);
  }
  float best_z = flush.best_z;
  int best_id = flush.best_id;
  // a hit has z > -inf and an id >= 0; a miss is (-inf, -1)
#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
    const float z2 = __shfl_xor_sync(kFullWarp, best_z, off);
    const int id2 = __shfl_xor_sync(kFullWarp, best_id, off);
    if (z2 > best_z || (z2 == best_z && id2 < best_id)) {
      best_z = z2;
      best_id = id2;
    }
  }
  if (tid % K == 0 && col < W && row < H) {
    out[(static_cast<size_t>(b) * H + row) * W + col] = best_id;
  }
}

template <int TILE, int K>
int launch_winner(const void* fvz, const void* fvi, const void* valid,
                  void* work, void* out, int B, int F, int H, int W, float sx,
                  float sy, float eps, void* counters, int reset,
                  void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  constexpr int NT = TILE * TILE * K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* boxes = static_cast<float4*>(work);
  float4* groups = boxes + static_cast<size_t>(B) * F;
  unsigned long long* c = static_cast<unsigned long long*>(counters);
  if (F > 0) {
    winner_box_kernel<<<dim3((F + kBoxThreads - 1) / kBoxThreads, B),
                        kBoxThreads, 0, st>>>(
        static_cast<const float*>(fvi),
        static_cast<const unsigned char*>(valid), boxes, groups, F, c,
        reset);
  }
  const size_t smem = kList * sizeof(WinnerFace) + sizeof(ListSmem<NT>);
  const auto kernel = winner_kernel<TILE, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B), NT, smem,
           st>>>(static_cast<const float*>(fvz), static_cast<const float*>(fvi),
                 boxes, groups, static_cast<int*>(out),
                 pair_counter(c, kWinnerPairs), F, H, W, sx, sy, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: (B * F + B * ceil(F / 32)) float4, the face and group boxes;
// counters: the three pair counters (tiles.cuh) or null, zeroed first where
// reset is set (F > 0).
extern "C" int kaolin_rasterize_winner(const void* fvz, const void* fvi,
                                       const void* valid, void* work,
                                       void* out, int B, int F, int H, int W,
                                       float sx, float sy, float eps,
                                       void* counters, int reset,
                                       void* stream) {
  return launch_winner<kWinnerTile, kWinnerSplit>(
      fvz, fvi, valid, work, out, B, F, H, W, sx, sy, eps, counters, reset,
      stream);
}
