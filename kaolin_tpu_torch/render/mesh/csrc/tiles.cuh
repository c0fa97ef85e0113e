// Image tiling, pixel coordinates, face bounding boxes and the per-tile face
// list shared by the mesh kernels (rasterize.cu, soft_mask.cu).
//
// A block covers a TILE x TILE pixel tile of one batch element (blockIdx.x:
// tile column, blockIdx.y: tile row, blockIdx.z: batch) with K threads a
// pixel. Threads whose pixel lies past the ragged right or bottom edge stay
// in the block, take part in every barrier and warp vote, and write nothing.
//
// The face list. Before a block tests any pixel it builds, in shared memory,
// the ascending list of the faces whose closed box meets the tile's
// pixel-centre rectangle, and its pixels walk only that list:
// * A pre-pass, one thread a face (face_boxes), writes each face's box once,
//   enlarged by the kernel's margin, as an empty box where the face is
//   culled, and per group of kGroup consecutive faces the smallest box that
//   holds the group's boxes.
// * The block tests its groups' boxes, then the boxes of the faces of the
//   groups that meet the tile: a float4 a face, no min/max. A warp compacts
//   its live faces with one ballot and popc, a scan over the block's warps
//   places them (append_ordered), so the list keeps the order of the ids.
// * The list holds any number of faces: once it reaches kList, the kernel's
//   flush stages those kList faces' data (read once more, by one thread a
//   face) and runs its pixel loop over them, and the list starts again with
//   what is left.
// Exact: a pixel centre inside a face's closed box lies in the tile's
// rectangle and in the box, so the box meets the rectangle (boxes_meet); a
// group box holds each of its faces' boxes, so it meets the rectangle too.
// No face that holds a pixel of the tile is left out, and the faces come in
// ascending id order, as a per-face loop over all faces visits them.
// rasterization.tile_face_lists is the plain model of this cull.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace kaolin_mesh {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kGroup = 32;   // faces per group box: one warp of the pre-pass
constexpr int kList = 256;   // faces whose data a block stages at once
constexpr int kBoxThreads = 256;

// Pixel-centre coordinates, x right and y up, rounded exactly as
// rasterization._pixel_coords rounds them: sx = fl(multiplier / W) is
// computed on the host, then one product with an exact integer.
__device__ __forceinline__ float pixel_x(int col, int W, float sx) {
  return sx * static_cast<float>(2 * col + 1 - W);
}
__device__ __forceinline__ float pixel_y(int row, int H, float sy) {
  return sy * static_cast<float>(H - 2 * row - 1);
}

struct Box {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ Box as_box(float4 b) {
  return Box{b.x, b.y, b.z, b.w};
}

// The pixel-centre rectangle of this block's tile, clipped at the ragged
// edge. pixel_x and pixel_y are monotonic in the column and row, so every
// pixel centre of the tile lies inside it.
template <int TILE>
__device__ __forceinline__ Box tile_rect(int H, int W, float sx, float sy) {
  const int c0 = blockIdx.x * TILE;
  const int r0 = blockIdx.y * TILE;
  const int c1 = min(c0 + TILE, W) - 1;
  const int r1 = min(r0 + TILE, H) - 1;
  return Box{pixel_x(c0, W, sx), pixel_x(c1, W, sx),
             pixel_y(r1, H, sy),   // y decreases with the row index
             pixel_y(r0, H, sy)};
}

// The bounding box of a face's vertices v = (x0, y0, x1, y1, x2, y2),
// enlarged by `margin` on each side, rounded as the plain versions round it.
__device__ __forceinline__ Box face_box(const float v[6], float margin) {
  return Box{fminf(fminf(v[0], v[2]), v[4]) - margin,
             fmaxf(fmaxf(v[0], v[2]), v[4]) + margin,
             fminf(fminf(v[1], v[3]), v[5]) - margin,
             fmaxf(fmaxf(v[1], v[3]), v[5]) + margin};
}

// Whether two closed boxes meet.
__device__ __forceinline__ bool boxes_meet(const Box& a, const Box& b) {
  return a.x_lo <= b.x_hi && a.x_hi >= b.x_lo && a.y_lo <= b.y_hi &&
         a.y_hi >= b.y_lo;
}

// The pre-pass, grid (ceil(F / kBoxThreads), B): boxes[b * F + f] is face
// f's box enlarged by `margin`, empty (lo = +inf, hi = -inf, which meets
// nothing) where valid[b * F + f] is 0; groups[b * G + g] holds the boxes of
// faces g * kGroup .. g * kGroup + kGroup - 1. A warp is one group.
__device__ __forceinline__ void face_boxes(
    const float* __restrict__ fvi, const unsigned char* __restrict__ valid,
    float4* __restrict__ boxes, float4* __restrict__ groups, int F,
    float margin) {
  const int b = blockIdx.y;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  Box box{INFINITY, -INFINITY, INFINITY, -INFINITY};
  if (f < F) {
    const size_t i = static_cast<size_t>(b) * F + f;
    if (valid == nullptr || valid[i]) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = fvi[i * 6 + k];
      box = face_box(v, margin);
    }
    boxes[i] = make_float4(box.x_lo, box.x_hi, box.y_lo, box.y_hi);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    box.x_lo = fminf(box.x_lo, __shfl_xor_sync(kFullWarp, box.x_lo, off));
    box.x_hi = fmaxf(box.x_hi, __shfl_xor_sync(kFullWarp, box.x_hi, off));
    box.y_lo = fminf(box.y_lo, __shfl_xor_sync(kFullWarp, box.y_lo, off));
    box.y_hi = fmaxf(box.y_hi, __shfl_xor_sync(kFullWarp, box.y_hi, off));
  }
  if ((threadIdx.x & 31) == 0 && f < F) {
    const int G = (F + kGroup - 1) / kGroup;
    groups[static_cast<size_t>(b) * G + f / kGroup] =
        make_float4(box.x_lo, box.x_hi, box.y_lo, box.y_hi);
  }
}

// The front end's shared memory for a block of NT threads.
template <int NT>
struct ListSmem {
  int ids[kList + NT];     // the live faces, ascending
  int gids[NT];            // the live groups of a chunk of groups
  int warp_count[NT / 32];
};

// Block-wide: write `x` of every thread whose `live` holds to
// list[count ...], in thread order; return the new count. Every thread
// calls it; it ends with a barrier, after which the list is readable.
template <int NT>
__device__ __forceinline__ int append_ordered(bool live, int x, int* list,
                                              int count, int* warp_count) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFullWarp, live);
  if (lane == 0) warp_count[warp] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = warp_count[w];
    before += w < warp ? c : 0;
    total += c;
  }
  if (live) list[count + before + __popc(m & ((1u << lane) - 1u))] = x;
  __syncthreads();
  return count + total;
}

// Build the tile's ascending face list and hand it to flush(ids, n) kList
// faces at a time, the rest at the end. flush is called by every thread and
// must end with a barrier. boxes and groups are this batch element's.
template <int NT, class Flush>
__device__ __forceinline__ void walk_tile_faces(
    const float4* __restrict__ boxes, const float4* __restrict__ groups, int F,
    const Box& rect, ListSmem<NT>& s, Flush& flush) {
  const int tid = threadIdx.x;
  const int G = (F + kGroup - 1) / kGroup;
  constexpr int kPerBatch = NT / kGroup;  // groups whose faces one pass reads
  int count = 0;
  for (int g0 = 0; g0 < G; g0 += NT) {
    const int g = g0 + tid;
    const bool near = g < G && boxes_meet(as_box(groups[g]), rect);
    const int ng = append_ordered<NT>(near, g, s.gids, 0, s.warp_count);
    for (int i0 = 0; i0 < ng; i0 += kPerBatch) {
      const int i = i0 + tid / kGroup;
      const int f = i < ng ? s.gids[i] * kGroup + tid % kGroup : F;
      const bool live = f < F && boxes_meet(as_box(boxes[f]), rect);
      count = append_ordered<NT>(live, f, s.ids, count, s.warp_count);
      while (count >= kList) {  // the same for the whole block
        flush(s.ids, kList);
        const int rest = count - kList;  // < NT
        const int keep = tid < rest ? s.ids[kList + tid] : 0;
        __syncthreads();
        if (tid < rest) s.ids[tid] = keep;
        __syncthreads();
        count = rest;
      }
    }
  }
  if (count > 0) flush(s.ids, count);
}

}  // namespace kaolin_mesh
