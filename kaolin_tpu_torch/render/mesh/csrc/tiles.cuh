// Image tiling, pixel coordinates and face bounding boxes shared by the mesh
// kernels.
//
// A block covers a kTile x kTile pixel tile of one batch element
// (blockIdx.x: tile column, blockIdx.y: tile row, blockIdx.z: batch), one
// thread per pixel. Threads whose pixel lies past the ragged right or bottom
// edge stay in the block, take part in every barrier and warp vote, and
// write nothing.
#pragma once

namespace kaolin_mesh {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
// Faces staged in shared memory per step: one loaded by each thread.
constexpr int kChunk = kThreads;

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

// The pixel-centre rectangle of this block's tile, clipped at the ragged
// edge. pixel_x and pixel_y are monotonic in the column and row, so every
// pixel centre of the tile lies inside it.
__device__ __forceinline__ Box tile_rect(int H, int W, float sx, float sy) {
  const int c0 = blockIdx.x * kTile;
  const int r0 = blockIdx.y * kTile;
  const int c1 = min(c0 + kTile, W) - 1;
  const int r1 = min(r0 + kTile, H) - 1;
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

// Whether two closed boxes meet. A pixel centre inside a face's closed box
// lies in the tile's rectangle and in the box, so the box meets the
// rectangle: a face that fails this test holds no pixel of the tile, and the
// whole block may skip it without changing any pixel's result.
__device__ __forceinline__ bool boxes_meet(const Box& a, const Box& b) {
  return a.x_lo <= b.x_hi && a.x_hi >= b.x_lo && a.y_lo <= b.y_hi &&
         a.y_hi >= b.y_lo;
}

}  // namespace kaolin_mesh
