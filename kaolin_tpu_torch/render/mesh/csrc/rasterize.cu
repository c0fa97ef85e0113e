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
// What bounds it on this card: ALU work per (pixel, face) pair in the box,
// about 20 products and sums plus three IEEE divisions, not bytes. A face is
// read from device memory once per block and then broadcast from shared
// memory to all 256 threads.
//
// What the design does about it:
// * One thread per pixel, a 16x16 tile per block, the batch on blockIdx.z.
// * Faces stream through shared memory in chunks of 256. Each face's box is
//   tested once per block against the tile's pixel rectangle; the result is
//   the same for every thread, so the per-face skip does not diverge, and a
//   chunk with no face left is skipped whole (__syncthreads_or). Because the
//   per-pixel test is the same closed box, this cull is exact: it takes the
//   place of the TPU path's packed face table and per-(tile, chunk)
//   occupancy bitmap, needs no capacity, and holds at any face count.
// * Each thread visits faces in ascending id order and takes only a strictly
//   greater z: ties go to the lowest id with no extra work.
// * The ids must equal the plain search's, and pixels on a shared edge tie in
//   z to the last bit. So the arithmetic repeats rasterization._barycentrics
//   op for op, division included, with round-to-nearest intrinsics that are
//   never contracted into fused multiply-adds (the library is also compiled
//   with --fmad=false and without fast math).
// * The output is written as a row-major (B, H, W) int32 image, and the
//   ragged edge is masked, so any H and W work.

#include <cuda_runtime.h>

#include <cmath>

#include "tiles.cuh"

namespace {

using namespace kaolin_mesh;

__global__ void __launch_bounds__(kThreads)
winner_kernel(const float* __restrict__ fvz,            // (B, F, 3)
              const float* __restrict__ fvi,            // (B, F, 3, 2)
              const unsigned char* __restrict__ valid,  // (B, F)
              int* __restrict__ out,                    // (B, H, W)
              int F, int H, int W, float sx, float sy, float eps) {
  __shared__ float s_v[6][kChunk];
  __shared__ float s_z[3][kChunk];
  __shared__ Box s_box[kChunk];
  __shared__ unsigned char s_live[kChunk];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const int row = blockIdx.y * kTile + threadIdx.y;
  const float px = pixel_x(col, W, sx);
  const float py = pixel_y(row, H, sy);
  const Box rect = tile_rect(H, W, sx, sy);

  fvz += static_cast<size_t>(b) * F * 3;
  fvi += static_cast<size_t>(b) * F * 6;
  valid += static_cast<size_t>(b) * F;

  float best_z = -INFINITY;
  int best_id = -1;
  for (int base = 0; base < F; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    const int f = base + tid;
    bool live = false;
    if (f < F) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        v[k] = fvi[static_cast<size_t>(f) * 6 + k];
        s_v[k][tid] = v[k];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s_z[k][tid] = fvz[static_cast<size_t>(f) * 3 + k];
      s_box[tid] = face_box(v, 0.f);
      live = valid[f] && boxes_meet(s_box[tid], rect);
    }
    s_live[tid] = live;
    if (!__syncthreads_or(live)) continue;

    const int n = min(kChunk, F - base);
    for (int j = 0; j < n; ++j) {
      if (!s_live[j]) continue;
      const Box box = s_box[j];
      if (px < box.x_lo || px > box.x_hi || py < box.y_lo || py > box.y_hi) {
        continue;
      }
      // rasterization._barycentrics, op for op
      const float ax = __fsub_rn(s_v[0][j], px);
      const float ay = __fsub_rn(s_v[1][j], py);
      const float bx = __fsub_rn(s_v[2][j], px);
      const float by = __fsub_rn(s_v[3][j], py);
      const float cx = __fsub_rn(s_v[4][j], px);
      const float cy = __fsub_rn(s_v[5][j], py);
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
            __fadd_rn(__fmul_rn(w0, s_z[0][j]), __fmul_rn(w1, s_z[1][j])),
            __fmul_rn(w2, s_z[2][j]));
        if (z > best_z) {
          best_z = z;
          best_id = base + j;
        }
      }
    }
  }
  if (col < W && row < H) {
    out[(static_cast<size_t>(b) * H + row) * W + col] = best_id;
  }
}

}  // namespace

extern "C" int kaolin_rasterize_winner(const void* fvz, const void* fvi,
                                       const void* valid, void* out, int B,
                                       int F, int H, int W, float sx, float sy,
                                       float eps, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile);
  winner_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fvz), static_cast<const float*>(fvi),
      static_cast<const unsigned char*>(valid), static_cast<int*>(out), F, H,
      W, sx, sy, eps);
  return static_cast<int>(cudaGetLastError());
}
