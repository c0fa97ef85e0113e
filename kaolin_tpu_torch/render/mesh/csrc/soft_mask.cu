// DIB-R soft silhouette for Hopper (sm_90a): forward and analytic backward.
//
// Replaces the Pallas TPU kernels in kaolin_tpu/render/mesh/pallas_soft_mask.py:
// _soft_fwd_kernel (driven by soft_mask_fwd_pallas) and _soft_bwd_kernel
// (driven by soft_mask_bwd_pallas). Per pixel, over the faces whose bounding
// box, enlarged by margin = boxlen * multiplier, contains the pixel (half
// open: x >= min, x < max), the forward computes
//     allprob = prod (1 - p),  p = exp(-sigmainv * d2 / multiplier^2),
// with d2 the least of the 3 edge distances (perpendicular where the foot
// lies on the segment, else a large constant) and the 3 vertex distances.
// The caller forms soft = 1 - allprob. The backward takes
// ga = grad(allprob) * allprob and returns the gradient with respect to the
// scaled face_vertices_image, (B, F, 3, 2).
//
// What bounds it on this card: one exp and about 60 ALU operations (six
// divisions among them) per (pixel, face) pair in the box, twice that and a
// block-wide reduction per face in the backward; not bytes. Faces are read
// once per block and broadcast from shared memory.
//
// What the design does about it:
// * One thread per pixel, a 16x16 tile per block, the batch on blockIdx.z;
//   faces stream through shared memory in chunks of 256, and a face whose
//   enlarged box misses the tile's pixel rectangle is skipped by the whole
//   block (closed-interval test, so it never drops a face the half-open
//   per-pixel test would keep); an empty chunk is skipped whole
//   (__syncthreads_or). This takes the place of pack_faces/chunk_occupancy
//   and of the TPU's face-count limit: any F, any H and W.
// * The forward keeps a running product of (1 - p), as the reference CUDA
//   kernel and the all-faces plain version do; the TPU kernel's
//   exp(sum log(1 - p)) was a Mosaic workaround.
// * Forward and backward share candidates(), so the backward's tie test
//   cand == d2 sees the forward's values, and the library is compiled with
//   --fmad=false so they also equal the plain PyTorch version's. Tied minima
//   share the cotangent evenly, as torch.amin and jnp.min do.
// * The TPU backward accumulated into one (8, F_pad) block across a
//   sequential grid; GPU blocks run in parallel and in no order. Here each
//   face's 6 partials are summed over a warp with shuffles, added into a
//   per-chunk accumulator in shared memory (one shared atomic per warp), and
//   added to device memory with one atomicAdd per face coordinate per block.
//   The order of those float sums changes from run to run, so the gradient
//   is not bitwise reproducible: it agrees with the plain version to 1e-4 of
//   its largest entry.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using namespace kaolin_mesh;

constexpr unsigned kFullWarp = 0xffffffffu;

struct Edge {
  float A, B, up, den;
};

// dibr._edge_vertex_sqdist for one face, op for op: the 6 candidates, the
// edge terms their gradient needs, and the least candidate.
__device__ __forceinline__ float candidates(float px, float py, const float v[6],
                                            float bad, float cand[6],
                                            Edge e[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i2 = (i + 1) % 3;
    const float x1 = v[2 * i], y1 = v[2 * i + 1];
    const float x2 = v[2 * i2], y2 = v[2 * i2 + 1];
    const float A = y2 - y1;
    const float B = x1 - x2;
    const float C = x2 * y1 - x1 * y2;
    const float up = A * px + B * py + C;
    const float den = (A * A + B * B) + 1e-10f;
    const float x3 = (B * B * px - A * B * py - A * C) / den;
    const float y3 = (A * A * py - A * B * px - B * C) / den;
    const float direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2);
    cand[i] = direct > 0.f ? bad : up * up / den;
    e[i] = Edge{A, B, up, den};
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dx = px - v[2 * j];
    const float dy = py - v[2 * j + 1];
    cand[3 + j] = dx * dx + dy * dy;
  }
  float d2 = cand[0];
#pragma unroll
  for (int q = 1; q < 6; ++q) d2 = fminf(d2, cand[q]);
  return d2;
}

// Stage face `base + tid` (vertices and margin-enlarged box) in shared
// memory; return whether its box meets the tile rectangle.
__device__ __forceinline__ bool stage_face(const float* __restrict__ fvi,
                                           int f, int F, int tid, float margin,
                                           const Box& rect,
                                           float (*s_v)[kChunk], Box* s_box) {
  if (f >= F) return false;
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    v[k] = fvi[static_cast<size_t>(f) * 6 + k];
    s_v[k][tid] = v[k];
  }
  s_box[tid] = face_box(v, margin);
  return boxes_meet(s_box[tid], rect);
}

// The per-pixel test of dibr.soft_mask_plain: half open, x >= lo, x < hi.
__device__ __forceinline__ bool in_box(float px, float py, const Box& box) {
  return px >= box.x_lo && px < box.x_hi && py >= box.y_lo && py < box.y_hi;
}

__global__ void __launch_bounds__(kThreads)
soft_fwd_kernel(const float* __restrict__ fvi,  // (B, F, 3, 2), scaled
                float* __restrict__ allprob,    // (B, H, W)
                int F, int H, int W, float sx, float sy, float margin,
                float neg_sigmainv, float mm, float bad) {
  __shared__ float s_v[6][kChunk];
  __shared__ Box s_box[kChunk];
  __shared__ unsigned char s_live[kChunk];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const int row = blockIdx.y * kTile + threadIdx.y;
  const float px = pixel_x(col, W, sx);
  const float py = pixel_y(row, H, sy);
  const Box rect = tile_rect(H, W, sx, sy);
  fvi += static_cast<size_t>(b) * F * 6;

  float ap = 1.f;
  for (int base = 0; base < F; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    const bool live =
        stage_face(fvi, base + tid, F, tid, margin, rect, s_v, s_box);
    s_live[tid] = live;
    if (!__syncthreads_or(live)) continue;

    const int n = min(kChunk, F - base);
    for (int j = 0; j < n; ++j) {
      if (!s_live[j] || !in_box(px, py, s_box[j])) continue;
      float v[6], cand[6];
      Edge e[3];
#pragma unroll
      for (int k = 0; k < 6; ++k) v[k] = s_v[k][j];
      const float d2 = candidates(px, py, v, bad, cand, e);
      ap *= 1.f - expf(neg_sigmainv * d2 / mm);
    }
  }
  if (col < W && row < H) {
    allprob[(static_cast<size_t>(b) * H + row) * W + col] = ap;
  }
}

__global__ void __launch_bounds__(kThreads)
soft_bwd_kernel(const float* __restrict__ fvi,  // (B, F, 3, 2), scaled
                const float* __restrict__ ga,   // (B, H, W)
                float* __restrict__ grad,       // (B, F, 3, 2), zeroed
                int F, int H, int W, float sx, float sy, float margin,
                float neg_sigmainv, float mm, float k, float bad) {
  __shared__ float s_v[6][kChunk];
  __shared__ Box s_box[kChunk];
  __shared__ float s_acc[6][kChunk];
  __shared__ unsigned char s_live[kChunk];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int lane = tid & 31;
  const int col = blockIdx.x * kTile + threadIdx.x;
  const int row = blockIdx.y * kTile + threadIdx.y;
  const bool in_image = col < W && row < H;
  const float px = pixel_x(col, W, sx);
  const float py = pixel_y(row, H, sy);
  const Box rect = tile_rect(H, W, sx, sy);
  const float g =
      in_image ? ga[(static_cast<size_t>(b) * H + row) * W + col] : 0.f;
  fvi += static_cast<size_t>(b) * F * 6;
  grad += static_cast<size_t>(b) * F * 6;

  for (int base = 0; base < F; base += kChunk) {
    __syncthreads();  // the previous chunk is no longer read or flushed
    const bool live =
        stage_face(fvi, base + tid, F, tid, margin, rect, s_v, s_box);
    s_live[tid] = live;
#pragma unroll
    for (int q = 0; q < 6; ++q) s_acc[q][tid] = 0.f;
    if (!__syncthreads_or(live)) continue;

    const int n = min(kChunk, F - base);
    for (int j = 0; j < n; ++j) {
      if (!s_live[j]) continue;  // the same for the whole block
      const bool inb = in_image && in_box(px, py, s_box[j]);
      if (!__any_sync(kFullWarp, inb)) continue;  // the same for the warp

      float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (inb) {
        float v[6], cand[6];
        Edge e[3];
#pragma unroll
        for (int q = 0; q < 6; ++q) v[q] = s_v[q][j];
        const float d2 = candidates(px, py, v, bad, cand, e);
        const float p = expf(neg_sigmainv * d2 / mm);
        float ties = 0.f;
#pragma unroll
        for (int q = 0; q < 6; ++q) ties += cand[q] == d2 ? 1.f : 0.f;
        // d allprob / d p = -allprob / (1 - p); d p / d d2 = -k p
        const float c = g / fmaxf(1.f - p, 1e-12f) * k * p / ties;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (cand[i] != d2) continue;
          // d perp / d theta = (2 up d up - perp d down) / den
          const int i2 = (i + 1) % 3;
          const float x1 = v[2 * i], y1 = v[2 * i + 1];
          const float x2 = v[2 * i2], y2 = v[2 * i2 + 1];
          const float A = e[i].A, B = e[i].B, up = e[i].up;
          const float perp = up * up / e[i].den;
          const float w = c / e[i].den;
          gv[2 * i] += w * (2.f * up * (py - y2) - perp * (2.f * B));
          gv[2 * i + 1] += w * (2.f * up * (x2 - px) + perp * (2.f * A));
          gv[2 * i2] += w * (2.f * up * (y1 - py) + perp * (2.f * B));
          gv[2 * i2 + 1] += w * (2.f * up * (px - x1) - perp * (2.f * A));
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          if (cand[3 + q] != d2) continue;
          gv[2 * q] += -2.f * c * (px - v[2 * q]);
          gv[2 * q + 1] += -2.f * c * (py - v[2 * q + 1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 6; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          gv[q] += __shfl_down_sync(kFullWarp, gv[q], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          if (gv[q] != 0.f) atomicAdd(&s_acc[q][j], gv[q]);
        }
      }
    }
    __syncthreads();
    if (s_live[tid]) {
      const size_t f = static_cast<size_t>(base + tid);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float a = s_acc[q][tid];
        if (a != 0.f) atomicAdd(&grad[f * 6 + q], a);
      }
    }
  }
}

dim3 grid_for(int B, int H, int W) {
  return dim3((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
}

}  // namespace

extern "C" int kaolin_soft_mask_fwd(const void* fvi, void* allprob, int B,
                                    int F, int H, int W, float sx, float sy,
                                    float margin, float neg_sigmainv, float mm,
                                    float bad, void* stream) {
  soft_fwd_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fvi), static_cast<float*>(allprob), F, H, W,
      sx, sy, margin, neg_sigmainv, mm, bad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kaolin_soft_mask_bwd(const void* fvi, const void* ga,
                                    void* grad, int B, int F, int H, int W,
                                    float sx, float sy, float margin,
                                    float neg_sigmainv, float mm, float k,
                                    float bad, void* stream) {
  soft_bwd_kernel<<<grid_for(B, H, W), dim3(kTile, kTile), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fvi), static_cast<const float*>(ga),
      static_cast<float*>(grad), F, H, W, sx, sy, margin, neg_sigmainv, mm, k,
      bad);
  return static_cast<int>(cudaGetLastError());
}
