// The re-gather for Hopper (sm_90a): the forward and the backward of
// render/mesh/rasterization._interpolate_at_winners on the card. At every
// pixel the winner search hit, the winner's barycentrics are computed again
// from its scaled vertices, and its three vertices' features interpolated
// with them: (B, H, W, D) from face ids (B, H, W), scaled vertices
// (B, F, 3, 2) and features (B, F, 3, D), 0 at a miss.
//
// Replaces no TPU kernel. The JAX package re-gathers with one
// take_along_axis, which XLA fuses on the TPU. In the port that was a
// concatenated (B, F, 6 + 3D) table, one torch.gather of it per pixel and
// about 45 more launches forward (47 in all), and a scatter-add into the
// table's gradient with about 95 more launches backward: the DIB-R fit's
// largest device layer (5.1 ms a step at 8 views of 512² with 4,992 faces,
// 5.3 ms with 81,408, on an H100), its scatter-add the step's largest op.
// Every missed pixel's index was clamped to 0, so it gathered face 0's row,
// and its adds of zero all queued on that row's 6 + 3D addresses.
//
// What bounds it on this card. Bytes: the forward reads the ids (4 B a
// pixel) and the hit faces' 6 coordinates and 3D features, and writes D
// floats a pixel; the backward reads the ids, the output gradient (4D B a
// pixel) and the hit faces' coordinates and features, and writes the
// coordinates' gradient (24 B a face). On the DIB-R fit's own data (8 x
// 512² pixels, D = 3, about a quarter of them hit) that is 34 + 35 MB at
// 4,992 faces and 43 + 59 MB at 81,408, each byte counted once: 10 + 10
// and 13 + 17 µs at 3.35 TB/s. The backward's adds meet where neighbouring
// pixels share a face.
//
// The design:
// * regather_fwd_kernel, one block an 8 x 8 pixel tile of one view (as
//   kernels #1-3 map their blocks), one thread a pixel, so a warp's 4 x 8
//   pixels mostly read the same few faces. A hit reads the winner's 6
//   scaled coordinates and 3D features straight from their tensors: no
//   table and no (B, HW, 6 + 3D) intermediate. The pixel centre and the
//   barycentrics are rounded op for op as _pixel_coords and _barycentrics
//   round them (round-to-nearest intrinsics, and the library is built with
//   --fmad=false), the interpolation taken as (w0·f0 + w1·f1) + w2·f2, so
//   the output is the plain version's, bit for bit. D is a loop bound: any
//   number of channels.
// * regather_zero_kernel: the gradients' zero-fill.
// * regather_bwd_kernel, the same tiles and threads:
//   - A missed pixel adds nothing: the plain version's where() gives its
//     cotangent as exactly 0.
//   - A hit pixel whose output gradient is exactly 0 in every channel adds
//     nothing either: for finite inputs each of its adds would be ±0,
//     which leaves any sum as it is. A NaN is not 0, so it still
//     propagates. On the DIB-R fit about a quarter of the pixels add.
//   - Every other pixel computes the 6 coordinate gradients of w0, w1, w2
//     over norm in registers. The live pixels of a warp that share a face
//     (__match_any_sync on the face id) sum theirs in shared memory, and
//     the lowest of them adds the 6 sums into the coordinates' gradient
//     with atomicAdd whose result is unused (a RED). On the fit's own data
//     that took the backward from 0.107 to 0.059 device ms at 4,992 faces
//     (a visible face covers about 25 pixels of a view) and from 0.104 to
//     0.092 at 81,408 (about 1.5).
//   - Only where the features' gradient is asked for, each live pixel adds
//     its 3D feature gradients w_k·g, one RED each.
//   - The adds come in no fixed order, so the gradients repeat only to
//     rounding from launch to launch: float32 sums in any order.

#include <cuda_runtime.h>

#include <algorithm>

#include "tiles.cuh"

namespace {

using namespace kaolin_mesh;

constexpr int kTile = 8;
constexpr int kThreads = kTile * kTile;   // one thread a pixel of the tile
constexpr int kZeroThreads = 256;
constexpr int kZeroBlocks = 1024;         // most blocks of the zero-fill

// The winner's barycentrics at a pixel centre, as _barycentrics rounds
// them: the vertices' offsets from the centre, w0..w2 after the division,
// and the norm they were divided by.
struct Bary {
  float ax, ay, bx, by, cx, cy;
  float w0, w1, w2, norm;
};

__device__ __forceinline__ Bary barycentrics(const float* __restrict__ v,
                                             float px, float py, float eps) {
  Bary r;
  r.ax = __fsub_rn(__ldg(v + 0), px);
  r.ay = __fsub_rn(__ldg(v + 1), py);
  r.bx = __fsub_rn(__ldg(v + 2), px);
  r.by = __fsub_rn(__ldg(v + 3), py);
  r.cx = __fsub_rn(__ldg(v + 4), px);
  r.cy = __fsub_rn(__ldg(v + 5), py);
  const float w0 = __fsub_rn(__fmul_rn(r.bx, r.cy), __fmul_rn(r.by, r.cx));
  const float w1 = __fsub_rn(__fmul_rn(r.cx, r.ay), __fmul_rn(r.cy, r.ax));
  const float w2 = __fsub_rn(__fmul_rn(r.ax, r.by), __fmul_rn(r.ay, r.bx));
  const float norm = __fadd_rn(__fadd_rn(w0, w1), w2);
  r.norm = __fadd_rn(norm, norm >= 0.0f ? eps : -eps);
  r.w0 = __fdiv_rn(w0, r.norm);
  r.w1 = __fdiv_rn(w1, r.norm);
  r.w2 = __fdiv_rn(w2, r.norm);
  return r;
}

// This thread's pixel: its column and row in the block's tile of view
// blockIdx.z.
__device__ __forceinline__ int tile_col() {
  return blockIdx.x * kTile + threadIdx.x % kTile;
}
__device__ __forceinline__ int tile_row() {
  return blockIdx.y * kTile + threadIdx.x / kTile;
}

// face_idx (B, H, W); scaled (B, F, 3, 2); features: views feat_bstride
// floats apart, each (F, 3, D); out (B, H, W, D).
__global__ void __launch_bounds__(kThreads)
    regather_fwd_kernel(const int* __restrict__ face_idx,
                        const float* __restrict__ scaled,
                        const float* __restrict__ feats,
                        long long feat_bstride, float* __restrict__ out,
                        int F, int H, int W, int D, float sx, float sy,
                        float eps) {
  const int col = tile_col();
  const int row = tile_row();
  if (col >= W || row >= H) return;
  const int b = blockIdx.z;
  const long long p = (static_cast<long long>(b) * H + row) * W + col;
  float* o = out + p * D;
  const int f = __ldg(face_idx + p);
  if (f < 0) {
    for (int c = 0; c < D; ++c) o[c] = 0.0f;
    return;
  }
  const Bary w =
      barycentrics(scaled + (static_cast<long long>(b) * F + f) * 6,
                   pixel_x(col, W, sx), pixel_y(row, H, sy), eps);
  const float* fe =
      feats + b * feat_bstride + static_cast<long long>(f) * 3 * D;
  for (int c = 0; c < D; ++c) {
    o[c] = __fadd_rn(__fadd_rn(__fmul_rn(w.w0, __ldg(fe + c)),
                               __fmul_rn(w.w1, __ldg(fe + D + c))),
                     __fmul_rn(w.w2, __ldg(fe + 2 * D + c)));
  }
}

__device__ __forceinline__ void zero_floats(float* __restrict__ g,
                                            long long n, long long first,
                                            long long step) {
  if (g == nullptr) return;
  float4* g4 = reinterpret_cast<float4*>(g);   // the allocator's alignment
  for (long long i = first; i < n / 4; i += step) {
    g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (first < n % 4) g[n / 4 * 4 + first] = 0.0f;
}

__global__ void __launch_bounds__(kZeroThreads)
    regather_zero_kernel(float* __restrict__ gscaled, long long n_scaled,
                         float* __restrict__ gfeats, long long n_feats) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  zero_floats(gscaled, n_scaled, first, step);
  zero_floats(gfeats, n_feats, first, step);
}

// gout (B, H, W, D); gscaled (B, F, 3, 2) or null; gfeats (B, F, 3, D) or
// null.
__global__ void __launch_bounds__(kThreads)
    regather_bwd_kernel(const int* __restrict__ face_idx,
                        const float* __restrict__ scaled,
                        const float* __restrict__ feats,
                        long long feat_bstride,
                        const float* __restrict__ gout,
                        float* __restrict__ gscaled,
                        float* __restrict__ gfeats, int F, int H, int W,
                        int D, float sx, float sy, float eps) {
  const int col = tile_col();
  const int row = tile_row();
  const bool in = col < W && row < H;
  const int b = blockIdx.z;
  const long long p = (static_cast<long long>(b) * H + row) * W + col;
  const int f = in ? __ldg(face_idx + p) : -1;
  const float* g = gout + p * D;
  bool live = false;
  if (f >= 0) {
    for (int c = 0; c < D; ++c) live |= __ldg(g + c) != 0.0f;  // NaN: live
  }
  const unsigned live_lanes = __ballot_sync(kFullWarp, live);
  if (!live) return;

  const long long face = static_cast<long long>(b) * F + f;
  const Bary w = barycentrics(scaled + face * 6, pixel_x(col, W, sx),
                              pixel_y(row, H, sy), eps);
  const float* fe =
      feats + b * feat_bstride + static_cast<long long>(f) * 3 * D;
  float* gf = gfeats == nullptr ? nullptr : gfeats + face * 3 * D;
  // the cotangents of w0, w1, w2: the output's against each vertex's
  // features; and the features' own, w_k times the output's
  float gw0 = 0.0f, gw1 = 0.0f, gw2 = 0.0f;
  for (int c = 0; c < D; ++c) {
    const float gc = __ldg(g + c);
    gw0 += gc * __ldg(fe + c);
    gw1 += gc * __ldg(fe + D + c);
    gw2 += gc * __ldg(fe + 2 * D + c);
    if (gf != nullptr) {
      atomicAdd(gf + c, w.w0 * gc);
      atomicAdd(gf + D + c, w.w1 * gc);
      atomicAdd(gf + 2 * D + c, w.w2 * gc);
    }
  }
  if (gscaled == nullptr) return;
  // w_k = W_k / norm with norm = W0 + W1 + W2 ± eps: W_k's cotangent is
  // gw_k / norm plus norm's, −(gw0 w0 + gw1 w1 + gw2 w2) / norm
  const float gnorm = -(gw0 * w.w0 + gw1 * w.w1 + gw2 * w.w2) / w.norm;
  const float g0 = gw0 / w.norm + gnorm;
  const float g1 = gw1 / w.norm + gnorm;
  const float g2 = gw2 / w.norm + gnorm;
  // W0 = bx cy − by cx, W1 = cx ay − cy ax, W2 = ax by − ay bx; the
  // vertices are the offsets plus the pixel centre
  float d[6] = {g2 * w.by - g1 * w.cy, g1 * w.cx - g2 * w.bx,
                g0 * w.cy - g2 * w.ay, g2 * w.ax - g0 * w.cx,
                g1 * w.ay - g0 * w.by, g0 * w.bx - g1 * w.ax};
  // the warp's live pixels of this face, in lane order: the first sums
  __shared__ float s_d[6][kThreads];
  const unsigned peers = __match_any_sync(live_lanes, f);
#pragma unroll
  for (int k = 0; k < 6; ++k) s_d[k][threadIdx.x] = d[k];
  __syncwarp(live_lanes);
  const int lane = threadIdx.x & 31;
  if (lane != __ffs(peers) - 1) return;
  const int base = threadIdx.x - lane;
  for (unsigned m = peers & (peers - 1); m != 0u; m &= m - 1) {
    const int j = base + __ffs(m) - 1;
#pragma unroll
    for (int k = 0; k < 6; ++k) d[k] += s_d[k][j];
  }
  float* gs = gscaled + face * 6;
#pragma unroll
  for (int k = 0; k < 6; ++k) atomicAdd(gs + k, d[k]);
}

dim3 tile_grid(int B, int H, int W) {
  return dim3((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
}

}  // namespace

// face_idx: (B, H, W) int32; scaled: (B, F, 3, 2); feats: B views
// feat_bstride floats apart, each (F, 3, D); out: (B, H, W, D).
extern "C" int kaolin_regather_fwd(const void* face_idx, const void* scaled,
                                   const void* feats, long long feat_bstride,
                                   void* out, int B, int F, int H, int W,
                                   int D, float sx, float sy, float eps,
                                   void* stream) {
  if (static_cast<long long>(B) * H * W == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  regather_fwd_kernel<<<tile_grid(B, H, W), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(face_idx), static_cast<const float*>(scaled),
      static_cast<const float*>(feats), feat_bstride,
      static_cast<float*>(out), F, H, W, D, sx, sy, eps);
  return static_cast<int>(cudaGetLastError());
}

// gout: (B, H, W, D); gscaled: (B, F, 3, 2) or null; gfeats: (B, F, 3, D)
// or null. The zero-fill launches where there is a gradient to zero.
extern "C" int kaolin_regather_bwd(const void* face_idx, const void* scaled,
                                   const void* feats, long long feat_bstride,
                                   const void* gout, void* gscaled,
                                   void* gfeats, int B, int F, int H, int W,
                                   int D, float sx, float sy, float eps,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gs = static_cast<float*>(gscaled);
  float* gf = static_cast<float*>(gfeats);
  const long long faces = static_cast<long long>(B) * F;
  const long long n_scaled = gs == nullptr ? 0 : faces * 6;
  const long long n_feats = gf == nullptr ? 0 : faces * 3 * D;
  if (n_scaled + n_feats > 0) {
    const long long quads = (std::max(n_scaled, n_feats) + 3) / 4;
    const int blocks = static_cast<int>(std::max(
        1ll, std::min<long long>((quads + kZeroThreads - 1) / kZeroThreads,
                                 kZeroBlocks)));
    regather_zero_kernel<<<blocks, kZeroThreads, 0, st>>>(
        gs, n_scaled, gf, n_feats);
  }
  if (static_cast<long long>(B) * H * W == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  regather_bwd_kernel<<<tile_grid(B, H, W), kThreads, 0, st>>>(
      static_cast<const int*>(face_idx), static_cast<const float*>(scaled),
      static_cast<const float*>(feats), feat_bstride,
      static_cast<const float*>(gout), gs, gf, F, H, W, D, sx, sy, eps);
  return static_cast<int>(cudaGetLastError());
}
