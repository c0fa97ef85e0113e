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
// What bounds the forward on this card: one exp and about 100 ALU
// operations (ten divisions among them) per (pixel, face) pair in the box,
// and on the DIB-R path only the pairs at pixels the rasterizer leaves
// uncovered matter (180,192 of config 2's 2,146,992); its bytes are those
// of the faces, the ids read and allprob written. What costs is finding
// the pairs: a busy 16 x 16 tile holds 51 of config 2's 4,992 faces on
// average.
//
// The forward (soft_fwd_box_kernel, then soft_fwd_kernel):
// * soft_fwd_box_kernel, one thread a face: each face's box enlarged by the
//   margin, and each group of 32 faces' box (tiles.cuh, face_boxes).
// * soft_fwd_kernel, one block an 8 x 8 tile, four threads a pixel: the
//   block builds the tile's ascending list of the faces whose enlarged box
//   meets the tile's rectangle (tiles.cuh, walk_tile_faces). The closed
//   test never drops a face the half-open per-pixel test would keep, so
//   the list is exact, and it needs no capacity: it takes the place of
//   pack_faces/chunk_occupancy and of the TPU's face-count limit. 8 x 8
//   tiles with four threads a pixel were the fastest of the shapes timed on
//   the card (16 x 16 with one, two or four threads, 8 x 8 with one to
//   eight, 4 x 4 with four or eight): the time is the blocks' latency, and
//   small tiles list fewer faces and leave fewer busy blocks.
// * The thread that stages a listed face computes its terms once
//   (face_terms: per edge A, B, C, their products and den) and stores them
//   in shared memory beside the box, 40 floats a face; the pair loop reads
//   them. The same code on the same inputs, so the same bits as computing
//   them for every pair.
// * face_idx (optional, the rasterizer's (B, H, W) ids): where an id is
//   >= 0 the kernel writes 1.0 and computes nothing. The DIB-R mask is 1
//   there whatever allprob is (dibr.dibr_soft_mask), so the cotangent that
//   reaches allprob there is 0 and ga = 0 * 1 = 0, as before. The block's
//   pixels to compute are compacted with a ballot, so a tile whose pixels
//   are all covered returns after one vote, and the others give their
//   threads only to the uncovered pixels. Without face_idx every pixel is
//   computed.
// * Four threads a pixel (kSoftSplit): thread k of a pixel takes list
//   entries k, k + 4, ..., multiplying each factor in as it comes, and the
//   four partial products are multiplied in a fixed tree over the lanes,
//   (P0 P1)(P2 P3), with xor-shuffles (float products commute bit for bit,
//   so all four lanes agree). That is not the order of torch.prod in the
//   plain version: the two agree within 1e-5. The list, its flushes and so
//   the lanes' shares do not depend on face_idx or on the launch, so a
//   pixel's allprob is bitwise the same with and without face_idx, and
//   from launch to launch.
// * It keeps a running product of (1 - p), as the reference CUDA kernel and
//   the all-faces plain version do; the TPU kernel's exp(sum log(1 - p)) was
//   a Mosaic workaround.
//
// The backward is face-major, in four launches, with no atomics:
// * soft_bwd_count_kernel, one thread a face: the exact pixel range of the
//   face's enlarged box in the image (pixel_range).
// * soft_bwd_plan_kernel (one block) cuts each face's pixels, in row-major
//   order, into bands of at most band_px = 4,096 (128 steps of a warp),
//   numbers the bands with a block-wide scan and lists the (face, band) of
//   every band slot. A face that covers a 512x512 image takes 64 warps, not
//   one warp 8,192 steps. Should the bands outgrow the slots the wrapper
//   allocated, the bands double until they fit.
// * soft_bwd_kernel: a persistent grid of warps takes the bands in turn. A
//   warp computes its face's terms once (per edge A, B, C, their products
//   and den), then walks its band 4 x 32 pixels at a time, reading ga from
//   L2. A pair whose ga is 0 is skipped: for finite vertices every term of
//   the pair is finite, so its cotangent c is 0 and it would add +0 or -0
//   to each sum, which leaves the sum as it is. On the DIB-R path ga is 0
//   at every pixel the rasterizer covers (the mask is 1 there), which is
//   most pairs: 180,192 of config 2's 2,146,992 carry a cotangent. The
//   live pixels of the 4 steps are found with ballots and handed to the
//   lanes in order, so a lane that computes always has a pair. Each lane
//   sums its pairs' 6 partials in registers; the warp reduces them once
//   with shuffles and lane 0 stores the band's 6 sums.
// * soft_bwd_sum_kernel adds each face's bands in band order.
// Every sum is taken in an order fixed by the inputs alone, so the gradient
// is bitwise the same from launch to launch. Against the plain version,
// whose autograd sums in another order, it agrees to 1e-4 of its largest
// entry.
//
// Both passes share the pair arithmetic (face_terms, pair_candidates), so
// the backward's tie test cand == d2 sees the forward's values, and the
// library is compiled with --fmad=false so they also equal the plain
// PyTorch version's. Tied minima share the cotangent evenly, as torch.amin
// and jnp.min do.

#include <cuda_runtime.h>

#include "tiles.cuh"

namespace {

using namespace kaolin_mesh;

constexpr int kBandPx = 4096;        // pixels of one band, at most
constexpr int kPlanThreads = 1024;   // the plan block
constexpr int kBandThreads = 256;    // blocks of the band pass
constexpr int kFlatThreads = 256;    // blocks of the count and sum passes
constexpr int kUnroll = 4;           // steps of the band pass loaded at once
constexpr int kPlanTile = 8192;      // faces in the plan's shared memory

// What depends on the face alone, per edge i from vertex i to vertex i + 1,
// each computed as dibr._edge_vertex_sqdist computes it.
struct Face {
  float v[6];
  float A[3], B[3], C[3], AA[3], BB[3], AB[3], AC[3], BC[3], den[3];
};

__device__ __forceinline__ Face face_terms(const float v[6]) {
  Face f;
#pragma unroll
  for (int k = 0; k < 6; ++k) f.v[k] = v[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i2 = (i + 1) % 3;
    const float x1 = v[2 * i], y1 = v[2 * i + 1];
    const float x2 = v[2 * i2], y2 = v[2 * i2 + 1];
    const float A = y2 - y1;
    const float B = x1 - x2;
    f.A[i] = A;
    f.B[i] = B;
    f.C[i] = x2 * y1 - x1 * y2;
    f.AA[i] = A * A;
    f.BB[i] = B * B;
    f.AB[i] = A * B;
    f.AC[i] = A * f.C[i];
    f.BC[i] = B * f.C[i];
    f.den[i] = (f.AA[i] + f.BB[i]) + 1e-10f;
  }
  return f;
}

// dibr._edge_vertex_sqdist at one pixel, op for op: the 6 candidates, each
// edge's `up` (which the gradient needs), and the least candidate.
__device__ __forceinline__ float pair_candidates(float px, float py,
                                                 const Face& f, float bad,
                                                 float cand[6], float up[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i2 = (i + 1) % 3;
    const float x1 = f.v[2 * i], y1 = f.v[2 * i + 1];
    const float x2 = f.v[2 * i2], y2 = f.v[2 * i2 + 1];
    up[i] = f.A[i] * px + f.B[i] * py + f.C[i];
    const float x3 = (f.BB[i] * px - f.AB[i] * py - f.AC[i]) / f.den[i];
    const float y3 = (f.AA[i] * py - f.AB[i] * px - f.BC[i]) / f.den[i];
    const float direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2);
    cand[i] = direct > 0.f ? bad : up[i] * up[i] / f.den[i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dx = px - f.v[2 * j];
    const float dy = py - f.v[2 * j + 1];
    cand[3 + j] = dx * dx + dy * dy;
  }
  float d2 = cand[0];
#pragma unroll
  for (int q = 1; q < 6; ++q) d2 = fminf(d2, cand[q]);
  return d2;
}

constexpr int kSoftTile = 8;   // the forward's tile side, pixels
constexpr int kSoftSplit = 4;  // the forward's threads a pixel

// One listed face as the forward's pair loop reads it: ten float4.
struct alignas(16) SoftFace {
  Box box;  // enlarged by the margin
  Face face;
  float pad[3];
};
static_assert(sizeof(SoftFace) == 160, "ten float4");

// The face terms of a staged face, read as nine float4.
__device__ __forceinline__ Face load_face(const SoftFace* e) {
  const float4* q = reinterpret_cast<const float4*>(e) + 1;
  float w[36];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 t = q[i];
    w[4 * i] = t.x;
    w[4 * i + 1] = t.y;
    w[4 * i + 2] = t.z;
    w[4 * i + 3] = t.w;
  }
  Face f;
#pragma unroll
  for (int k = 0; k < 6; ++k) f.v[k] = w[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.A[i] = w[6 + i];
    f.B[i] = w[9 + i];
    f.C[i] = w[12 + i];
    f.AA[i] = w[15 + i];
    f.BB[i] = w[18 + i];
    f.AB[i] = w[21 + i];
    f.AC[i] = w[24 + i];
    f.BC[i] = w[27 + i];
    f.den[i] = w[30 + i];
  }
  return f;
}

template <int NT, int K>
struct SoftFlush {
  const float* __restrict__ fvi;  // this batch element's (F, 3, 2)
  SoftFace* s_face;
  float margin, px, py, neg_sigmainv, mm, bad;
  bool active;
  int lane;
  float ap;

  __device__ __forceinline__ void operator()(const int* ids, int n) {
    for (int j = threadIdx.x; j < n; j += NT) {
      float v[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        v[k] = fvi[static_cast<size_t>(ids[j]) * 6 + k];
      }
      s_face[j].box = face_box(v, margin);
      s_face[j].face = face_terms(v);
    }
    __syncthreads();
    if (active) {
      const float4* q = reinterpret_cast<const float4*>(s_face);
      for (int j = lane; j < n; j += K) {
        // the per-pixel test of dibr.soft_mask_plain: half open
        const float4 box = q[10 * j];
        if (!(px >= box.x && px < box.y && py >= box.z && py < box.w)) {
          continue;
        }
        float cand[6], up[3];
        const float d2 =
            pair_candidates(px, py, load_face(s_face + j), bad, cand, up);
        ap *= 1.f - expf(neg_sigmainv * d2 / mm);
      }
    }
    __syncthreads();  // the staged faces are no longer read
  }
};

__global__ void __launch_bounds__(kBoxThreads)
soft_fwd_box_kernel(const float* __restrict__ fvi, float4* __restrict__ boxes,
                    float4* __restrict__ groups, int F, float margin) {
  face_boxes(fvi, nullptr, boxes, groups, F, margin);
}

// Dynamic shared memory: kList SoftFace, ListSmem<NT>, then the tile's
// pixels to compute (TILE x TILE ints).
template <int TILE, int K>
__global__ void __launch_bounds__(TILE * TILE * K)
soft_fwd_kernel(const float* __restrict__ fvi,      // (B, F, 3, 2), scaled
                const float4* __restrict__ boxes,   // (B, F)
                const float4* __restrict__ groups,  // (B, G)
                const int* __restrict__ face_idx,   // (B, H, W) or null
                float* __restrict__ allprob,        // (B, H, W)
                int F, int H, int W, float sx, float sy, float margin,
                float neg_sigmainv, float mm, float bad) {
  constexpr int NT = TILE * TILE * K;
  extern __shared__ float4 smem[];
  SoftFace* s_face = reinterpret_cast<SoftFace*>(smem);
  ListSmem<NT>* s_list = reinterpret_cast<ListSmem<NT>*>(s_face + kList);
  int* s_pix = reinterpret_cast<int*>(s_list + 1);

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = (F + kGroup - 1) / kGroup;
  groups += static_cast<size_t>(b) * G;
  const int r0 = blockIdx.y * TILE;
  const int c0 = blockIdx.x * TILE;
  const size_t img = static_cast<size_t>(b) * H * W;
  // the tile's in-image pixels that no face covers, in order
  bool need = false;
  if (tid < TILE * TILE) {
    const int row = r0 + tid / TILE;
    const int col = c0 + tid % TILE;
    if (row < H && col < W) {
      const size_t o = img + static_cast<size_t>(row) * W + col;
      if (face_idx != nullptr && face_idx[o] >= 0) {
        allprob[o] = 1.f;
      } else {
        need = true;
      }
    }
  }
  const int n_pix = append_ordered<NT>(need, tid, s_pix, 0,
                                       s_list->warp_count);
  if (n_pix == 0) return;  // the same for the whole block

  const int item = tid / K;
  const bool active = item < n_pix;
  const int p = active ? s_pix[item] : 0;
  const int row = r0 + p / TILE;
  const int col = c0 + p % TILE;
  SoftFlush<NT, K> flush{fvi + static_cast<size_t>(b) * F * 6,
                         s_face,
                         margin,
                         pixel_x(col, W, sx),
                         pixel_y(row, H, sy),
                         neg_sigmainv,
                         mm,
                         bad,
                         active,
                         tid % K,
                         1.f};
  walk_tile_faces<NT>(boxes + static_cast<size_t>(b) * F, groups, F,
                      tile_rect<TILE>(H, W, sx, sy), *s_list, flush);
  // the K partial products, multiplied in a fixed tree over the lanes
  float ap = flush.ap;
#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
    ap *= __shfl_xor_sync(kFullWarp, ap, off);
  }
  if (active && tid % K == 0) {
    allprob[img + static_cast<size_t>(row) * W + col] = ap;
  }
}

// The in-image pixels in a face's enlarged box: columns c0 .. c0 + nc - 1
// and rows r0 .. r0 + count / nc - 1. pixel_x rises with the column and
// pixel_y falls with the row (a positive float times an exact integer), so
// the plain version's half-open test holds on an interval of columns times
// an interval of rows. The real range from inverting them, widened by two
// pixels on each side and clipped to the image, holds those intervals; each
// side is then moved in, column by column and row by row, to the first
// that passes the test. So every pixel of the range is in the box and every
// pixel in the box is in the range: the pairs are exactly the plain
// version's.
struct Range {
  int c0, r0, nc, count;
};

__device__ __forceinline__ int clip_index(float x, int n) {
  return static_cast<int>(fminf(fmaxf(x, -1.f), static_cast<float>(n)));
}

__device__ __forceinline__ Range pixel_range(const Box& box, int H, int W,
                                             float sx, float sy) {
  int c0 = max(clip_index(ceilf((box.x_lo / sx + (W - 1)) * 0.5f) - 2.f, W), 0);
  int c1 = min(clip_index(floorf((box.x_hi / sx + (W - 1)) * 0.5f) + 2.f, W),
               W - 1);
  int r0 =
      max(clip_index(floorf(((H - 1) - box.y_hi / sy) * 0.5f) - 1.f, H), 0);
  int r1 = min(clip_index(floorf(((H - 1) - box.y_lo / sy) * 0.5f) + 2.f, H),
               H - 1);
  while (c0 <= c1 && !(pixel_x(c0, W, sx) >= box.x_lo)) ++c0;
  while (c1 >= c0 && !(pixel_x(c1, W, sx) < box.x_hi)) --c1;
  while (r0 <= r1 && !(pixel_y(r0, H, sy) < box.y_hi)) ++r0;
  while (r1 >= r0 && !(pixel_y(r1, H, sy) >= box.y_lo)) --r1;
  const int nc = c1 - c0 + 1;
  const int nr = r1 - r0 + 1;
  return Range{c0, r0, nc, nc > 0 && nr > 0 ? nc * nr : 0};
}

// The in-image pixels of each face's enlarged box, one thread a face:
// ranges[i] = (c0, r0, nc, count) of pixel_range.
__global__ void soft_bwd_count_kernel(const float* __restrict__ fvi,
                                      int4* __restrict__ ranges,  // (B*F,)
                                      int BF, int H, int W, float sx,
                                      float sy, float margin) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BF) return;
  float v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = fvi[static_cast<size_t>(i) * 6 + k];
  const Range r = pixel_range(face_box(v, margin), H, W, sx, sy);
  ranges[i] = make_int4(r.c0, r.r0, r.nc, r.count);
}

// One block: each face's band count, their exclusive scan (each face's
// first band slot), the (face, band) of every slot, and meta = (bands,
// band_px). The faces go through shared memory kPlanTile at a time, read
// in one coalesced sweep; thread t then takes consecutive faces, so one
// block-wide scan of the threads' sums numbers a tile's bands. Slots past
// cap are not written: the plan then starts again with bands twice as
// large.
__global__ void __launch_bounds__(kPlanThreads)
soft_bwd_plan_kernel(const int4* __restrict__ ranges,  // (B*F,)
                     int* __restrict__ first,          // (B*F,)
                     int* __restrict__ nbands,         // (B*F,)
                     int2* __restrict__ slots,         // (cap,)
                     int* __restrict__ meta,           // (2,)
                     int BF, int cap) {
  __shared__ int s_nb[kPlanTile];
  __shared__ int s_warp[kPlanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int band_px = kBandPx;
  int total;
  for (;;) {
    total = 0;
    for (int t0 = 0; t0 < BF; t0 += kPlanTile) {
      const int nt = min(kPlanTile, BF - t0);
      for (int j = tid; j < nt; j += kPlanThreads) {
        s_nb[j] = (ranges[t0 + j].w + band_px - 1) / band_px;
      }
      __syncthreads();
      const int per = (nt + kPlanThreads - 1) / kPlanThreads;
      const int f0 = min(tid * per, nt);
      const int f1 = min(f0 + per, nt);
      int mine = 0;
      for (int j = f0; j < f1; ++j) mine += s_nb[j];
      int incl = mine;  // inclusive scan over the warp, then over the warps
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFullWarp, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) s_warp[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        int w = s_warp[lane];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(kFullWarp, w, off);
          if (lane >= off) w += y;
        }
        s_warp[lane] = w;
      }
      __syncthreads();
      int slot = total + (warp > 0 ? s_warp[warp - 1] : 0) + incl - mine;
      for (int j = f0; j < f1; ++j) {
        const int nb = s_nb[j];
        first[t0 + j] = slot;
        nbands[t0 + j] = nb;
        for (int b = 0; b < nb && slot + b < cap; ++b) {
          slots[slot + b] = make_int2(t0 + j, b);
        }
        slot += nb;
      }
      total += s_warp[kPlanThreads / 32 - 1];
      __syncthreads();  // s_nb and s_warp are written again
    }
    if (total <= cap) break;  // the same for the whole block
    band_px *= 2;
  }
  if (tid == 0) {
    meta[0] = total;
    meta[1] = band_px;
  }
}

// The position of the n-th (from 0) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const unsigned below = m & ((2u << (pos + step - 1)) - 1u);
    if (__popc(below) <= n) pos += step;
  }
  return pos;
}

// The analytic VJP of one (pixel, face) pair, added to the lane's 6 running
// sums.
__device__ __forceinline__ void add_pair_vjp(float px, float py, float g,
                                             const Face& f, float bad,
                                             float neg_sigmainv, float mm,
                                             float k, float acc[6]) {
  float cand[6], up[3];
  const float d2 = pair_candidates(px, py, f, bad, cand, up);
  const float p = expf(neg_sigmainv * d2 / mm);
  float ties = 0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) ties += cand[q] == d2 ? 1.f : 0.f;
  // d allprob / d p = -allprob / (1 - p); d p / d d2 = -k p
  const float c = g / fmaxf(1.f - p, 1e-12f) * k * p / ties;
  float gv[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    if (cand[e] != d2) continue;
    // d perp / d theta = (2 up d up - perp d down) / den
    const int e2 = (e + 1) % 3;
    const float x1 = f.v[2 * e], y1 = f.v[2 * e + 1];
    const float x2 = f.v[2 * e2], y2 = f.v[2 * e2 + 1];
    const float A = f.A[e], B = f.B[e], u = up[e];
    const float perp = u * u / f.den[e];
    const float w = c / f.den[e];
    gv[2 * e] += w * (2.f * u * (py - y2) - perp * (2.f * B));
    gv[2 * e + 1] += w * (2.f * u * (x2 - px) + perp * (2.f * A));
    gv[2 * e2] += w * (2.f * u * (y1 - py) + perp * (2.f * B));
    gv[2 * e2 + 1] += w * (2.f * u * (px - x1) - perp * (2.f * A));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (cand[3 + q] != d2) continue;
    gv[2 * q] += -2.f * c * (px - f.v[2 * q]);
    gv[2 * q + 1] += -2.f * c * (py - f.v[2 * q + 1]);
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) acc[q] += gv[q];
}

// A persistent grid of warps; warp w takes band slots w, w + warps, ...
// A warp loads kUnroll steps of 32 pixels of ga at once, finds the pixels
// whose cotangent is not 0 with one ballot per step, and hands them out to
// its lanes in order (the r-th to lane r % 32), so that every lane that
// computes has a pair.
__global__ void __launch_bounds__(kBandThreads)
soft_bwd_kernel(const float* __restrict__ fvi,     // (B*F, 3, 2), scaled
                const float* __restrict__ ga,      // (B, H, W)
                const int4* __restrict__ ranges,   // (B*F,)
                const int2* __restrict__ slots,    // (cap,)
                const int* __restrict__ meta,      // (2,)
                float* __restrict__ partial,       // (cap, 6)
                int F, int H, int W, float sx, float sy, float neg_sigmainv,
                float mm, float k, float bad) {
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const int bands = meta[0];
  const int band_px = meta[1];
  for (int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; s < bands;
       s += warps) {
    const int2 slot = slots[s];
    const int4 r = ranges[slot.x];  // c0, r0, nc, count
    float v[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) v[q] = fvi[static_cast<size_t>(slot.x) * 6 + q];
    const Face f = face_terms(v);
    const float* g_img = ga + static_cast<size_t>(slot.x / F) * H * W;
    const int end = min(r.w, (slot.y + 1) * band_px);

    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int base = slot.y * band_px; base < end; base += kUnroll * 32) {
      float gs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * 32 + lane;
        gs[u] = i < end ? g_img[static_cast<size_t>(r.y + i / r.z) * W +
                                r.x + i % r.z]
                        : 0.f;
      }
      unsigned live[kUnroll];
      int n_live = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // a pair whose cotangent is 0 adds +-0 to every sum
        live[u] = __ballot_sync(kFullWarp, gs[u] != 0.f);
        n_live += __popc(live[u]);
      }
      for (int r0 = 0; r0 < n_live; r0 += 32) {
        // the (r0 + lane)-th live pixel: its step u and the lane that holds it
        int n = r0 + lane, u_live = kUnroll;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int c = __popc(live[u]);
          if (u_live == kUnroll) {
            if (n < c) {
              u_live = u;
            } else {
              n -= c;
            }
          }
        }
        const int src = u_live < kUnroll ? nth_set_bit(live[u_live], n) : 0;
        float g = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float gu = __shfl_sync(kFullWarp, gs[u], src);
          if (u == u_live) g = gu;
        }
        if (u_live < kUnroll) {
          const int i = base + u_live * 32 + src;
          add_pair_vjp(pixel_x(r.x + i % r.z, W, sx),
                       pixel_y(r.y + i / r.z, H, sy), g, f, bad,
                       neg_sigmainv, mm, k, acc);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[q] += __shfl_down_sync(kFullWarp, acc[q], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        partial[static_cast<size_t>(s) * 6 + q] = acc[q];
      }
    }
  }
}

// grad[face][q] = the face's band sums, in band order (0 without a band).
__global__ void soft_bwd_sum_kernel(const int* __restrict__ first,
                                    const int* __restrict__ nbands,
                                    const float* __restrict__ partial,
                                    float* __restrict__ grad, int BF) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BF * 6) return;
  const int face = i / 6;
  const int q = i - face * 6;
  const int s0 = first[face];
  float sum = 0.f;
  for (int j = 0; j < nbands[face]; ++j) {
    sum += partial[static_cast<size_t>(s0 + j) * 6 + q];
  }
  grad[i] = sum;
}

// Blocks of the band pass: as many as fit on the card at once.
cudaError_t band_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, soft_bwd_kernel, kBandThreads, 0);
  }
  if (err == cudaSuccess && sms * per_sm == 0) {
    err = cudaErrorInvalidConfiguration;
  }
  *blocks = sms * per_sm;
  return err;
}

template <int TILE, int K>
int launch_soft_fwd(const void* fvi, const void* face_idx, void* work,
                    void* allprob, int B, int F, int H, int W, float sx,
                    float sy, float margin, float neg_sigmainv, float mm,
                    float bad, void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  constexpr int NT = TILE * TILE * K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(fvi);
  float4* boxes = static_cast<float4*>(work);
  float4* groups = boxes + static_cast<size_t>(B) * F;
  if (F > 0) {
    soft_fwd_box_kernel<<<dim3((F + kBoxThreads - 1) / kBoxThreads, B),
                          kBoxThreads, 0, st>>>(v, boxes, groups, F, margin);
  }
  const size_t smem = kList * sizeof(SoftFace) + sizeof(ListSmem<NT>) +
                      TILE * TILE * sizeof(int);
  const auto kernel = soft_fwd_kernel<TILE, K>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B), NT, smem,
           st>>>(v, boxes, groups, static_cast<const int*>(face_idx),
                 static_cast<float*>(allprob), F, H, W, sx, sy, margin,
                 neg_sigmainv, mm, bad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// work: (B * F + B * ceil(F / 32)) float4, the face and group boxes;
// face_idx: (B, H, W) int32 or null.
extern "C" int kaolin_soft_mask_fwd(const void* fvi, const void* face_idx,
                                    void* work, void* allprob, int B, int F,
                                    int H, int W, float sx, float sy,
                                    float margin, float neg_sigmainv, float mm,
                                    float bad, void* stream) {
  return launch_soft_fwd<kSoftTile, kSoftSplit>(
      fvi, face_idx, work, allprob, B, F, H, W, sx, sy, margin, neg_sigmainv,
      mm, bad, stream);
}

// work, int32 words: ranges (4 B*F), first (B*F), nbands (B*F), meta (2),
// slots (2 cap), then cap x 6 float32 band sums.
extern "C" int kaolin_soft_mask_bwd(const void* fvi, const void* ga,
                                    void* grad, void* work, int B, int F,
                                    int H, int W, int cap, float sx, float sy,
                                    float margin, float neg_sigmainv, float mm,
                                    float k, float bad, void* stream) {
  const int BF = B * F;
  if (BF == 0) return static_cast<int>(cudaGetLastError());
  int blocks = 0;
  const cudaError_t err = band_blocks(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int4* ranges = static_cast<int4*>(work);
  int* first = reinterpret_cast<int*>(ranges + BF);
  int* nbands = first + BF;
  int* meta = nbands + BF;
  int2* slots = reinterpret_cast<int2*>(meta + 2);
  float* partial = reinterpret_cast<float*>(slots + cap);
  const float* v = static_cast<const float*>(fvi);
  soft_bwd_count_kernel<<<(BF + kFlatThreads - 1) / kFlatThreads,
                          kFlatThreads, 0, st>>>(v, ranges, BF, H, W, sx, sy,
                                                 margin);
  soft_bwd_plan_kernel<<<1, kPlanThreads, 0, st>>>(ranges, first, nbands,
                                                   slots, meta, BF, cap);
  soft_bwd_kernel<<<blocks, kBandThreads, 0, st>>>(
      v, static_cast<const float*>(ga), ranges, slots, meta, partial, F, H, W,
      sx, sy, neg_sigmainv, mm, k, bad);
  soft_bwd_sum_kernel<<<(BF * 6 + kFlatThreads - 1) / kFlatThreads,
                        kFlatThreads, 0, st>>>(first, nbands, partial,
                                               static_cast<float*>(grad), BF);
  return static_cast<int>(cudaGetLastError());
}
