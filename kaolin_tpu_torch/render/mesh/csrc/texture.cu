// Texture sampling for Hopper (sm_90a): the forward and the backward of
// render/mesh/utils.texture_mapping, bilinear and nearest, on the port's
// layout: UVs (B, N, 2) at a uniform pixel stride, a texture (B or 1, C,
// H', W') whose channel planes are contiguous, samples (B, N, C).
//
// Replaces no TPU kernel. The JAX package (kaolin_tpu/render/mesh/utils.py,
// _grid_sample_2d) samples with four plain gathers, which XLA fuses on the
// TPU. In the port those were four torch.gather launches and about 59
// elementwise ones forward, and four scatter-adds into zeroed (B, C, H'·W')
// tensors with about 66 more launches backward, then the views' sum of an
// expanded texture: the largest device time of the DIB-R fit (5.9 ms a step
// at 8 views of 512² with a 3 x 256² texture, 7.6 ms with a 3 x 1,024² one,
// on an H100). This pair makes one launch forward and two backward.
//
// What bounds it on this card. Bytes: the forward reads the UVs (8 B a
// pixel) and the texture once and writes the samples (4C B a pixel); the
// backward reads the output gradient (4C), the UVs and the texture, and
// writes the UVs' gradient (8) and the texture's gradient once. At
// P = 8 x 512² pixels and C = 3 that is 42.8 + 60.4 MB with the 256²
// texture and 54.6 + 84.0 MB with the 1,024² one: 31 and 41 µs at
// 3.35 TB/s. The backward's real limit is not bytes but atomics: 4C adds a
// pixel into the texture's gradient, which meet in L2 where neighbouring
// pixels share a texel (a texel of the 256² texture takes about 40 adds
// over 8 views of the fit).
//
// The design:
// * texture_fwd_kernel, one thread a (view, pixel): the UV pair, the clip
//   to [0, 1], the y flip and the align_corners=False border mapping, the
//   taps and weights, all C channels, written as (B, N, C). Every value is
//   rounded op for op as _grid_sample_2d rounds it (the library is built
//   with --fmad=false), the sum v00·(1−tx)·(1−ty) + v01·tx·(1−ty) +
//   v10·(1−tx)·ty + v11·tx·ty taken left to right, so the samples are the
//   plain version's bits. The texture is read through L2 (0.8 and 12.6 MB
//   at the fit's sizes, inside its 50 MB).
// * texture_zero_kernel: the texture gradient's zero-fill.
// * texture_bwd_kernel, one thread a (view, pixel):
//   - A pixel whose output gradient is exactly 0 in every channel adds
//     nothing to the texture and writes a UV gradient of +0. For finite UVs
//     and texture each of its adds would be ±0, which leaves any sum as it
//     is, and its UV gradient is a sum of zeros: skipping is exact. A NaN
//     is not 0, so it still propagates. On the DIB-R fit these are the
//     pixels the rasterizer missed, about 70% of them: the loss multiplies
//     the samples by the mask, and the rasterizer's UV of 0 there clips all
//     four taps onto one texel, (H' − 1, 0), where the plain backward's
//     scatter-adds of zeros queued on three addresses. A warp with no live
//     pixel (a ballot) leaves once it has written its UV gradients.
//   - Every other pixel adds its 4 taps x C channels into the texture's
//     gradient with atomicAdd whose result is unused (a RED), and computes
//     its UV gradient in registers, with jnp.clip's half gradient at
//     exactly 0 and 1 (utils/numerics.clip) and 0 outside, stored with no
//     atomic.
//   - Where the texture's batch stride is 0 (one texture that every view
//     shares), every view adds into one (C, H', W') gradient; else each
//     view into its own slice of (B, C, H', W').
//   - The atomics add in no fixed order, so the texture's gradient repeats
//     only to rounding from launch to launch. A texel-sorted order would
//     repeat bit for bit, at the cost of a sort's launches in a loop whose
//     host sets the pace.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kZeroBlocks = 1024;   // most blocks of the zero-fill's grid
constexpr unsigned kFullWarp = 0xffffffffu;

// torch.minimum(torch.maximum(a, 0), 1): a NaN stays a NaN.
__device__ __forceinline__ float clip01(float a) {
  return a < 0.0f ? 0.0f : (a > 1.0f ? 1.0f : a);
}

// The gradient ``g`` of clip01(a) passed to ``a`` as jnp.clip passes it:
// all of it inside (0, 1), half at exactly 0 or 1, none outside.
__device__ __forceinline__ float clip_grad(float a, float g) {
  if (a > 0.0f && a < 1.0f) return g;
  return (a == 0.0f || a == 1.0f) ? 0.5f * g : 0.0f;
}

// A UV pair → texel coordinates (x right, y down), as texture_mapping maps
// it: the clip, [0, 1] → [-1, 1] with v flipped, then align_corners=False.
__device__ __forceinline__ void texel_coords(float u, float v, int H, int W,
                                             float* x, float* y) {
  const float cx = clip01(u) * 2.0f - 1.0f;
  const float cy = (clip01(v) * 2.0f - 1.0f) * -1.0f;
  *x = (cx + 1.0f) * (static_cast<float>(W) * 0.5f) - 0.5f;
  *y = (cy + 1.0f) * (static_cast<float>(H) * 0.5f) - 0.5f;
}

__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The four border-clamped taps in a channel plane, and the fractions.
struct Taps {
  int i00, i01, i10, i11;
  float tx, ty;
};

__device__ __forceinline__ Taps bilinear_taps(float x, float y, int H,
                                              int W) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const int ix = static_cast<int>(x0);
  const int iy = static_cast<int>(y0);
  const int x0i = clamp_index(ix, W), x1i = clamp_index(ix + 1, W);
  const int y0i = clamp_index(iy, H), y1i = clamp_index(iy + 1, H);
  return {y0i * W + x0i, y0i * W + x1i, y1i * W + x0i, y1i * W + x1i,
          x - x0, y - y0};
}

// torch.round rounds half to even, as rintf does.
__device__ __forceinline__ int nearest_tap(float x, float y, int H, int W) {
  return clamp_index(static_cast<int>(rintf(y)), H) * W +
         clamp_index(static_cast<int>(rintf(x)), W);
}

template <bool kBilinear>
__global__ void __launch_bounds__(kThreads)
    texture_fwd_kernel(const float* __restrict__ uv, int uv_stride,
                       const float* __restrict__ tex, long long tex_bstride,
                       float* __restrict__ out, int N, long long total, int C,
                       int H, int W) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  float x, y;
  texel_coords(uv[p * uv_stride], uv[p * uv_stride + 1], H, W, &x, &y);
  const long long plane = static_cast<long long>(H) * W;
  const float* t = tex + (p / N) * tex_bstride;
  float* o = out + p * C;
  if (kBilinear) {
    const Taps k = bilinear_taps(x, y, H, W);
    const float a = 1.0f - k.tx;
    const float b = 1.0f - k.ty;
    for (int c = 0; c < C; ++c, t += plane) {
      o[c] = (((__ldg(t + k.i00) * a) * b + (__ldg(t + k.i01) * k.tx) * b) +
              (__ldg(t + k.i10) * a) * k.ty) +
             (__ldg(t + k.i11) * k.tx) * k.ty;
    }
  } else {
    const int i = nearest_tap(x, y, H, W);
    for (int c = 0; c < C; ++c, t += plane) o[c] = __ldg(t + i);
  }
}

__global__ void __launch_bounds__(kThreads)
    texture_zero_kernel(float* __restrict__ g, long long n) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  float4* g4 = reinterpret_cast<float4*>(g);   // the allocator's alignment
  for (long long i = first; i < n / 4; i += step) {
    g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (first < n % 4) g[n / 4 * 4 + first] = 0.0f;
}

// guv: (B, N, 2) or null; gtex: the texture's gradient or null, its views
// gtex_bstride apart (0: one gradient all views share).
template <bool kBilinear>
__global__ void __launch_bounds__(kThreads)
    texture_bwd_kernel(const float* __restrict__ uv, int uv_stride,
                       const float* __restrict__ tex, long long tex_bstride,
                       const float* __restrict__ gout,
                       float* __restrict__ guv, float* __restrict__ gtex,
                       long long gtex_bstride, int N, long long total, int C,
                       int H, int W) {
  const long long p =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = p < total;
  const float* g = gout + p * C;
  bool live = false;
  if (in) {
    for (int c = 0; c < C; ++c) live |= g[c] != 0.0f;   // a NaN is live
  }
  float2* guv2 = reinterpret_cast<float2*>(guv);
  if (in && !live && guv != nullptr) guv2[p] = make_float2(0.0f, 0.0f);
  if (__ballot_sync(kFullWarp, live) == 0u || !live) return;

  const float u = uv[p * uv_stride];
  const float v = uv[p * uv_stride + 1];
  float x, y;
  texel_coords(u, v, H, W, &x, &y);
  const long long plane = static_cast<long long>(H) * W;
  const long long view = p / N;
  if (!kBilinear) {   // the UVs only choose the texel: no UV gradient
    if (gtex == nullptr) return;
    float* gt = gtex + view * gtex_bstride + nearest_tap(x, y, H, W);
    for (int c = 0; c < C; ++c, gt += plane) atomicAdd(gt, g[c]);
    return;
  }
  const Taps k = bilinear_taps(x, y, H, W);
  const float a = 1.0f - k.tx;
  const float b = 1.0f - k.ty;
  const float* t = tex + view * tex_bstride;
  float* gt = gtex == nullptr ? nullptr : gtex + view * gtex_bstride;
  float gtx = 0.0f;
  float gty = 0.0f;
  for (int c = 0; c < C; ++c) {
    const float gc = g[c];
    const float gb = gc * b;   // the cotangents of the (1 − ty) and ty rows
    const float gy = gc * k.ty;
    if (gt != nullptr) {
      atomicAdd(gt + k.i00, gb * a);
      atomicAdd(gt + k.i01, gb * k.tx);
      atomicAdd(gt + k.i10, gy * a);
      atomicAdd(gt + k.i11, gy * k.tx);
      gt += plane;
    }
    if (guv != nullptr) {
      const float v00 = __ldg(t + k.i00), v01 = __ldg(t + k.i01);
      const float v10 = __ldg(t + k.i10), v11 = __ldg(t + k.i11);
      gtx += (gb * v01 - gb * v00) + (gy * v11 - gy * v10);
      gty += (gc * (v10 * a) + gc * (v11 * k.tx)) -
             (gc * (v00 * a) + gc * (v01 * k.tx));
      t += plane;
    }
  }
  if (guv != nullptr) {
    guv2[p] = make_float2(
        clip_grad(u, (gtx * (static_cast<float>(W) * 0.5f)) * 2.0f),
        clip_grad(v, ((gty * (static_cast<float>(H) * 0.5f)) * -1.0f) *
                         2.0f));
  }
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

// uv: B x N pairs, uv_stride floats apart; tex: views tex_bstride floats
// apart (0: one texture), each C planes of H x W; out: (B, N, C).
extern "C" int kaolin_texture_fwd(const void* uv, int uv_stride,
                                  const void* tex, long long tex_bstride,
                                  void* out, int B, int N, int C, int H,
                                  int W, int bilinear, void* stream) {
  const long long total = static_cast<long long>(B) * N;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(uv);
  const float* t = static_cast<const float*>(tex);
  float* o = static_cast<float*>(out);
  if (bilinear) {
    texture_fwd_kernel<true><<<blocks_for(total), kThreads, 0, st>>>(
        u, uv_stride, t, tex_bstride, o, N, total, C, H, W);
  } else {
    texture_fwd_kernel<false><<<blocks_for(total), kThreads, 0, st>>>(
        u, uv_stride, t, tex_bstride, o, N, total, C, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}

// gout: (B, N, C); guv: (B, N, 2) or null; gtex: gtex_numel floats or
// null, its views gtex_bstride apart (0: one gradient). The zero-fill
// launches where there is a texture gradient to zero.
extern "C" int kaolin_texture_bwd(const void* uv, int uv_stride,
                                  const void* tex, long long tex_bstride,
                                  const void* gout, void* guv, void* gtex,
                                  long long gtex_bstride,
                                  long long gtex_numel, int B, int N, int C,
                                  int H, int W, int bilinear, void* stream) {
  const long long total = static_cast<long long>(B) * N;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* gt = static_cast<float*>(gtex);
  const long long n = gt == nullptr ? 0 : gtex_numel;
  if (n > 0) {
    const int blocks = static_cast<int>(
        std::max(1ll, std::min<long long>(blocks_for(n / 4), kZeroBlocks)));
    texture_zero_kernel<<<blocks, kThreads, 0, st>>>(gt, n);
  }
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const float* u = static_cast<const float*>(uv);
  const float* t = static_cast<const float*>(tex);
  const float* g = static_cast<const float*>(gout);
  float* gu = static_cast<float*>(guv);
  if (bilinear) {
    texture_bwd_kernel<true><<<blocks_for(total), kThreads, 0, st>>>(
        u, uv_stride, t, tex_bstride, g, gu, gt, gtex_bstride, N, total, C,
        H, W);
  } else {
    texture_bwd_kernel<false><<<blocks_for(total), kThreads, 0, st>>>(
        u, uv_stride, t, tex_bstride, g, gu, gt, gtex_bstride, N, total, C,
        H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
