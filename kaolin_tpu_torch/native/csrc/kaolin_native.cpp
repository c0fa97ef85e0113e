// Native host-side components of kaolin_tpu_torch: a copy of
// kaolin_tpu/native/csrc/kaolin_native.cpp.
//
// Host C++, not a CUDA kernel: the 2D spatial hash behind
// check_sign(backend="native") (reference csrc/ops/mesh/triangle_hash.cpp),
// points_to_octree (csrc/ops/spc/spc.cpp) and the LZ4 block decoder of the
// USD Crate reader. Exposed through a thin C ABI loaded with ctypes.
//
// Build: python -m kaolin_tpu_torch.native.build  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// TriangleHash + check_sign (ref triangle_hash.cpp:46-199,
// check_sign.py:158-251 CPU path)
// ---------------------------------------------------------------------------

// +z ray parity for each query point. Triangles are hashed by their xy
// bounding box on a resolution x resolution grid over [xy_min, xy_max];
// each point only tests the triangles in its cell. Edge-function semantics
// match kaolin_tpu.ops.mesh.check_sign (strictly-inside via all-positive or
// all-negative 2D edge functions; crossing counted when the triangle's
// barycentric z exceeds the point's z).
void check_sign_cpu(const float* verts, int64_t num_verts,
                    const int32_t* faces, int64_t num_faces,
                    const float* points, int64_t num_points,
                    int resolution, uint8_t* out /* (num_points,) */) {
  (void)num_verts;
  // xy bounds over vertices and points
  float lo[2] = {3.4e38f, 3.4e38f}, hi[2] = {-3.4e38f, -3.4e38f};
  for (int64_t i = 0; i < num_verts; ++i) {
    for (int j = 0; j < 2; ++j) {
      lo[j] = std::min(lo[j], verts[i * 3 + j]);
      hi[j] = std::max(hi[j], verts[i * 3 + j]);
    }
  }
  for (int64_t i = 0; i < num_points; ++i) {
    for (int j = 0; j < 2; ++j) {
      lo[j] = std::min(lo[j], points[i * 3 + j]);
      hi[j] = std::max(hi[j], points[i * 3 + j]);
    }
  }
  const float span0 = std::max(hi[0] - lo[0], 1e-12f);
  const float span1 = std::max(hi[1] - lo[1], 1e-12f);
  const int res = resolution > 0 ? resolution : 128;
  const float inv0 = res / (span0 * 1.000001f);
  const float inv1 = res / (span1 * 1.000001f);

  auto cell_x = [&](float x) {
    int c = static_cast<int>((x - lo[0]) * inv0);
    return std::min(std::max(c, 0), res - 1);
  };
  auto cell_y = [&](float y) {
    int c = static_cast<int>((y - lo[1]) * inv1);
    return std::min(std::max(c, 0), res - 1);
  };

  // build hash: triangle index lists per cell (bbox coverage)
  std::vector<std::vector<int32_t>> hash(
      static_cast<size_t>(res) * static_cast<size_t>(res));
  for (int64_t t = 0; t < num_faces; ++t) {
    float bx0 = 3.4e38f, bx1 = -3.4e38f, by0 = 3.4e38f, by1 = -3.4e38f;
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + static_cast<int64_t>(faces[t * 3 + k]) * 3;
      bx0 = std::min(bx0, v[0]); bx1 = std::max(bx1, v[0]);
      by0 = std::min(by0, v[1]); by1 = std::max(by1, v[1]);
    }
    const int cx0 = cell_x(bx0), cx1 = cell_x(bx1);
    const int cy0 = cell_y(by0), cy1 = cell_y(by1);
    for (int cx = cx0; cx <= cx1; ++cx)
      for (int cy = cy0; cy <= cy1; ++cy)
        hash[static_cast<size_t>(cx) * res + cy].push_back(
            static_cast<int32_t>(t));
  }

  // query: parity of +z crossings among the cell's candidates
  for (int64_t p = 0; p < num_points; ++p) {
    const float px = points[p * 3 + 0];
    const float py = points[p * 3 + 1];
    const float pz = points[p * 3 + 2];
    const auto& cand =
        hash[static_cast<size_t>(cell_x(px)) * res + cell_y(py)];
    int count = 0;
    for (int32_t t : cand) {
      const float* v0 = verts + static_cast<int64_t>(faces[t * 3 + 0]) * 3;
      const float* v1 = verts + static_cast<int64_t>(faces[t * 3 + 1]) * 3;
      const float* v2 = verts + static_cast<int64_t>(faces[t * 3 + 2]) * 3;
      const float e0 = (v1[0] - v0[0]) * (py - v0[1])
                     - (v1[1] - v0[1]) * (px - v0[0]);
      const float e1 = (v2[0] - v1[0]) * (py - v1[1])
                     - (v2[1] - v1[1]) * (px - v1[0]);
      const float e2 = (v0[0] - v2[0]) * (py - v2[1])
                     - (v0[1] - v2[1]) * (px - v2[0]);
      const bool inside = (e0 > 0 && e1 > 0 && e2 > 0)
                       || (e0 < 0 && e1 < 0 && e2 < 0);
      if (!inside) continue;
      const float area = e0 + e1 + e2;
      const float denom = (area > 1e-12f || area < -1e-12f) ? area : 1.0f;
      const float w0 = e1 / denom;
      const float w1 = e2 / denom;
      const float w2 = 1.0f - w0 - w1;
      const float z = w0 * v0[2] + w1 * v1[2] + w2 * v2[2];
      if (z > pz) ++count;
    }
    out[p] = static_cast<uint8_t>(count & 1);
  }
}

// ---------------------------------------------------------------------------
// points_to_octree (ref csrc/ops/spc/spc.cpp / points.py:53)
// ---------------------------------------------------------------------------

static inline uint64_t spread_bits(uint64_t x) {
  x &= 0x1fffff;
  x = (x | (x << 32)) & 0x1f00000000ffffULL;
  x = (x | (x << 16)) & 0x1f0000ff0000ffULL;
  x = (x | (x << 8)) & 0x100f00f00f00f00fULL;
  x = (x | (x << 4)) & 0x10c30c30c30c30c3ULL;
  x = (x | (x << 2)) & 0x1249249249249249ULL;
  return x;
}

// Quantized int points -> BFS byte-packed octree. Returns the number of
// bytes written (or -1 if `cap` is too small). `out` must have capacity
// >= num_points * level + 1 in the worst case.
int64_t points_to_octree(const int32_t* points, int64_t num_points,
                         int32_t level, uint8_t* out, int64_t cap) {
  std::vector<uint64_t> morton(num_points);
  for (int64_t i = 0; i < num_points; ++i) {
    morton[i] = (spread_bits(points[i * 3 + 0]) << 2)
              | (spread_bits(points[i * 3 + 1]) << 1)
              | spread_bits(points[i * 3 + 2]);
  }
  std::sort(morton.begin(), morton.end());
  morton.erase(std::unique(morton.begin(), morton.end()), morton.end());

  // bottom-up: per level, group sorted children by parent into bytes
  std::vector<std::vector<uint8_t>> levels(level);
  std::vector<uint64_t> cur = std::move(morton);
  for (int l = level; l > 0; --l) {
    std::vector<uint8_t>& bytes = levels[l - 1];
    std::vector<uint64_t> parents;
    parents.reserve(cur.size());
    size_t i = 0;
    while (i < cur.size()) {
      const uint64_t parent = cur[i] >> 3;
      uint8_t b = 0;
      while (i < cur.size() && (cur[i] >> 3) == parent) {
        b |= static_cast<uint8_t>(1u << (cur[i] & 7));
        ++i;
      }
      bytes.push_back(b);
      parents.push_back(parent);
    }
    cur = std::move(parents);
  }
  int64_t total = 0;
  for (const auto& b : levels) total += static_cast<int64_t>(b.size());
  if (total > cap) return -1;
  int64_t off = 0;
  for (const auto& b : levels) {
    std::memcpy(out + off, b.data(), b.size());
    off += static_cast<int64_t>(b.size());
  }
  return total;
}

// ---------------------------------------------------------------------------
// morton sort helper (host SPC construction)
// ---------------------------------------------------------------------------

// points (int32 N x 3) -> sorted unique morton codes; returns count.
int64_t points_to_sorted_morton(const int32_t* points, int64_t num_points,
                                uint64_t* out) {
  std::vector<uint64_t> morton(num_points);
  for (int64_t i = 0; i < num_points; ++i) {
    morton[i] = (spread_bits(points[i * 3 + 0]) << 2)
              | (spread_bits(points[i * 3 + 1]) << 1)
              | spread_bits(points[i * 3 + 2]);
  }
  std::sort(morton.begin(), morton.end());
  const auto end = std::unique(morton.begin(), morton.end());
  const int64_t n = static_cast<int64_t>(end - morton.begin());
  std::memcpy(out, morton.data(), static_cast<size_t>(n) * sizeof(uint64_t));
  return n;
}

// ---------------------------------------------------------------------------
// LZ4 block decompression (USD Crate reader; TfFastCompression payloads).
// Implements the public LZ4 block format: token byte (hi nibble literal
// length, lo nibble match length - 4), optional length continuation bytes,
// literals, 2-byte little-endian match offset, overlapping match copy.
// ---------------------------------------------------------------------------

// Returns bytes written to dst, or -1 on malformed/overflow.
int64_t lz4_decompress_block(const uint8_t* src, int64_t src_size,
                             uint8_t* dst, int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  while (ip < iend) {
    const uint8_t token = *ip++;
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, static_cast<size_t>(lit));
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    // match
    if (ip + 2 > iend) return -1;
    const int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t mlen = (token & 0xF);
    if (mlen == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        mlen += b;
      } while (b == 255);
    }
    mlen += 4;
    if (op + mlen > oend) return -1;
    const uint8_t* match = op - offset;
    // byte-wise copy: offsets < length overlap by design
    for (int64_t i = 0; i < mlen; ++i) op[i] = match[i];
    op += mlen;
  }
  return static_cast<int64_t>(op - dst);
}

}  // extern "C"
