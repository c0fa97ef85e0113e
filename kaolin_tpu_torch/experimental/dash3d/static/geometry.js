/* Dash3D shared geometry module: binary wire-format parsing + mesh math.
 *
 * Mirrors the reference's src/geometry.js responsibilities (parse the
 * framed binary payloads emitted by util.meshes_to_binary /
 * point_clouds_to_binary, compute shading normals) with no DOM or WebGL
 * dependencies, so it is unit-testable headlessly (see
 * tests/render/test_dash3d.py::test_js_parser_*, which executes this file
 * in a browser page or validates its byte-offset contract from Python).
 *
 * Wire format (little-endian, kaolin_tpu_torch/experimental/dash3d/util.py):
 *   header: int32[4] = (type_id, view_id, snap_time, reserved)
 *   meshes  (type_id 0): int32 nmeshes, int32[3] pad, then per mesh
 *     int32 nv, int32 nf, f32 verts[nv*3], int32 faces[nf*3]
 *   clouds  (type_id 1): int32 nclouds, int32[3] pad, then per cloud
 *     int32 npts, int32 pad, f32 bboxmin[3], f32 bboxmax[3],
 *     f32 pts[npts*3]
 */
"use strict";

const Dash3DGeometry = {
  HEADER_BYTES: 16,

  parseHeader(dv) {
    return {
      typeId: dv.getInt32(0, true),
      viewId: dv.getInt32(4, true),
      snapTime: dv.getInt32(8, true),
      reserved: dv.getInt32(12, true),
    };
  },

  parseMeshes(dv, off) {
    const nmeshes = dv.getInt32(off, true); off += 16;
    const meshes = [];
    for (let m = 0; m < nmeshes; m++) {
      const nv = dv.getInt32(off, true), nf = dv.getInt32(off + 4, true);
      off += 8;
      const verts = new Float32Array(dv.buffer.slice(off, off + nv * 12));
      off += nv * 12;
      const faces = new Int32Array(dv.buffer.slice(off, off + nf * 12));
      off += nf * 12;
      meshes.push({verts, faces});
    }
    return meshes;
  },

  parseClouds(dv, off) {
    const nclouds = dv.getInt32(off, true); off += 16;
    const clouds = [];
    for (let c = 0; c < nclouds; c++) {
      const npts = dv.getInt32(off, true); off += 8;
      const bboxMin = new Float32Array(dv.buffer.slice(off, off + 12));
      const bboxMax = new Float32Array(dv.buffer.slice(off + 12, off + 24));
      off += 24;
      const pts = new Float32Array(dv.buffer.slice(off, off + npts * 12));
      off += npts * 12;
      clouds.push({pts, bboxMin, bboxMax});
    }
    return clouds;
  },

  /* area-weighted vertex normals (the classic cross-product accumulate) */
  computeVertexNormals(verts, faces) {
    const n = new Float32Array(verts.length);
    for (let f = 0; f < faces.length; f += 3) {
      const ia = 3 * faces[f], ib = 3 * faces[f + 1], ic = 3 * faces[f + 2];
      const ex = [verts[ib] - verts[ia], verts[ib + 1] - verts[ia + 1],
                  verts[ib + 2] - verts[ia + 2]];
      const ey = [verts[ic] - verts[ia], verts[ic + 1] - verts[ia + 1],
                  verts[ic + 2] - verts[ia + 2]];
      const cx = ex[1] * ey[2] - ex[2] * ey[1];
      const cy = ex[2] * ey[0] - ex[0] * ey[2];
      const cz = ex[0] * ey[1] - ex[1] * ey[0];
      for (const i of [ia, ib, ic]) {
        n[i] += cx; n[i + 1] += cy; n[i + 2] += cz;
      }
    }
    for (let i = 0; i < n.length; i += 3) {
      const l = Math.hypot(n[i], n[i + 1], n[i + 2]) || 1;
      n[i] /= l; n[i + 1] /= l; n[i + 2] /= l;
    }
    return n;
  },

  /* center + uniform scale mapping the bbox into [-1, 1]^3 */
  normalizeGeom(positions) {
    const mn = [Infinity, Infinity, Infinity];
    const mx = [-Infinity, -Infinity, -Infinity];
    for (let i = 0; i < positions.length; i += 3) {
      for (let a = 0; a < 3; a++) {
        mn[a] = Math.min(mn[a], positions[i + a]);
        mx[a] = Math.max(mx[a], positions[i + a]);
      }
    }
    const c = [0, 1, 2].map(a => 0.5 * (mn[a] + mx[a]));
    const s = Math.max(mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]) || 1;
    return {center: c, scale: 2.0 / s};
  },

  /* ---- minimal column-major mat4 helpers (three.js conventions) ---- */
  perspective(fovY, aspect, near, far) {
    const f = 1 / Math.tan(fovY / 2), d = 1 / (near - far);
    return new Float32Array([
      f / aspect, 0, 0, 0,
      0, f, 0, 0,
      0, 0, (near + far) * d, -1,
      0, 0, 2 * near * far * d, 0]);
  },

  /* orbit camera: distance + two angles around a pan target */
  orbitView(rotX, rotY, dist, target) {
    const cy = Math.cos(rotY), sy = Math.sin(rotY);
    const cx = Math.cos(rotX), sx = Math.sin(rotX);
    // rotate-then-translate: v' = Rx * Ry * (v - target) - (0,0,dist)
    const r = [
      cy, sx * sy, -cx * sy, 0,
      0, cx, sx, 0,
      sy, -sx * cy, cx * cy, 0,
      0, 0, 0, 1];
    const t = target;
    const tx = r[0] * t[0] + r[4] * t[1] + r[8] * t[2];
    const ty = r[1] * t[0] + r[5] * t[1] + r[9] * t[2];
    const tz = r[2] * t[0] + r[6] * t[1] + r[10] * t[2];
    r[12] = -tx; r[13] = -ty; r[14] = -tz - dist;
    return new Float32Array(r);
  },
};

if (typeof module !== "undefined" && module.exports) {
  module.exports = Dash3DGeometry;   /* node (headless tests) */
}
if (typeof window !== "undefined") {
  window.Dash3DGeometry = Dash3DGeometry;
}
