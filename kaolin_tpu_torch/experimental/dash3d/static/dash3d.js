/* Dash3D client: WebGL renderer + websocket geometry streaming.
 *
 * Browser analog of the reference's three.js app
 * (kaolin/experimental/dash3d/src/{app,renderer}.js) without the three.js
 * dependency (this image serves no CDN): raw WebGL with z-buffered
 * two-sided Lambert + headlight shading for meshes and size-attenuated
 * point sprites for clouds. Orbit controls match OrbitControls basics:
 * left-drag orbit, shift/right-drag pan, wheel dolly. The time slider
 * re-requests every view at the chosen checkpoint (server snaps to the
 * nearest authored time and answers only when it differs, like the
 * reference's dedup).
 *
 * Wire parsing + camera math live in the shared module
 * /static/geometry.js (Dash3DGeometry).
 */
"use strict";

const G = window.Dash3DGeometry;
const views = [];

const MESH_VS = `
attribute vec3 aPos; attribute vec3 aNrm;
uniform mat4 uProj, uView; uniform float uScale; uniform vec3 uCenter;
varying vec3 vNrmEye; varying vec3 vPosEye;
void main() {
  vec3 p = (aPos - uCenter) * uScale;
  vec4 eye = uView * vec4(p, 1.0);
  vPosEye = eye.xyz;
  vNrmEye = mat3(uView) * aNrm;
  gl_Position = uProj * eye;
}`;

const MESH_FS = `
precision mediump float;
varying vec3 vNrmEye; varying vec3 vPosEye;
uniform vec3 uColor;
void main() {
  vec3 n = normalize(vNrmEye);
  vec3 l = normalize(-vPosEye);            // headlight
  float lam = abs(dot(n, l));              // two-sided
  vec3 c = uColor * (0.25 + 0.75 * lam);
  gl_FragColor = vec4(c, 1.0);
}`;

const PTS_VS = `
attribute vec3 aPos;
uniform mat4 uProj, uView; uniform float uScale; uniform vec3 uCenter;
uniform float uViewH;
void main() {
  vec3 p = (aPos - uCenter) * uScale;
  vec4 eye = uView * vec4(p, 1.0);
  gl_Position = uProj * eye;
  gl_PointSize = clamp(0.02 * uViewH / max(-eye.z, 0.05), 1.5, 9.0);
}`;

const PTS_FS = `
precision mediump float;
void main() {
  vec2 d = gl_PointCoord - vec2(0.5);
  if (dot(d, d) > 0.25) discard;           // round sprites
  gl_FragColor = vec4(0.45, 0.72, 1.0, 1.0);
}`;

function compile(gl, vsSrc, fsSrc) {
  const mk = (type, src) => {
    const s = gl.createShader(type);
    gl.shaderSource(s, src); gl.compileShader(s);
    if (!gl.getShaderParameter(s, gl.COMPILE_STATUS))
      throw new Error(gl.getShaderInfoLog(s));
    return s;
  };
  const p = gl.createProgram();
  gl.attachShader(p, mk(gl.VERTEX_SHADER, vsSrc));
  gl.attachShader(p, mk(gl.FRAGMENT_SHADER, fsSrc));
  gl.linkProgram(p);
  if (!gl.getProgramParameter(p, gl.LINK_STATUS))
    throw new Error(gl.getProgramInfoLog(p));
  return p;
}

const MESH_COLORS = [[0.35, 0.62, 0.85], [0.85, 0.55, 0.35],
                     [0.55, 0.80, 0.45], [0.80, 0.45, 0.70]];

function uploadMeshes(view, meshes) {
  const gl = view.gl;
  view.buffers = meshes.map((mesh, mi) => {
    const nrm = G.computeVertexNormals(mesh.verts, mesh.faces);
    const vbo = gl.createBuffer(), nbo = gl.createBuffer(),
          ibo = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
    gl.bufferData(gl.ARRAY_BUFFER, mesh.verts, gl.STATIC_DRAW);
    gl.bindBuffer(gl.ARRAY_BUFFER, nbo);
    gl.bufferData(gl.ARRAY_BUFFER, nrm, gl.STATIC_DRAW);
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, ibo);
    // Uint32 indices need OES_element_index_uint; fall back to Uint16
    let itype = gl.UNSIGNED_INT;
    if (gl.getExtension("OES_element_index_uint")) {
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint32Array(mesh.faces),
                    gl.STATIC_DRAW);
    } else {
      gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, new Uint16Array(mesh.faces),
                    gl.STATIC_DRAW);
      itype = gl.UNSIGNED_SHORT;
    }
    return {kind: "mesh", vbo, nbo, ibo, count: mesh.faces.length, itype,
            color: MESH_COLORS[mi % MESH_COLORS.length]};
  });
}

function uploadClouds(view, clouds) {
  const gl = view.gl;
  view.buffers = clouds.map(cloud => {
    const vbo = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, vbo);
    gl.bufferData(gl.ARRAY_BUFFER, cloud.pts, gl.STATIC_DRAW);
    return {kind: "points", vbo, count: cloud.pts.length / 3};
  });
}

function drawView(view) {
  const gl = view.gl, w = view.canvas.width, h = view.canvas.height;
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.066, 0.066, 0.066, 1.0);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  if (!view.buffers || !view.norm) return;
  const proj = G.perspective(0.7, w / h, 0.02, 100.0);
  const mv = G.orbitView(view.rotX, view.rotY, view.dist, view.target);

  for (const buf of view.buffers) {
    const prog = buf.kind === "mesh" ? view.meshProg : view.ptsProg;
    gl.useProgram(prog);
    const u = name => gl.getUniformLocation(prog, name);
    gl.uniformMatrix4fv(u("uProj"), false, proj);
    gl.uniformMatrix4fv(u("uView"), false, mv);
    gl.uniform1f(u("uScale"), view.norm.scale);
    gl.uniform3fv(u("uCenter"), view.norm.center);
    const aPos = gl.getAttribLocation(prog, "aPos");
    gl.bindBuffer(gl.ARRAY_BUFFER, buf.vbo);
    gl.enableVertexAttribArray(aPos);
    gl.vertexAttribPointer(aPos, 3, gl.FLOAT, false, 0, 0);
    if (buf.kind === "mesh") {
      gl.uniform3fv(u("uColor"), buf.color);
      const aNrm = gl.getAttribLocation(prog, "aNrm");
      gl.bindBuffer(gl.ARRAY_BUFFER, buf.nbo);
      gl.enableVertexAttribArray(aNrm);
      gl.vertexAttribPointer(aNrm, 3, gl.FLOAT, false, 0, 0);
      gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, buf.ibo);
      gl.drawElements(gl.TRIANGLES, buf.count, buf.itype, 0);
    } else {
      gl.uniform1f(u("uViewH"), h);
      gl.drawArrays(gl.POINTS, 0, buf.count);
    }
  }
}

function setupView(canvas, type, category, id) {
  const gl = canvas.getContext("webgl", {preserveDrawingBuffer: true,
                                         antialias: true});
  if (!gl) {
    canvas.replaceWith(Object.assign(document.createElement("div"),
      {textContent: "WebGL unavailable"}));
    return null;
  }
  const view = {
    canvas, gl, type, category, id,
    meshProg: compile(gl, MESH_VS, MESH_FS),
    ptsProg: compile(gl, PTS_VS, PTS_FS),
    buffers: null, norm: null,
    rotX: -0.35, rotY: 0.6, dist: 3.2, target: [0, 0, 0],
    time: 1e9, current_time: null,
  };
  let mode = null, px = 0, py = 0;
  canvas.addEventListener("mousedown", e => {
    mode = (e.button === 2 || e.shiftKey) ? "pan" : "orbit";
    px = e.offsetX; py = e.offsetY;
    e.preventDefault();
  });
  canvas.addEventListener("contextmenu", e => e.preventDefault());
  window.addEventListener("mouseup", () => mode = null);
  canvas.addEventListener("mousemove", e => {
    if (!mode) return;
    const dx = e.offsetX - px, dy = e.offsetY - py;
    px = e.offsetX; py = e.offsetY;
    if (mode === "orbit") {
      view.rotY += dx * 0.01;
      view.rotX += dy * 0.01;
      view.rotX = Math.max(-1.55, Math.min(1.55, view.rotX));
    } else {
      // pan in the camera plane, scaled by distance
      const s = 0.0016 * view.dist;
      const cy = Math.cos(view.rotY), sy = Math.sin(view.rotY);
      const cx = Math.cos(view.rotX), sx = Math.sin(view.rotX);
      const right = [cy, 0, sy], up = [sx * sy, cx, -sx * cy];
      for (let a = 0; a < 3; a++)
        view.target[a] += -dx * s * right[a] + dy * s * up[a];
    }
    drawView(view);
  });
  canvas.addEventListener("wheel", e => {
    e.preventDefault();
    view.dist = Math.max(0.3, Math.min(30,
      view.dist * Math.exp(e.deltaY * 0.001)));
    drawView(view);
  });
  views.push(view);
  drawView(view);
  return view;
}

function connect() {
  const ws = new WebSocket(`ws://${location.host}/websocket/`);
  ws.binaryType = "arraybuffer";

  ws.onmessage = ev => {
    if (typeof ev.data === "string") {
      const msg = JSON.parse(ev.data);
      if (msg.type === "dirinfo") buildViews(JSON.parse(msg.data), ws);
      return;
    }
    const dv = new DataView(ev.data);
    const head = G.parseHeader(dv);
    const view = views[head.viewId];
    if (!view) return;
    view.current_time = head.snapTime;
    if (head.typeId === 0) {
      const meshes = G.parseMeshes(dv, G.HEADER_BYTES);
      uploadMeshes(view, meshes);
      view.norm = G.normalizeGeom(
        meshes.length ? meshes[0].verts : new Float32Array(0));
    } else {
      const clouds = G.parseClouds(dv, G.HEADER_BYTES);
      uploadClouds(view, clouds);
      view.norm = G.normalizeGeom(
        clouds.length ? clouds[0].pts : new Float32Array(0));
    }
    drawView(view);
    const label = document.getElementById(`label-${head.viewId}`);
    if (label) label.textContent =
      `${view.type} "${view.category}"[${view.id}] @ t=${head.snapTime}`;
  };

  ws.onopen = () => console.log("dash3d socket open");
  return ws;
}

function buildViews(dirinfo, ws) {
  const container = document.getElementById("views");
  container.innerHTML = "";
  views.length = 0;
  const requests = [];
  for (const type of ["mesh", "pointcloud"]) {
    for (const category in dirinfo[type] || {}) {
      for (const id of dirinfo[type][category]) {
        const viewId = views.length;
        const div = document.createElement("div");
        div.className = "viewport";
        const label = document.createElement("div");
        label.id = `label-${viewId}`;
        label.textContent = `${type} "${category}"[${id}]`;
        const canvas = document.createElement("canvas");
        canvas.width = 420; canvas.height = 340;
        div.appendChild(label);
        div.appendChild(canvas);
        container.appendChild(div);
        if (setupView(canvas, type, category, id) !== null)
          requests.push({type, category, id, time: 1e9, view_id: viewId});
      }
    }
  }
  if (requests.length)
    ws.send(JSON.stringify({type: "geometry", data: requests}));

  const slider = document.getElementById("time-slider");
  if (slider) slider.addEventListener("change", () => {
    const reqs = views.map((v, i) => ({
      type: v.type, category: v.category, id: v.id,
      time: Number(slider.value), view_id: i,
      current_time: v.current_time}));
    ws.send(JSON.stringify({type: "geometry", data: reqs}));
  });
}

window.addEventListener("load", connect);
