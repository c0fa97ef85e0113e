"""USD Crate (binary ``.usdc``) writer — dependency-free.

Counterpart of ``kaolin_tpu/io/usd/crate_write.py``, byte for byte the
same files (the reference round-trips ``.usd`` through the pxr C++ runtime,
``kaolin/io/usd/mesh.py:446``): stages authored by
:class:`kaolin_tpu_torch.io.usd.core.UsdaStage` save directly to the Crate
container when the filename ends in ``.usd``/``.usdc``.

Emits file version 0.8.0 with the same encodings the sibling reader
(:mod:`kaolin_tpu_torch.io.usd.crate`, format per pxr crateFile.cpp)
parses:

* TOKENS / STRINGS / FIELDS / FIELDSETS / PATHS / SPECS sections,
* ``TfFastCompression`` payloads — written as single-chunk LZ4 blocks using
  the always-valid literal-only encoding (a final sequence with no match is
  in-spec, so any LZ4 decoder accepts it; compression ratio is traded for
  zero dependencies),
* ``Usd_IntegerCompression`` streams (common value + packed 2-bit codes +
  per-code payload deltas),
* value reps: inlined ints/floats/tokens, offset scalars, uncompressed
  arrays, and the deduped-times TimeSamples block layout.

The writer is validated by round-trip: files it produces are re-imported
through the independent reader path (``crate_to_usda`` → USDA parser) and
must reproduce geometry bit-exactly (``tests/test_torch_usd_crate.py``).
"""

from __future__ import annotations

import re
import struct

import numpy as np

__all__ = ["write_usdc", "CrateWriter"]


# ---------------------------------------------------------------------------
# compression encoders (inverses of crate.py's decoders)
# ---------------------------------------------------------------------------

def _lz4_literal_block(data: bytes) -> bytes:
    """A valid LZ4 block holding ``data`` as one literal-only sequence."""
    n = len(data)
    out = bytearray()
    out.append(min(n, 15) << 4)
    if n >= 15:
        rem = n - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += data
    return bytes(out)


def _fast_compress(data: bytes) -> bytes:
    """TfFastCompression buffer: leading chunk-count byte (0 = one chunk)."""
    return b"\x00" + _lz4_literal_block(data)


def _encode_ints(values, width: int = 4) -> bytes:
    """Usd_IntegerCompression payload (pre-LZ4): common delta, packed 2-bit
    codes (LSB-first), per-code payloads. Inverse of crate._decode_ints."""
    values = np.asarray(values, np.int64)
    n = len(values)
    fmt = "<i" if width == 4 else "<q"
    if n == 0:
        return struct.pack(fmt, 0)
    deltas = np.diff(values, prepend=np.int64(0))
    uniq, counts = np.unique(deltas, return_counts=True)
    common = int(uniq[np.argmax(counts)])
    lims = ((127, 32767) if width == 4 else (32767, 2 ** 31 - 1))
    fmts = (("<b", "<h", "<i") if width == 4 else ("<h", "<i", "<q"))
    codes = np.empty(n, np.uint8)
    payload = bytearray()
    for i, d in enumerate(deltas):
        d = int(d)
        if d == common:
            codes[i] = 0
        elif -lims[0] - 1 <= d <= lims[0]:
            codes[i] = 1
            payload += struct.pack(fmts[0], d)
        elif -lims[1] - 1 <= d <= lims[1]:
            codes[i] = 2
            payload += struct.pack(fmts[1], d)
        else:
            codes[i] = 3
            payload += struct.pack(fmts[2], d)
    ncode_bytes = (n + 3) // 4
    packed = np.zeros(ncode_bytes, np.uint8)
    for i in range(n):
        packed[i // 4] |= codes[i] << (2 * (i % 4))
    return struct.pack(fmt, common) + packed.tobytes() + bytes(payload)


# ---------------------------------------------------------------------------
# value rep construction
# ---------------------------------------------------------------------------

_IS_ARRAY = 1 << 63
_IS_INLINED = 1 << 62

_T_TOKEN, _T_ASSET = 11, 12
_T_SPECIFIER = 42
_T_TIME_SAMPLES = 46
_T_DOUBLE_VECTOR = 48

# usd attribute type name → (crate type id, numpy dtype, components)
_ARRAY_TYPES = {
    "int[]": (3, np.int32, 1),
    "float[]": (8, np.float32, 1),
    "double[]": (9, np.float64, 1),
    "texCoord2f[]": (20, np.float32, 2),
    "float2[]": (20, np.float32, 2),
    "point3f[]": (24, np.float32, 3),
    "color3f[]": (24, np.float32, 3),
    "normal3f[]": (24, np.float32, 3),
    "float3[]": (24, np.float32, 3),
    "vector3f[]": (24, np.float32, 3),
    "quatf[]": (17, np.float32, 4),
    "float4[]": (28, np.float32, 4),
}
_VEC_SCALar_COMPS = {"color3f": 3, "float3": 3, "point3f": 3, "normal3f": 3,
                     "texCoord2f": 2, "float2": 2, "quatf": 4, "float4": 4}


class CrateWriter:
    """Low-level crate serializer: collect specs, then :meth:`save`."""

    def __init__(self):
        self.buf = bytearray(88)        # bootstrap patched in save()
        self.tokens = [""]              # token 0 reserved (negatable elems)
        self._token_idx = {"": 0}
        self.fields = []                # (token_idx, rep)
        self._field_idx = {}
        self.specs = []                 # (path, spec_type, [field indexes])

    # -- primitives --
    def token(self, s: str) -> int:
        idx = self._token_idx.get(s)
        if idx is None:
            idx = len(self.tokens)
            self.tokens.append(s)
            self._token_idx[s] = idx
        return idx

    def _write(self, data: bytes) -> int:
        if len(self.buf) % 8:           # 8-align value blobs
            self.buf += b"\0" * (8 - len(self.buf) % 8)
        off = len(self.buf)
        self.buf += data
        return off

    def field(self, name: str, rep: int) -> int:
        key = (name, rep)
        idx = self._field_idx.get(key)
        if idx is None:
            idx = len(self.fields)
            self.fields.append((self.token(name), rep))
            self._field_idx[key] = idx
        return idx

    # -- reps --
    def rep_token(self, s: str) -> int:
        return (_T_TOKEN << 48) | _IS_INLINED | self.token(s)

    def rep_asset(self, s: str) -> int:
        return (_T_ASSET << 48) | _IS_INLINED | self.token(s)

    def rep_specifier(self, which: str = "def") -> int:
        return (_T_SPECIFIER << 48) | _IS_INLINED | \
            ("def", "over", "class").index(which)

    def rep_int(self, v: int) -> int:
        return (3 << 48) | _IS_INLINED | (int(v) & 0xFFFFFFFF)

    def rep_float(self, v: float) -> int:
        return (8 << 48) | _IS_INLINED | \
            struct.unpack("<I", struct.pack("<f", float(v)))[0]

    def rep_double(self, v: float) -> int:
        off = self._write(struct.pack("<d", float(v)))
        return (9 << 48) | off

    def rep_vec_scalar(self, v, comps: int) -> int:
        ty = {2: 20, 3: 24, 4: 28}[comps]
        off = self._write(np.asarray(v, "<f4").reshape(comps).tobytes())
        return (ty << 48) | off

    def rep_matrix4d(self, v) -> int:
        off = self._write(np.asarray(v, "<f8").reshape(16).tobytes())
        return (15 << 48) | off

    def rep_array(self, usd_type: str, v) -> int:
        ty, dt, comps = _ARRAY_TYPES[usd_type]
        arr = np.asarray(v, np.dtype(dt).newbyteorder("<"))
        arr = arr.reshape(-1, comps) if comps > 1 else arr.reshape(-1)
        cnt = arr.shape[0]
        off = self._write(struct.pack("<Q", cnt) + arr.tobytes())
        return (ty << 48) | _IS_ARRAY | off

    def rep_double_vector(self, v) -> int:
        arr = np.asarray(v, "<f8").reshape(-1)
        off = self._write(struct.pack("<Q", len(arr)) + arr.tobytes())
        return (_T_DOUBLE_VECTOR << 48) | off

    def rep_time_samples(self, usd_type: str, samples: dict) -> int:
        """Layout matched to crate.CrateFile.time_samples: at base an int64
        jump to the times ValueRep, the times blob in between, then an int64
        jump to {int64 n; ValueRep values[n]}."""
        times = sorted(samples)
        times_rep = self.rep_double_vector(times)
        val_reps = [self.value_rep(usd_type, samples[t]) for t in times]
        tail = struct.pack("<q", len(times)) + \
            struct.pack(f"<{len(times)}Q", *val_reps)
        block = struct.pack("<q", 8)          # jump: times rep at base + 8
        block += struct.pack("<Q", times_rep)
        block += struct.pack("<q", 8)         # jump: n/reps at pos + 8
        block += tail
        base = self._write(block)
        return (_T_TIME_SAMPLES << 48) | base

    def value_rep(self, usd_type: str, v) -> int:
        """Encode a raw python/numpy value of a USD attribute type."""
        if usd_type in _ARRAY_TYPES:
            return self.rep_array(usd_type, v)
        if usd_type in ("token", "uniform token", "string"):
            return self.rep_token(str(v))
        if usd_type == "asset":
            return self.rep_asset(str(v))
        if usd_type in ("int", "uint"):
            return self.rep_int(v)
        if usd_type == "float":
            return self.rep_float(v)
        if usd_type == "double":
            return self.rep_double(v)
        if usd_type == "bool":
            return (1 << 48) | _IS_INLINED | int(bool(v))
        if usd_type == "matrix4d":
            return self.rep_matrix4d(v)
        if usd_type in _VEC_SCALar_COMPS:
            return self.rep_vec_scalar(v, _VEC_SCALar_COMPS[usd_type])
        raise ValueError(f"crate writer: unsupported type {usd_type!r}")

    # -- specs --
    def add_spec(self, path: str, spec_type: int, fields: dict):
        """fields: name → rep (already-encoded ValueReps)."""
        fidx = [self.field(n, r) for n, r in fields.items()]
        self.specs.append((path, spec_type, fidx))

    # -- path tree encoding (inverse of crate._read_paths) --
    def _encode_paths(self, paths):
        order = {p: i for i, p in enumerate(paths)}

        children = {p: [] for p in paths}
        for p in paths:
            if p == "/":
                continue
            if "." in p:
                parent = p.rsplit(".", 1)[0] or "/"
            else:
                parent = p.rsplit("/", 1)[0] or "/"
            children.setdefault(parent, []).append(p)
        for v in children.values():
            v.sort()

        sizes = {}

        def size(p):
            if p not in sizes:
                sizes[p] = 1 + sum(size(c) for c in children.get(p, []))
            return sizes[p]

        path_idx, elem_tok, jumps = [], [], []

        def emit(p, has_sibling):
            path_idx.append(order[p])
            if p == "/":
                elem_tok.append(0)
            elif "." in p.rsplit("/", 1)[-1]:
                name = p.rsplit(".", 1)[1]
                elem_tok.append(-self.token(name))
            else:
                elem_tok.append(self.token(p.rsplit("/", 1)[1]))
            kids = children.get(p, [])
            if kids and has_sibling:
                jumps.append(size(p))
            elif kids:
                jumps.append(-1)
            elif has_sibling:
                jumps.append(0)
            else:
                jumps.append(-2)
            for i, c in enumerate(kids):
                emit(c, i < len(kids) - 1)

        emit("/", False)
        return path_idx, elem_tok, jumps

    # -- container assembly --
    @staticmethod
    def _sec_compressed_ints(values, width=4):
        payload = _fast_compress(_encode_ints(values, width))
        return struct.pack("<Q", len(payload)) + payload

    def save(self, file_path):
        # deterministic path table: all spec paths (+ implied "/")
        paths = sorted({p for p, _, _ in self.specs} | {"/"})
        # token indices referenced by the path encoder must exist before the
        # TOKENS section is written
        p_idx, p_elem, p_jumps = self._encode_paths(paths)
        path_order = {p: i for i, p in enumerate(paths)}

        sections = []

        # TOKENS
        blob = b"\0".join(t.encode() for t in self.tokens) + b"\0"
        comp = _fast_compress(blob)
        sections.append((b"TOKENS", struct.pack(
            "<QQQ", len(self.tokens), len(blob), len(comp)) + comp))

        # STRINGS (unused)
        sections.append((b"STRINGS", struct.pack("<Q", 0)))

        # FIELDS
        tok_idx = [t for t, _ in self.fields]
        reps = np.asarray([r for _, r in self.fields], "<u8").tobytes()
        comp_reps = _fast_compress(reps)
        sections.append((b"FIELDS", struct.pack("<Q", len(self.fields))
                         + self._sec_compressed_ints(tok_idx)
                         + struct.pack("<Q", len(comp_reps)) + comp_reps))

        # FIELDSETS: one run per spec, 0xFFFFFFFF-terminated. The
        # terminator is written as -1: the integer codec is int32-delta
        # based and the reader casts its int64 cumsum to uint32, so -1
        # wraps to 0xFFFFFFFF exactly like pxr's uint32 arithmetic.
        runs, starts = [], []
        for _, _, fidx in self.specs:
            starts.append(len(runs))
            runs.extend(fidx)
            runs.append(-1)
        sections.append((b"FIELDSETS", struct.pack("<Q", len(runs))
                         + self._sec_compressed_ints(runs)))

        # PATHS
        sections.append((b"PATHS", struct.pack("<QQ", len(paths), len(p_idx))
                         + self._sec_compressed_ints(p_idx)
                         + self._sec_compressed_ints(p_elem)
                         + self._sec_compressed_ints(p_jumps)))

        # SPECS
        sp_p = [path_order[p] for p, _, _ in self.specs]
        sp_t = [t for _, t, _ in self.specs]
        sections.append((b"SPECS", struct.pack("<Q", len(self.specs))
                         + self._sec_compressed_ints(sp_p)
                         + self._sec_compressed_ints(starts)
                         + self._sec_compressed_ints(sp_t)))

        for name, payload in sections:
            start = self._write(payload)
            sections[[n for n, _ in sections].index(name)] = \
                (name, (start, len(payload)))

        toc_off = self._write(struct.pack("<q", len(sections)))
        for name, (start, sz) in sections:
            self.buf += name.ljust(16, b"\0") + struct.pack("<qq", start, sz)

        self.buf[0:8] = b"PXR-USDC"
        self.buf[8:16] = bytes([0, 8, 0, 0, 0, 0, 0, 0])
        self.buf[16:24] = struct.pack("<q", toc_off)
        with open(file_path, "wb") as f:
            f.write(self.buf)


# ---------------------------------------------------------------------------
# string-value parsing (UsdaStage stores formatted USDA strings)
# ---------------------------------------------------------------------------

_NUM_RE = re.compile(r"-?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _text(value):
    """A stage's value text (formatted now if it is held as a callable)."""
    return value() if callable(value) else value


def _parse_raw(usd_type, text):
    """Parse a USDA-formatted value string back to a raw value for
    :meth:`CrateWriter.value_rep`. Inverse of core's formatters."""
    if isinstance(text, (int, float, np.ndarray, list, tuple)):
        return text
    text = text.strip()
    if usd_type in ("token", "uniform token", "string"):
        return text.strip('"')
    if usd_type == "asset":
        return text.strip("@")
    if usd_type in ("int", "uint"):
        return int(text)
    if usd_type in ("float", "double"):
        return float(text)
    if usd_type == "bool":
        return text == "true"
    nums = [float(x) for x in _NUM_RE.findall(text)]
    if usd_type == "int[]":
        return np.asarray(nums, np.int64)
    if usd_type in _ARRAY_TYPES:
        comps = _ARRAY_TYPES[usd_type][2]
        return np.asarray(nums).reshape(-1, comps) if comps > 1 \
            else np.asarray(nums)
    if usd_type == "matrix4d":
        return np.asarray(nums).reshape(4, 4)
    if usd_type in _VEC_SCALar_COMPS:
        return np.asarray(nums)
    raise ValueError(f"crate writer: unsupported type {usd_type!r}")


_SPEC_ATTRIBUTE, _SPEC_PRIM, _SPEC_PSEUDO_ROOT = 1, 6, 7


def write_usdc(file_path, stage):
    """Serialize a :class:`kaolin_tpu_torch.io.usd.core.UsdaStage` to binary
    ``.usdc``. The on-disk file re-imports through the independent crate
    READER (geometry bit-exact round-trip; see tests)."""
    w = CrateWriter()

    # pseudo-root: layer metadata
    root_fields = {"upAxis": w.rep_token(stage.up_axis)}
    all_times = sorted({t for prim in stage.prims.values()
                        for _, samples in prim.time_samples.values()
                        for t in samples})
    if all_times:
        root_fields["startTimeCode"] = w.rep_double(all_times[0])
        root_fields["endTimeCode"] = w.rep_double(all_times[-1])
    top = sorted({("/" + [s for s in p.split("/") if s][0])
                  for p in stage.prims})
    if top:
        root_fields["defaultPrim"] = w.rep_token(top[0].lstrip("/"))
    w.add_spec("/", _SPEC_PSEUDO_ROOT, root_fields)

    # prim specs: authored prims keep their type; implied ancestors = Xform
    all_prims = {}
    for path, prim in stage.prims.items():
        parts = [s for s in path.split("/") if s]
        for i in range(1, len(parts)):
            all_prims.setdefault("/" + "/".join(parts[:i]), "Xform")
        all_prims[path] = prim.prim_type
    for path in sorted(all_prims):
        w.add_spec(path, _SPEC_PRIM, {
            "typeName": w.rep_token(all_prims[path]),
            "specifier": w.rep_specifier("def"),
        })

    def clean(name):
        # "custom int grid_resolution" → attr name "grid_resolution"
        return name.split()[-1] if " " in name else name

    for path, prim in stage.prims.items():
        for name, (usd_type, value) in prim.attrs.items():
            # raw values (captured at set_attr) are lossless; the formatted
            # string is the %g-rounded fallback for callers that never pass
            # raw (shader scalars, tokens — exact anyway)
            raw = prim.raw.get(name)
            if raw is None:
                raw = _parse_raw(usd_type, _text(value))
            w.add_spec(f"{path}.{clean(name)}", _SPEC_ATTRIBUTE, {
                "typeName": w.rep_token(usd_type),
                "default": w.value_rep(usd_type, raw),
            })
        for name, (usd_type, samples) in prim.time_samples.items():
            raw_ts = prim.raw_ts.get(name, {})
            raw = {float(t): (raw_ts[t] if t in raw_ts
                              else _parse_raw(usd_type, _text(v)))
                   for t, v in samples.items()}
            w.add_spec(f"{path}.{clean(name)}", _SPEC_ATTRIBUTE, {
                "typeName": w.rep_token(usd_type),
                "timeSamples": w.rep_time_samples(usd_type, raw),
            })
    w.save(file_path)
