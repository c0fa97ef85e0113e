"""The native host library, loaded with ctypes. Counterpart of
``kaolin_tpu/native/__init__.py``.

Host C++ (``csrc/kaolin_native.cpp``, a copy of the JAX package's): the
TriangleHash behind ``check_sign(backend="native")``, ``points_to_octree``,
``points_to_sorted_morton`` and the LZ4 block decoder of the USD Crate
reader. It is built by ``g++`` at first use (:mod:`.build`), never at
import.

Unlike the JAX package, nothing falls back quietly to numpy or pure Python
when the build fails: :func:`is_available` reports False and every
function here raises RuntimeError with g++'s message.
:func:`_lz4_decompress_py` stays as the plain version of the LZ4 decoder,
which the tests hold the library against.

``calls`` counts the calls that reached the library, by function.
"""

import ctypes
import threading

import numpy as np

__all__ = ["is_available", "load_error", "check_sign_cpu",
           "points_to_octree", "points_to_sorted_morton",
           "lz4_decompress_block", "calls"]

_lock = threading.Lock()
_LIB = None
_ERROR = None
calls = {"check_sign_cpu": 0, "points_to_octree": 0,
         "points_to_sorted_morton": 0, "lz4_decompress_block": 0}

_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_U64 = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "check_sign_cpu": ([_F32, ctypes.c_int64, _I32, ctypes.c_int64, _F32,
                        ctypes.c_int64, ctypes.c_int, _U8], None),
    "points_to_octree": ([_I32, ctypes.c_int64, ctypes.c_int32, _U8,
                          ctypes.c_int64], ctypes.c_int64),
    "points_to_sorted_morton": ([_I32, ctypes.c_int64, _U64],
                                ctypes.c_int64),
    "lz4_decompress_block": ([_U8, ctypes.c_int64, _U8, ctypes.c_int64],
                             ctypes.c_int64),
}


def _load():
    """The library, built and loaded at the first call; None (with the
    reason in :func:`load_error`) when g++ or the load failed."""
    global _LIB, _ERROR
    with _lock:
        if _LIB is None and _ERROR is None:
            from kaolin_tpu_torch.native.build import build
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, RuntimeError) as e:
                _ERROR = str(e)
                return None
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
    return _LIB


def is_available():
    """True when the library is built and loaded."""
    return _load() is not None


def load_error():
    """Why the library is unavailable (g++'s message), or None."""
    _load()
    return _ERROR


def _library(name):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"{name} needs the native library, which did not "
                           f"build or load:\n{_ERROR}")
    calls[name] += 1
    return getattr(lib, name)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rows(arr, dtype, name):
    """``arr`` as a contiguous (N, 3) array of ``dtype``: the shape the C
    entries index."""
    arr = np.ascontiguousarray(np.asarray(arr, dtype=dtype))
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"{name} must have shape (N, 3), got {arr.shape}")
    return arr


def check_sign_cpu(verts, faces, points, resolution=128):
    """TriangleHash +z ray-parity inside test of numpy arrays → (N,) bool."""
    verts = _rows(verts, np.float32, "verts")
    faces = _rows(faces, np.int32, "faces")
    points = _rows(points, np.float32, "points")
    if faces.size and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("faces index past the vertices")
    fn = _library("check_sign_cpu")
    out = np.zeros((points.shape[0],), dtype=np.uint8)
    fn(_ptr(verts, ctypes.c_float), verts.shape[0],
       _ptr(faces, ctypes.c_int32), faces.shape[0],
       _ptr(points, ctypes.c_float), points.shape[0], int(resolution),
       _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def points_to_octree(points, level):
    """Quantized int points (N, 3) → BFS octree bytes (numpy uint8)."""
    points = _rows(points, np.int32, "points")
    fn = _library("points_to_octree")
    cap = points.shape[0] * max(int(level), 1) + 8
    out = np.zeros((cap,), dtype=np.uint8)
    n = fn(_ptr(points, ctypes.c_int32), points.shape[0], int(level),
           _ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"points_to_octree: more than {cap} bytes")
    return out[:n].copy()


def points_to_sorted_morton(points):
    """int points (N, 3) → their sorted distinct uint64 Morton codes."""
    points = _rows(points, np.int32, "points")
    fn = _library("points_to_sorted_morton")
    out = np.zeros((points.shape[0],), dtype=np.uint64)
    n = fn(_ptr(points, ctypes.c_int32), points.shape[0],
           _ptr(out, ctypes.c_uint64))
    return out[:n].copy()


def lz4_decompress_block(data, decompressed_size):
    """Decode one LZ4 block → numpy uint8 of at most ``decompressed_size``
    bytes; a malformed block or one that decodes to more raises
    ValueError."""
    fn = _library("lz4_decompress_block")
    data = np.frombuffer(bytes(data), dtype=np.uint8)
    out = np.zeros((int(decompressed_size),), dtype=np.uint8)
    n = fn(_ptr(data, ctypes.c_uint8), data.shape[0],
           _ptr(out, ctypes.c_uint8), out.shape[0])
    if n < 0:
        raise ValueError("malformed LZ4 block")
    return out[:n]


def _lz4_decompress_py(src, dst_cap):
    """The plain version of :func:`lz4_decompress_block`, in pure Python:
    the JAX package's slow path, and the tests' oracle. A block cut short
    raises ValueError, as the library does (the JAX package's copy raises
    IndexError there, or returns the literals it has)."""
    try:
        return _lz4_decode_py(src, dst_cap)
    except IndexError:
        raise ValueError("malformed LZ4 block: cut short") from None


def _lz4_decode_py(src, dst_cap):
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]; i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]; i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise IndexError
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        mlen = (token & 0xF)
        if mlen == 15:
            while True:
                b = src[i]; i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset == 0 or start < 0:
            raise ValueError("malformed LZ4 block")
        for k in range(mlen):
            out.append(out[start + k])
    if len(out) > dst_cap:
        raise ValueError("LZ4 output exceeds expected size")
    return np.frombuffer(bytes(out), dtype=np.uint8)
