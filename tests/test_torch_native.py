"""kaolin_tpu_torch.native (the host C++ library) against kaolin_tpu.native
and the JAX package's XLA and numpy paths, on the CPU.

- The build: g++ at first use into ``build/kaolin_tpu_torch/native/<hash>/``
  (never into the package), the hash over the source, the flags and the
  compiler; a failed build leaves ``is_available()`` False and every
  function raising with g++'s message: nothing falls back.
- LZ4: hand-built blocks (literals only, a match, an overlapping copy with
  offset < length, the 15/255 length extensions on both nibbles, a block
  of many sequences) decoded alike by the library, the plain decoder
  ``_lz4_decompress_py`` and JAX's decoder; malformed blocks raise
  ValueError in all three.
- The Crate integer codec (``Usd_IntegerCompression``) of both widths,
  every code size, against JAX's codec.
- ``points_to_octree`` and ``points_to_sorted_morton`` equal JAX's
  library and the port's ``unbatched_points_to_octree``; ``check_sign``'s
  native backend equals JAX's native backend and its XLA path.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaolin_tpu.io.usd.crate as jcrate
import kaolin_tpu.io.usd.crate_write as jcrate_write
import kaolin_tpu.native as jnative
import kaolin_tpu_torch.io.usd.crate as tcrate
import kaolin_tpu_torch.io.usd.crate_write as tcrate_write
import kaolin_tpu_torch.native as native
from kaolin_tpu.ops.mesh.check_sign import check_sign as check_sign_jax
from kaolin_tpu_torch.native import build as nbuild
from kaolin_tpu_torch.ops.mesh import check_sign
from kaolin_tpu_torch.ops.spc import unbatched_points_to_octree
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

ROOT_BUILD = nbuild._ROOT / "build" / "kaolin_tpu_torch" / "native"


def _uv_sphere(n_lat=24, n_lon=32):
    lat = np.linspace(0.1, np.pi - 0.1, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    v = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                  np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    f = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            f += [[a, b, c], [b, d, c]]
    return v.astype(np.float32), np.asarray(f, np.int32)


# -- the build ---------------------------------------------------------------
def test_library_builds_outside_the_package():
    """Built under ``build/`` at the repository root with the JAX package's
    flags (so that float contraction matches its library's)."""
    assert native.is_available(), native.load_error()
    so = nbuild.library_path()
    assert so.exists() and so.parent.parent == ROOT_BUILD
    assert not list(nbuild.SOURCE.parent.parent.glob("*.so"))
    assert nbuild.FLAGS == ("-O3", "-march=native", "-shared", "-fPIC",
                            "-std=c++17")
    assert nbuild.command(so)[:6] == ["g++", *nbuild.FLAGS]


def test_library_hash_covers_flags_and_compiler(monkeypatch):
    here = nbuild.library_path()
    monkeypatch.setattr(nbuild, "FLAGS", nbuild.FLAGS + ("-g",))
    assert nbuild.library_path() != here
    monkeypatch.undo()
    monkeypatch.setattr(nbuild, "compiler_version", lambda cxx="g++": "x")
    assert nbuild.library_path() != here


def test_failed_build_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """With a compiler that fails, the library is not available and every
    function raises RuntimeError with the compiler's message; the Crate
    reader's LZ4 raises too."""
    with pytest.raises(RuntimeError, match="failed|--version"):
        nbuild.build(cxx=str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)

    def broken(**kwargs):
        raise RuntimeError("g++ failed with code 1:\nerror: no compiler")

    monkeypatch.setattr(nbuild, "build", broken)
    assert not native.is_available()
    assert "no compiler" in native.load_error()
    v, f = _uv_sphere(6, 8)
    for call in (lambda: native.check_sign_cpu(v, f, v),
                 lambda: native.points_to_octree(np.zeros((1, 3)), 1),
                 lambda: native.points_to_sorted_morton(np.zeros((1, 3))),
                 lambda: native.lz4_decompress_block(b"\x10a", 1),
                 lambda: tcrate._fast_decompress(b"\x00\x10a", 1),
                 lambda: check_sign(torch.from_numpy(v)[None],
                                    torch.from_numpy(f),
                                    torch.from_numpy(v)[None],
                                    backend="native")):
        with pytest.raises(RuntimeError, match="no compiler"):
            call()


# -- LZ4 ---------------------------------------------------------------------
def _length(n):
    """The LZ4 continuation bytes of a length whose nibble is 15."""
    out, n = bytearray(), n - 15
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)
    return bytes(out)


def _seq(literals, offset=None, match=None):
    """One LZ4 sequence: literals, then a match of ``match`` bytes at
    ``offset`` back (none: the last sequence)."""
    lit, m = len(literals), 0 if match is None else match - 4
    token = (min(lit, 15) << 4) | min(m, 15)
    out = bytes([token]) + (_length(lit) if lit >= 15 else b"") + literals
    if match is not None:
        out += bytes([offset & 255, offset >> 8])
        out += _length(m) if m >= 15 else b""
    return out


LZ4_CASES = {
    "literals": (_seq(b"hello"), b"hello"),
    "empty": (_seq(b""), b""),
    "match": (_seq(b"abcd", 4, 8) + _seq(b"!"), b"abcd" * 3 + b"!"),
    "overlap": (_seq(b"ab", 1, 9) + _seq(b""), b"a" + b"b" * 10),
    "run": (_seq(b"xyz", 3, 7) + _seq(b"q"), b"xyzxyzxyzx" + b"q"),
    "literal_15": (_seq(bytes(range(15))), bytes(range(15))),
    "literal_270": (_seq(bytes(i % 251 for i in range(270))),
                    bytes(i % 251 for i in range(270))),
    "match_19": (_seq(b"0123", 4, 19) + _seq(b"."),
                 (b"0123" * 6)[:23] + b"."),
    "match_600": (_seq(b"k", 1, 600) + _seq(b""), b"k" * 601),
    "many": (b"".join(_seq(bytes([65 + i]) * 3, 2, 5 + i)
                      for i in range(20)) + _seq(b"end"), None),
}


def _oracle(block):
    """The expected bytes, by the LZ4 format directly."""
    out, i = bytearray(), 0
    while i < len(block):
        token = block[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                lit += block[i]
                i += 1
                if block[i - 1] != 255:
                    break
        out += block[i:i + lit]
        i += lit
        if i >= len(block):
            break
        off = block[i] | block[i + 1] << 8
        i += 2
        m = token & 15
        if m == 15:
            while True:
                m += block[i]
                i += 1
                if block[i - 1] != 255:
                    break
        for _ in range(m + 4):
            out.append(out[-off])
    return bytes(out)


@pytest.mark.parametrize("name", sorted(LZ4_CASES))
def test_lz4_blocks_decode_alike(name):
    block, want = LZ4_CASES[name]
    want = _oracle(block) if want is None else want
    assert _oracle(block) == want
    cap = len(want) + 7
    got = bytes(native.lz4_decompress_block(block, cap))
    assert got == want
    assert bytes(native._lz4_decompress_py(block, cap)) == want
    assert bytes(jnative._lz4_decompress_py(block, cap)) == want
    assert bytes(jnative.lz4_decompress_block(block, cap)) == want


MALFORMED = {
    "offset_0": _seq(b"ab", 0, 4) + _seq(b""),
    "offset_past_start": _seq(b"ab", 3, 4) + _seq(b""),
    "too_long": _seq(b"abcdef"),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_lz4_malformed_blocks_raise(name):
    block = MALFORMED[name]
    cap = 4 if name == "too_long" else 64
    for decode in (native.lz4_decompress_block, native._lz4_decompress_py,
                   jnative._lz4_decompress_py, jnative.lz4_decompress_block):
        with pytest.raises(ValueError):
            decode(block, cap)


@pytest.mark.parametrize("block", [b"\xf0", _seq(b"abc")[:-1],
                                   _seq(b"ab", 1, 5)[:-1] + b""])
def test_lz4_cut_short_raises_valueerror(block):
    """A block cut short: ValueError from the library and the plain
    decoder alike (JAX's plain decoder raises IndexError or returns the
    literals it has)."""
    for decode in (native.lz4_decompress_block, native._lz4_decompress_py):
        with pytest.raises(ValueError):
            decode(block, 64)


def test_fast_decompress_chunks_match_jax():
    """TfFastCompression buffers of one and of several chunks."""
    data = bytes(np.random.RandomState(0).randint(0, 4, 5000)
                 .astype(np.uint8))
    one = jcrate_write._fast_compress(data)
    assert tcrate_write._fast_compress(data) == one
    chunks = [data[:2000], data[2000:]]
    many = bytes([2]) + b"".join(
        len(b).to_bytes(4, "little") + b
        for b in (jcrate_write._lz4_literal_block(c) for c in chunks))
    for buf in (one, many):
        assert tcrate._fast_decompress(buf, len(data)) == data
        assert jcrate._fast_decompress(buf, len(data)) == data


# -- the Crate integer codec ---------------------------------------------------
@pytest.mark.parametrize("width", [4, 8])
def test_crate_integer_codec_matches_jax(width):
    rng = np.random.RandomState(width)
    big = 2 ** 40 if width == 8 else 2 ** 29
    values = np.concatenate([
        np.arange(50) * 3, np.cumsum(rng.randint(-120, 120, 40)),
        np.cumsum(rng.randint(-30000, 30000, 40)),
        rng.randint(-big, big, 40),
        np.cumsum([-1, 0, 1, 127, -128, 128, 32767, -32768, 32768])
    ]).astype(np.int64)
    enc = tcrate_write._encode_ints(values, width)
    assert enc == jcrate_write._encode_ints(values, width)
    np.testing.assert_array_equal(tcrate._decode_ints(enc, len(values),
                                                      width), values)
    np.testing.assert_array_equal(jcrate._decode_ints(enc, len(values),
                                                      width), values)
    assert len(tcrate._decode_ints(b"", 0, width)) == 0


# -- points_to_octree, Morton codes, check_sign --------------------------------
def test_points_to_octree_matches_jax_and_the_device_octree():
    rng = np.random.RandomState(0)
    pts = np.unique(rng.randint(0, 64, (2000, 3)), axis=0).astype(np.int32)
    got = native.points_to_octree(pts, 6)
    np.testing.assert_array_equal(got, jnative.points_to_octree(pts, 6))
    dev = unbatched_points_to_octree(torch.from_numpy(pts.astype(np.int16)),
                                     6)
    np.testing.assert_array_equal(got, dev.cpu().numpy())


def test_points_to_sorted_morton_matches_jax():
    pts = np.random.RandomState(1).randint(0, 512, (3000, 3)).astype(
        np.int32)
    got = native.points_to_sorted_morton(pts)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, jnative.points_to_sorted_morton(pts))


def test_native_inputs_are_checked_before_the_library_reads_them():
    """Arrays of another shape, or faces past the vertices, raise before
    a pointer reaches the C entries (which would read past them)."""
    v, f = _uv_sphere(6, 8)
    with pytest.raises(ValueError, match="past the vertices"):
        native.check_sign_cpu(v, f + len(v), v)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        native.check_sign_cpu(v[:, :2], f, v)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        native.points_to_octree(np.zeros(6, np.int32), 2)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        native.points_to_sorted_morton(np.zeros((2, 4), np.int32))


@pytest.mark.parametrize("resolution", [128, 1024])
def test_check_sign_cpu_matches_jax_library(resolution):
    v, f = _uv_sphere()
    pts = np.random.RandomState(2).uniform(-1.2, 1.2, (4000, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        native.check_sign_cpu(v, f, pts, resolution),
        jnative.check_sign_cpu(v, f, pts, resolution))


def test_native_check_sign_matches_xla_and_counts_its_calls():
    """JAX's own native test on the port: the sphere, 4,000 points; the
    origin inside, a far point outside; one library call an item."""
    v, f = _uv_sphere()
    pts = np.random.RandomState(0).uniform(-1.2, 1.2, (4000, 3)).astype(
        np.float32)
    want = np.asarray(check_sign_jax(jnp.asarray(v)[None], jnp.asarray(f),
                                     jnp.asarray(pts)[None]))[0]
    before = native.calls["check_sign_cpu"]
    got = check_sign(torch.from_numpy(v)[None], torch.from_numpy(f),
                     torch.from_numpy(pts)[None], backend="native",
                     hash_resolution=4096)
    assert native.calls["check_sign_cpu"] == before + 1
    np.testing.assert_array_equal(got[0].numpy(), want)
    probe = torch.tensor([[[0.0, 0.0, 0.0], [2.0, 2.0, 2.0]]])
    inside = check_sign(torch.from_numpy(v)[None], torch.from_numpy(f),
                        probe, backend="native")[0]
    assert bool(inside[0]) and not bool(inside[1])


def test_native_module_builds_nothing_at_import():
    """Importing the package builds and loads nothing: the build runs at
    first use."""
    code = ("import kaolin_tpu_torch.native as n\n"
            "assert n._LIB is None and n._ERROR is None\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(nbuild._ROOT))
