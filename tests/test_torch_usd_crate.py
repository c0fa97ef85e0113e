"""The port's USD Crate (``.usdc``) reader and writer against the JAX
package's, on the CPU.

- Files: the port writes JAX's ``.usdc`` bytes; both readers parse the same
  tokens, paths and specs, and transpile each file to the same USDA text.
- Values: compressed integer arrays, integer-coded and table-coded float
  arrays (which the JAX writer never emits) built by hand, and inlined
  scalars, materialize alike in both readers.
- The importers' placeholders: an array behind ``[<k>]`` parses as its
  printed text parses, for every dtype and shape, failures included.
- Arrays survive a ``.usdc`` bit for bit (denormals, signed zeros, the
  float32 extremes), and a ``.usdz`` holding a text or a binary layer reads
  as the layer does.
"""

import struct
import zipfile

import numpy as np
import pytest
import torch

import kaolin_tpu.io.usd as jusd
import kaolin_tpu.io.usd.core as jcore
import kaolin_tpu.io.usd.crate as jcrate
import kaolin_tpu_torch.io.usd as tusd
import kaolin_tpu_torch.io.usd.core as tcore
import kaolin_tpu_torch.io.usd.crate as tcrate
import kaolin_tpu_torch.io.usd.crate_write as tcw
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

RNG = np.random.RandomState(3)


def _stage_files(tmp_path, pkg, name):
    """A stage with a time-sampled mesh, a point cloud with colours and a
    gaussian cloud, saved as ``.usdc`` by ``pkg`` → its path."""
    path = str(tmp_path / f"{name}.usdc")
    v = RNG.randn(40, 3).astype(np.float32)
    f = RNG.randint(0, 40, (30, 3))
    stage = pkg.create_stage(path)
    for t in range(3):
        pkg.add_mesh(stage, "/World/mesh", v + t, f if t == 0 else None,
                     time=t)
    pkg.add_pointcloud(stage, "/World/cloud", v[:10], colors=v[:10] ** 2)
    pkg.add_gaussiancloud(stage, "/World/g", v[:5], RNG.randn(5, 4),
                          RNG.rand(5, 3), RNG.rand(5))
    stage.save()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("crate")
    state = RNG.get_state()
    jax_file = _stage_files(d, jusd, "jax")
    RNG.set_state(state)
    port_file = _stage_files(d, tusd, "port")
    return jax_file, port_file


def test_port_writes_jax_crate_bytes(files):
    jax_file, port_file = files
    assert open(jax_file, "rb").read() == open(port_file, "rb").read()


def test_readers_parse_the_same_structure(files):
    jax_file, _ = files
    j, t = jcrate.CrateFile(jax_file), tcrate.CrateFile(jax_file)
    assert t.version == j.version and t.tokens == j.tokens
    assert t.paths == j.paths and t.fields == j.fields
    assert t.specs == j.specs
    with open(jax_file, "rb") as fh:
        assert tcrate.CrateFile("unused", fh.read()).specs == j.specs


def test_crate_to_usda_matches_jax(files):
    for path in files:
        assert tcrate.crate_to_usda(path) == jcrate.crate_to_usda(path)


def test_not_a_crate_raises(tmp_path):
    path = tmp_path / "x.usdc"
    path.write_bytes(b"#usda 1.0\n")
    with pytest.raises(ValueError, match="not a USD crate"):
        tcrate.CrateFile(str(path))


def _hand_built(tmp_path):
    """A crate whose attributes hold what the JAX writer never writes:
    compressed int32 and int64 arrays, float arrays coded as integers
    ('i') and through a table ('t'), compressed int3 vectors, inlined
    scalars and vectors."""
    w = tcw.CrateWriter()

    def compressed(ty, payload, cnt):
        off = w._write(struct.pack("<Q", cnt) + payload)
        return (ty << 48) | tcw._IS_ARRAY | jcrate._IS_COMPRESSED | off

    def ints(values, width=4):
        return tcw.CrateWriter._sec_compressed_ints(values, width)

    i32 = RNG.randint(-1000, 1000, 50)
    i64 = RNG.randint(-2 ** 40, 2 ** 40, 30)
    f_int = RNG.randint(-50, 50, 20)
    lut = np.array([0.5, -1.25, 3.0], "<f4")
    f_idx = RNG.randint(0, 3, 25)
    vec = RNG.randint(-9, 9, (6, 3))
    reps = {
        "a_i32": compressed(3, ints(i32), len(i32)),
        "a_i64": compressed(5, ints(i64, 8), len(i64)),
        "a_fint": compressed(8, b"i" + ints(f_int), len(f_int)),
        "a_ftab": compressed(9, b"t" + struct.pack("<I", 3)
                             + lut.astype("<f8").tobytes()
                             + ints(f_idx), len(f_idx)),
        "a_int3": compressed(26, ints(vec.reshape(-1)), len(vec)),
        "s_int": w.rep_int(-7), "s_float": w.rep_float(0.25),
        "s_double": w.rep_double(1.0 / 3.0), "s_vec": w.rep_vec_scalar(
            [1.5, -2.0, 0.125], 3),
        "s_bool": (1 << 48) | tcw._IS_INLINED | 1,
        "s_inline_vec": (24 << 48) | tcw._IS_INLINED | 0x00FE0201,
        "s_inline_mat": (14 << 48) | tcw._IS_INLINED | 0x00030201,
    }
    w.add_spec("/", 7, {"upAxis": w.rep_token("Y")})
    w.add_spec("/World", 6, {"typeName": w.rep_token("Xform"),
                             "specifier": w.rep_specifier()})
    for name, rep in reps.items():
        w.add_spec(f"/World.{name}", 1, {"default": rep})
    path = str(tmp_path / "hand.usdc")
    w.save(path)
    return path, {"a_i32": i32, "a_i64": i64, "a_fint": f_int,
                  "a_ftab": lut.astype(np.float64)[f_idx], "a_int3": vec}


def test_hand_built_values_read_alike(tmp_path):
    path, want = _hand_built(tmp_path)
    j, t = jcrate.CrateFile(path), tcrate.CrateFile(path)
    assert len(t.specs) == len(j.specs)
    for (p, _, fields), (_, _, jfields) in zip(t.specs, j.specs):
        if "default" not in fields:
            continue
        got, ref = t.value(fields["default"]), j.value(jfields["default"])
        name = p.rsplit(".", 1)[1]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref),
                                      err_msg=name)
        if name in want:
            np.testing.assert_array_equal(np.asarray(got), want[name],
                                          err_msg=name)


# -- the importers' placeholders ---------------------------------------------
ARRAYS = {
    "f32_2d": RNG.randn(7, 3).astype(np.float32),
    "f64_2d": RNG.randn(5, 2),
    "f16_2d": RNG.randn(4, 4).astype(np.float16),
    "i32_2d": RNG.randint(-5, 5, (3, 3)).astype(np.int32),
    "f32_1d": RNG.randn(9).astype(np.float32),
    "f64_1d": RNG.randn(4),
    "i32_1d": RNG.randint(-9, 9, 11).astype(np.int32),
    "u32_1d": RNG.randint(0, 9, 6).astype(np.uint32),
    "i64_1d": RNG.randint(-2 ** 40, 2 ** 40, 5),
    "empty": np.zeros((0,), np.float32),
}


def _outcome(fn, text):
    try:
        return fn(text)
    except ValueError:
        return ValueError


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_placeholders_parse_as_their_text(name):
    arr = ARRAYS[name]
    held = []
    placeholder = tcore._stash(held)(arr)
    text = jcrate._fmt_value(None, arr)
    parsers = [(tcore._parse_int_array, jcore._parse_int_array),
               (tcore._parse_float_array, jcore._parse_float_array),
               (lambda t: tcore._parse_vec_array(t, 3),
                lambda t: jcore._parse_vec_array(t, 3)),
               (lambda t: tcore._parse_vec_array(t, 1),
                lambda t: jcore._parse_vec_array(t, 1))]
    for port, ref in parsers:
        want = _outcome(ref, text)
        for source in (placeholder, text):
            got = _outcome(port, source)
            if want is ValueError:
                assert got is ValueError
            else:
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_usdc_arrays_round_trip_bit_for_bit(tmp_path):
    """float32 extremes, denormals and signed zeros through the port's
    ``.usdc`` writer and reader; the ``.usda`` keeps ``:g``'s 6 digits."""
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1.17549435e-38,
                        3.4028235e38, -3.4028235e38, 1.0 + 2 ** -23,
                        0.1, -123456.789], np.float32)
    v = np.concatenate([special, RNG.randn(5000).astype(np.float32)
                        * np.float32(1e3)])
    v = v.reshape(-1, 3)
    for ext in ("usdc", "usda"):
        path = str(tmp_path / f"a.{ext}")
        tusd.export_mesh(path, vertices=torch.from_numpy(v),
                         faces=torch.zeros((1, 3), dtype=torch.int64))
        got = tusd.import_mesh(path, device="cpu").vertices.numpy()
        ref = np.asarray(jusd.import_mesh(path).vertices)
        np.testing.assert_array_equal(got, ref)
        if ext == "usdc":
            assert got.tobytes() == v.tobytes()


@pytest.mark.parametrize("layer", ["usda", "usdc"])
def test_usdz_reads_as_its_layer(tmp_path, layer):
    path = str(tmp_path / f"a.{layer}")
    jusd.export_mesh(path, vertices=RNG.randn(6, 3).astype(np.float32),
                     faces=np.array([[0, 1, 2], [3, 4, 5]]))
    pkg = str(tmp_path / "a.usdz")
    with zipfile.ZipFile(pkg, "w", zipfile.ZIP_STORED) as z:
        z.write(path, f"a.{layer}")
    for src in (path, pkg):
        got = tusd.import_mesh(src, device="cpu")
        ref = jusd.import_mesh(src)
        np.testing.assert_array_equal(got.vertices.numpy(),
                                      np.asarray(ref.vertices))
        np.testing.assert_array_equal(got.faces.numpy(),
                                      np.asarray(ref.faces))
    empty = str(tmp_path / "empty.usdz")
    with zipfile.ZipFile(empty, "w") as z:
        z.writestr("readme.txt", "no layer")
    with pytest.raises(ValueError, match="no usd layer"):
        tusd.import_mesh(empty, device="cpu")
