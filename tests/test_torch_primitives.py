"""kaolin_tpu_torch's primitive-cost probes, its table gather and its
profiling helpers, on the CPU.

Each probe function of ``kaolin_tpu_torch.utils.primitives_bench`` gets the
same numpy inputs (from a seed) as the jitted JAX expression that
``kaolin_tpu/utils/primitives_bench.py`` times, at small sizes.

Tolerances:
- gathers, scatter-min, the unique scatter and both sorts (keys and
  payloads; both sorts are stable): exactly equal;
- scatter-add: within 1e-5 absolute, since sums of a few values in [0, 1)
  are added in another order;
- cumsum: within 1e-4 of the last partial sum's magnitude, since the
  summation order differs.
"""

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.utils import cuda_gather, primitives_bench, profiling
from tests.torch_parity import ROOT
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

RNG_SEED = 0


def _rng():
    return np.random.RandomState(RNG_SEED)


def _jit_gather():
    return jax.jit(lambda t, i: t[i])


@pytest.mark.parametrize("n_tab,n_idx", [(1000, 3000), (4096, 2048)])
def test_gather1d_matches_jax(n_tab, n_idx):
    rng = _rng()
    table = rng.randn(n_tab).astype(np.float32)
    idx = rng.randint(0, n_tab, n_idx).astype(np.int32)
    got = primitives_bench.gather(torch.from_numpy(table),
                                  torch.from_numpy(idx))
    want = _jit_gather()(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rowgather_matches_jax():
    rng = _rng()
    table = rng.randn(1024, 8).astype(np.float32)
    idx = rng.randint(0, 1024, 3000).astype(np.int32)
    got = primitives_bench.gather(torch.from_numpy(table),
                                  torch.from_numpy(idx))
    want = _jit_gather()(jnp.asarray(table), jnp.asarray(idx))
    assert got.shape == (3000, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scatter_inputs(n_idx=4000, n_out=1000):
    """Colliding indices (4 per slot on average) and values in [0, 1)."""
    rng = _rng()
    idx = rng.randint(0, n_out, n_idx).astype(np.int32)
    val = rng.rand(n_idx).astype(np.float32)
    return idx, val, n_out


def test_scatter_add_matches_jax():
    idx, val, n_out = _scatter_inputs()
    got = primitives_bench.scatter_add(torch.from_numpy(idx),
                                       torch.from_numpy(val), n_out)
    want = jax.jit(lambda i, v: jnp.zeros((n_out,), jnp.float32)
                   .at[i].add(v, mode="drop"))(jnp.asarray(idx),
                                               jnp.asarray(val))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_scatter_min_matches_jax():
    idx, val, n_out = _scatter_inputs()
    got = primitives_bench.scatter_min(torch.from_numpy(idx).long(),
                                       torch.from_numpy(val), n_out)
    want = jax.jit(lambda i, v: jnp.full((n_out,), np.inf, jnp.float32)
                   .at[i].min(v, mode="drop"))(jnp.asarray(idx),
                                               jnp.asarray(val))
    assert np.isinf(np.asarray(want)).any()   # some slots get no index
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_set_unique_matches_jax():
    rng = _rng()
    n = 3000
    perm = rng.permutation(n).astype(np.int32)
    val = rng.rand(n).astype(np.float32)
    got = primitives_bench.scatter_set_unique(torch.from_numpy(perm),
                                              torch.from_numpy(val), n)
    want = jax.jit(lambda i, v: jnp.zeros((n,), jnp.float32).at[i].set(
        v, mode="drop", unique_indices=True))(jnp.asarray(perm),
                                              jnp.asarray(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_kv_matches_jax_and_is_stable():
    """Keys with many repeats, so the payload order shows stability."""
    rng = _rng()
    key = rng.randint(0, 200, 3000).astype(np.int32)
    pay = np.arange(3000, dtype=np.float32)
    k, p = primitives_bench.sort_kv(torch.from_numpy(key),
                                    torch.from_numpy(pay))
    kj, pj = jax.jit(lambda k, p: jax.lax.sort((k, p), num_keys=1))(
        jnp.asarray(key), jnp.asarray(pay))
    np.testing.assert_array_equal(k.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(p.numpy(),
                                  np.argsort(key, kind="stable"))


def test_rowsort128_matches_jax():
    rng = _rng()
    key = rng.randint(0, 128, (24, 128)).astype(np.int32)
    a = rng.randint(0, 1 << 20, (24, 128)).astype(np.int32)
    got = primitives_bench.rowsort128(torch.from_numpy(key),
                                      torch.from_numpy(a))
    want = jax.jit(lambda k, x: jax.lax.sort((k, x, x), dimension=-1,
                                             num_keys=1))(jnp.asarray(key),
                                                          jnp.asarray(a))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cumsum_matches_jax():
    x = _rng().rand(5000).astype(np.float32)
    got = primitives_bench.cumsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * abs(float(want[-1])))


# -- the table gather ------------------------------------------------------

def test_table_gather_index_rule():
    """A negative index wraps once, then every index is clamped."""
    t = torch.arange(10.0)
    i = torch.tensor([-1, -10, -11, -25, 9, 10, 100], dtype=torch.int32)
    for fn in (cuda_gather.table_gather_plain, cuda_gather.table_gather):
        assert fn(t, i).tolist() == [9, 0, 0, 0, 9, 9, 9]


@pytest.mark.parametrize("n_tab,shape", [(1000, (4099,)), (4096, (33, 7)),
                                         (58_113, (3, 5, 2))])
def test_table_gather_plain_matches_jax(n_tab, shape):
    """Indices in range, negative and past the end, in counts that are not a
    multiple of 4; the result has the shape of ``idx``."""
    rng = _rng()
    table = rng.randn(n_tab).astype(np.float32)
    idx = rng.randint(-2 * n_tab, 2 * n_tab, shape).astype(np.int32)
    assert idx.size % 4 != 0
    got = cuda_gather.table_gather(torch.from_numpy(table),
                                   torch.from_numpy(idx))
    want = _jit_gather()(jnp.asarray(table), jnp.asarray(idx))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


# the L2 kernel's index counts: around a group of 4 and around its
# 1,024-index tile (a block's first tile is read directly; a later tile's
# whole 16-byte vectors come by bulk copy, the rest by the threads that own
# them), into a table the L2 route takes
L2_COUNTS = (1, 3, 4, 5, 7, 8, 9, 1022, 1023, 1024, 1025, 1027, 2047, 2048,
             2049, 4095, 4096, 4097, 3 * 1024 + 1001)


@pytest.mark.parametrize("n_idx", L2_COUNTS)
def test_table_gather_counts_match_jax(n_idx):
    """Counts around 4 and around a tile, indices drawn in range, negative
    and past the end of a 58,113-float table (the smallest the L2 route
    takes), bitwise against ``jax.jit(lambda t, i: t[i])``."""
    rng = np.random.RandomState(n_idx)
    n_tab = cuda_gather.SMEM_MAX_FLOATS + 1
    assert cuda_gather.gather_route(n_tab) == "l2"
    table = rng.randn(n_tab).astype(np.float32)
    idx = rng.randint(-2 * n_tab, 2 * n_tab, n_idx).astype(np.int32)
    idx[::5] = rng.randint(0, n_tab, idx[::5].shape)
    idx[-1] = -1 if n_idx % 2 else n_tab
    got = cuda_gather.table_gather_plain(torch.from_numpy(table),
                                         torch.from_numpy(idx))
    want = _jit_gather()(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_table_gather_unaligned_views_match_jax(offset):
    """Views that start 4, 8 or 12 bytes into their storage (the wrapper
    copies them to 16-byte-aligned storage on the card) gather as JAX does
    on the same values."""
    rng = np.random.RandomState(100 + offset)
    n_tab = cuda_gather.SMEM_MAX_FLOATS + 1 + offset
    table = torch.from_numpy(rng.randn(n_tab).astype(np.float32))
    idx = torch.from_numpy(rng.randint(-n_tab, 2 * n_tab, 2049 + offset)
                           .astype(np.int32))
    tv, iv = table[offset:], idx[offset:]
    assert tv.data_ptr() % 16 != 0 and iv.data_ptr() % 16 != 0
    assert cuda_gather._aligned(tv).data_ptr() % 16 == 0
    assert torch.equal(cuda_gather._aligned(tv), tv)
    got = cuda_gather.table_gather(tv, iv)
    want = _jit_gather()(jnp.asarray(tv.numpy()), jnp.asarray(iv.numpy()))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n_tab,route", [(1, "smem"), (1 << 14, "smem"),
                                         (58_110, "smem"), (58_111, "l2"),
                                         (1 << 20, "l2")])
def test_gather_route_rule(n_tab, route):
    assert cuda_gather.gather_route(n_tab) == route


def test_table_gather_cuda_wrappers_refuse_cpu_tensors():
    t = torch.zeros(16)
    i = torch.zeros(8, dtype=torch.int32)
    for fn in (cuda_gather.table_gather_smem_cuda,
               cuda_gather.table_gather_l2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t, i)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gather.table_gather_smem_cuda(torch.zeros(58_113), i)
    with pytest.raises(ValueError, match="not empty"):
        cuda_gather.table_gather_plain(torch.zeros(0), i)
    assert profiling.counters()[cuda_gather.SMEM_LAUNCHES] == 0
    assert profiling.counters()[cuda_gather.L2_LAUNCHES] == 0


# -- the probe's entry point ----------------------------------------------

def test_main_without_a_card_exits_nonzero():
    """Without a CUDA device, and without ``--device cpu``, the probe stops
    with an error and prints no probe line."""
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from kaolin_tpu_torch.utils import primitives_bench\n"
            "primitives_bench.main(sys.argv[1:])\n")
    proc = subprocess.run([sys.executable, "-c", code, "--quick"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ALL"' not in proc.stdout


class _SmallRandomState(np.random.RandomState):
    """``RandomState`` with the first axis of every draw, and every upper
    bound of ``randint``, capped at 4,096: the probes then run small."""

    CAP = 4096

    def _cap(self, shape):
        shape = (shape,) if np.isscalar(shape) else tuple(shape)
        return (min(shape[0], self.CAP),) + shape[1:]

    def randint(self, low, high, size):
        return super().randint(low, min(high, self.CAP), self._cap(size))

    def randn(self, *shape):
        return super().randn(*self._cap(shape))

    def rand(self, *shape):
        return super().rand(*self._cap(shape))

    def permutation(self, n):
        return super().permutation(min(n, self.CAP))


def test_main_on_the_cpu_when_asked(monkeypatch, capsys):
    """``--device cpu`` runs every probe and prints its line, a device line
    first and the ``ALL`` line last; inputs and timing are cut short here."""
    monkeypatch.setattr(primitives_bench.np.random, "RandomState",
                        _SmallRandomState)

    def one_call(fn, **_):
        profiling.sync(fn())
        return profiling.Timing(ms=1.0, mean_ms=1.0, repeats=1,
                                calls_per_repeat=1)

    monkeypatch.setattr(primitives_bench, "time_fn", one_call)
    results = primitives_bench.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"device": {"type": "cpu", "kind": "cpu"}}
    assert lines[-1] == {"ALL": results}
    names = [next(iter(x)) for x in lines[1:-1]]
    assert names == list(results) == [
        "gather1d_n65536_tab1048576", "gather1d_n1048576_tab1048576",
        "gather1d_n4194304_tab1048576", "gather1d_n4194304_tab16384",
        "rowgather_r8_n262144", "rowgather_r64_n262144",
        "scatter_add_n1048576", "scatter_min_n1048576",
        "scatter_set_unique_n1048576", "sort_kv_n262144", "sort_kv_n1048576",
        "sort_kv_n4194304", "rowsort128_r262144", "cumsum_n4194304",
        "table_gather_n1048576_tab1048576", "table_gather_n1048576_tab16384"]
    for name in names[-2:]:
        assert results[name]["correct"] is True
        assert results[name]["route"] == "plain"


def _load(name):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn", [
    lambda: _load("torch_dibr_optimization").main,
    lambda: _load("torch_dibr_optimization").optimize,
    lambda: _load("torch_spc_raster").main,
], ids=["dibr-main", "dibr-optimize", "spc-main"])
def test_example_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn()).parameters["device"].default == "cuda"


# -- profiling -------------------------------------------------------------

def test_sync_and_time_fn_on_the_cpu():
    profiling.sync(None)
    profiling.sync({"a": [1, (torch.ones(2),)]})
    calls = []
    t = profiling.time_fn(lambda: calls.append(1) or torch.ones(3),
                          repeats=3, calls_per_repeat=2, warmup=2)
    assert len(calls) == 2 + 3 * 2
    assert isinstance(t, profiling.Timing)
    assert 0 <= t.ms <= t.mean_ms
    assert (t.repeats, t.calls_per_repeat) == (3, 2)
    assert "ms/call" in str(t)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace("probe", str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    path = tmp_path / "probe" / "trace.json"
    assert path.is_file()
    assert "traceEvents" in json.loads(path.read_text())
    assert any("cumsum" in e.key for e in prof.key_averages())


def test_default_trace_dir(monkeypatch, tmp_path):
    """The default follows ``$TMPDIR``, so two checkouts run with their own
    temporary directories never share a trace directory."""
    monkeypatch.delenv("KAOLIN_TPU_TRACE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)   # read $TMPDIR again
    assert profiling.default_trace_dir() == str(tmp_path /
                                                "kaolin_tpu_traces")
    monkeypatch.setenv("KAOLIN_TPU_TRACE_DIR", "/x")
    assert profiling.default_trace_dir() == "/x"
