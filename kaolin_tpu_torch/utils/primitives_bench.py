"""Primitive cost probes on the card: gather, row gather, colliding
scatter-add, scatter-min, unique scatter, sort, row sort, cumsum and the
table-gather kernel of ``csrc/gather.cu``. PyTorch counterpart of
``kaolin_tpu/utils/primitives_bench.py``, with the same probes, sizes and
names.

Run: ``python -m kaolin_tpu_torch.utils.primitives_bench [--quick]
[--device cuda|cpu]``

Each probe times one PyTorch call, warm, as the best of 5 repeats of 4
calls, each repeat fenced by a device sync
(:func:`kaolin_tpu_torch.utils.profiling.time_fn`), and reports millions of elements per second. Results print as one JSON dict
per line, after a line naming the device, and a last ``{"ALL": ...}`` line.
The run needs a CUDA device unless ``--device cpu`` is given.
"""

import argparse
import json

import numpy as np
import torch

from kaolin_tpu_torch.utils.cuda_gather import (
    gather_route,
    table_gather,
    table_gather_plain,
)
from kaolin_tpu_torch.utils.profiling import time_fn


def gather(table, idx):
    """``out[i] = table[idx[i]]`` (``gather1d``), or ``out[i, :] =
    table[idx[i], :]`` on an (n, row) table (``rowgather``); indices in
    range."""
    return table[idx]


def scatter_add(idx, val, n_out):
    """Colliding scatter-add into ``n_out`` zeros, indices in
    ``[0, n_out)``."""
    return torch.zeros(n_out, dtype=val.dtype,
                       device=val.device).index_add_(0, idx, val)


def scatter_min(idx, val, n_out):
    """Colliding scatter-min into ``n_out`` infinities; ``idx`` int64 in
    ``[0, n_out)``."""
    out = torch.full((n_out,), float("inf"), dtype=val.dtype,
                     device=val.device)
    return out.scatter_reduce_(0, idx, val, "amin", include_self=True)


def scatter_set_unique(idx, val, n_out):
    """Scatter of distinct indices into ``n_out`` zeros (the collision-grid
    binning pattern)."""
    out = torch.zeros(n_out, dtype=val.dtype, device=val.device)
    return out.index_put_((idx,), val)


def sort_kv(key, pay):
    """Stable sort of ``key`` carrying ``pay`` → (sorted keys, payload)."""
    k, perm = torch.sort(key, stable=True)
    return k, pay[perm]


def rowsort128(key, x):
    """Stable sort of every row of ``key`` (R, 128) carrying two operands,
    both ``x``, as ``lax.sort((k, x, x), dimension=-1, num_keys=1)`` →
    (keys, x, x) sorted."""
    k, perm = torch.sort(key, dim=-1, stable=True)
    return (k, torch.take_along_dim(x, perm, dim=-1),
            torch.take_along_dim(x, perm, dim=-1))


def cumsum(x):
    return torch.cumsum(x, dim=0)


def main(argv=None):
    """Run every probe and print its JSON line; return the results by
    probe name."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("primitives_bench: no CUDA device; pass --device "
                         "cpu to run the probes on the CPU")

    rng = np.random.RandomState(0)
    results = {}

    def dev(a):
        return torch.from_numpy(a).to(device)

    def timed(fn):
        """Seconds per call: warm-up, best of 5 repeats of 4 calls."""
        return time_fn(fn, repeats=5, calls_per_repeat=4).ms / 1e3

    def report(name, n_elems, seconds, **extra):
        results[name] = {"Melem_s": round(n_elems / seconds / 1e6, 1),
                         "ms": round(seconds * 1e3, 4), **extra}
        print(json.dumps({name: results[name]}), flush=True)

    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(json.dumps({"device": {"type": device.type, "kind": kind}}),
          flush=True)

    sizes = [(1 << 20, 1 << 20)] if args.quick else [
        (1 << 16, 1 << 20), (1 << 20, 1 << 20), (1 << 22, 1 << 20),
        (1 << 22, 1 << 14)]

    # -- 1D gather: out[i] = table[idx[i]] --------------------------------
    for n_idx, n_tab in sizes:
        table = dev(rng.randn(n_tab).astype(np.float32))
        idx = dev(rng.randint(0, n_tab, n_idx).astype(np.int32))
        dt = timed(lambda: gather(table, idx))
        report(f"gather1d_n{n_idx}_tab{n_tab}", n_idx, dt)

    # -- row gather: out[i, :] = table[idx[i], :] (rows of 8 / 64 f32) ----
    for row in ([8] if args.quick else [8, 64]):
        n_idx, n_tab = (1 << 18), (1 << 16)
        table = dev(rng.randn(n_tab, row).astype(np.float32))
        idx = dev(rng.randint(0, n_tab, n_idx).astype(np.int32))
        dt = timed(lambda: gather(table, idx))
        report(f"rowgather_r{row}_n{n_idx}", n_idx, dt,
               GBps=round(n_idx * row * 4 / dt / 1e9, 2))

    # -- scatter-add and scatter-min (non-unique) -------------------------
    n_idx, n_out = (1 << 20), (1 << 18)
    idx = dev(rng.randint(0, n_out, n_idx).astype(np.int32))
    val = dev(rng.rand(n_idx).astype(np.float32))
    dt = timed(lambda: scatter_add(idx, val, n_out))
    report(f"scatter_add_n{n_idx}", n_idx, dt)
    idx64 = idx.long()   # scatter_reduce_ takes int64 indices only
    dt = timed(lambda: scatter_min(idx64, val, n_out))
    report(f"scatter_min_n{n_idx}", n_idx, dt)

    # unique-indices scatter (the collision-grid binning pattern)
    perm = dev(rng.permutation(n_idx).astype(np.int32))
    dt = timed(lambda: scatter_set_unique(perm, val, n_idx))
    report(f"scatter_set_unique_n{n_idx}", n_idx, dt)

    # -- sort (1 key + 1 payload) -----------------------------------------
    for n in ([1 << 20] if args.quick else [1 << 18, 1 << 20, 1 << 22]):
        key = dev(rng.randint(0, 1 << 30, n).astype(np.int32))
        pay = dev(rng.rand(n).astype(np.float32))
        dt = timed(lambda: sort_kv(key, pay))
        report(f"sort_kv_n{n}", n, dt)

    # -- row-local sort (R, 128), 3 operands: the _raytrace_perray inner --
    r = 1 << 18
    key = dev(rng.randint(0, 128, (r, 128)).astype(np.int32))
    a = dev(rng.randint(0, 1 << 20, (r, 128)).astype(np.int32))
    dt = timed(lambda: rowsort128(key, a))
    report(f"rowsort128_r{r}", r * 128, dt)

    # -- cumsum (1D large) -------------------------------------------------
    n = 1 << 22
    x = dev(rng.rand(n).astype(np.float32))
    dt = timed(lambda: cumsum(x))
    report(f"cumsum_n{n}", n, dt)

    # -- the table-gather kernel: (8192, 128) indices into a 4 MB table (the
    # TPU probe's shape, L2 route) and into a 64 KB one (shared memory) ---
    n_idx = 1 << 20
    for n_tab in (1 << 20, 1 << 14):
        table = dev(rng.randn(n_tab).astype(np.float32))
        idx = dev(rng.randint(0, n_tab, (n_idx // 128, 128)).astype(np.int32))
        out = table_gather(table, idx)
        ref = table_gather_plain(table, idx)
        ok = bool(torch.equal(out.view(torch.int32), ref.view(torch.int32)))
        dt = timed(lambda: table_gather(table, idx))
        report(f"table_gather_n{n_idx}_tab{n_tab}", n_idx, dt,
               route=gather_route(n_tab) if device.type == "cuda"
               else "plain", correct=ok)

    print(json.dumps({"ALL": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
