#!/usr/bin/env python3
"""Time a table-gather route against variants of itself, on the card.

Each variant is this tree's ``kaolin_tpu_torch/utils/csrc/gather.cu`` with
one design choice turned the other way (the table reads skip L1, an
evict-normal hint on the prefetched table, no prefetch, four ring slots,
2,048-index tiles, four blocks an SM), built alone by nvcc with the port's
flags; ``--other CHECKOUT`` adds that checkout's ``gather.cu`` as it
stands. Every build is checked bit for bit against ``table_gather_plain``
on seven cases, then timed by ``chip_smoke.py``'s cold (L2 flushed) and
warm readings in two rounds, beside ``table[idx]`` and a copy of the
probe's 4 MB of indices:

    python3 scripts/gather_variants.py [--other CHECKOUT]

``--route smem`` does the same for the shared-memory route: this tree's
kernel against builds with ``kSmemCluster``, ``kSmemBlocksPerSm``,
``kSmemVecs`` or ``kSmemThreads`` changed (no cluster with plain bulk
copies, clusters of 2, 4 and 8, one or two blocks an SM, 1, 2 or 4 int4
of indices in flight a thread, one 1,024-thread block an SM), ``__ldg``
index loads with plain stores, and the other checkout's
``gather_smem_kernel``; each launch's grid is printed as the build's
``kaolin_gather_smem_grid`` gives it. Each is checked bit for bit on
eight cases (tables of 1 to 58,110 floats, 1 to 2^20 indices, negative
and past-the-end ones), then timed cold on the probe's 2^14 table, on
1,024 and on 58,110 floats and warm on the probe's, beside this tree's
L2 route on the same cases:

    python3 scripts/gather_variants.py --route smem [--other CHECKOUT]

The readings go to stdout, each line with the card's name and power
limit, and as JSON to ``build/gather_variants/readings_<route>.json``.
Without a CUDA device it exits 1.

``--clocks`` instead reads this tree's routes and ``table[idx]`` at the
probe's shapes cold and warm twice in one process, first on a card that
has idled and then after 20 s of float32 matrix products, with the SM
clock sampled by ``nvidia-smi`` every 100 ms during each reading:

    python3 scripts/gather_variants.py --clocks
"""

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "kaolin_tpu_torch", "utils", "csrc", "gather.cu")
BUILD = os.path.join(ROOT, "build", "gather_variants")

LD = '"ld.global.nc.L2::cache_hint.f32'
LD_NO_L1 = '"ld.global.nc.L1::no_allocate.L2::cache_hint.f32'
POLICY = "prefetch ? policy_evict_last() : policy_evict_normal()"


def constant(text, name, value):
    """``text`` with ``constexpr ... name = ...;`` set to ``value``."""
    text, n = re.subn(rf"(constexpr [a-z0-9_ ]+ {name} = )[^;]+;",
                      rf"\g<1>{value};", text)
    if n != 1:
        raise ValueError(f"{name} not found once in gather.cu")
    return text


def replaced(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"{old!r} not found once in gather.cu")
    return text.replace(old, new)


def variants(other=None):
    src = open(SRC).read()
    out = {
        "this tree": src,
        "reads skip L1": replaced(src, LD, LD_NO_L1),
        "evict-normal prefetched table": replaced(src, POLICY,
                                                  "policy_evict_normal()"),
        "no prefetch": constant(src, "kPrefetchMaxBytes", "0LL"),
        "4 ring slots": constant(src, "kStages", "4"),
        "2,048-index tiles": constant(src, "kTile", "2048"),
        "4 blocks an SM": constant(src, "kL2BlocksPerSm", "4"),
    }
    if other is not None:
        out["other checkout"] = open(os.path.join(
            other, "kaolin_tpu_torch", "utils", "csrc", "gather.cu")).read()
    return out


def build(smoke, sources):
    """One nvcc a variant, all at once → {name: loaded library}."""
    cb = smoke.cuda_build
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        d = os.path.join(BUILD, f"v{i}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "gather.cu"), "w") as fh:
            fh.write(text)
        so = os.path.join(d, "libgather.so")
        procs[name] = (so, subprocess.Popen(
            [cb.find_nvcc(), *cb.NVCC_FLAGS, "-shared", "-o", so,
             os.path.join(d, "gather.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def smem_variants(other=None):
    """name → gather.cu for this tree's shared-memory kernel and each of
    its choices turned another way (a variant equal to this tree is left
    out)."""
    src = open(SRC).read()
    out = {"this tree": src}
    out["no cluster (plain bulk copies)"] = replaced(
        constant(src, "kSmemCluster", "1"),
        "bulk_copy_multicast(s_tab + 4 * v0, table + 4 * v0, bytes, bar,\n"
        "                          (1u << kSmemCluster) - 1);",
        "bulk_copy(s_tab + 4 * v0, table + 4 * v0, bytes, bar,\n"
        "                policy_evict_normal());")
    for cluster in (2, 4, 8):
        out[f"clusters of {cluster}"] = constant(src, "kSmemCluster",
                                                 str(cluster))
    for per_sm in (1, 2):
        out[f"at most {per_sm} block{'s' if per_sm > 1 else ''} an SM"] = (
            constant(src, "kSmemBlocksPerSm", str(per_sm)))
    for vecs in (1, 2, 4):
        out[f"{vecs} int4 in flight"] = constant(src, "kSmemVecs", str(vecs))
    out["1,024 threads, 1 block an SM"] = constant(constant(
        src, "kSmemThreads", "1024"), "kSmemBlocksPerSm", "1")
    out["__ldg indices, plain stores"] = replaced(replaced(
        src, "q[k] = __ldcs(reinterpret_cast<const int4*>(idx + b));",
        "q[k] = __ldg(reinterpret_cast<const int4*>(idx + b));"),
        "__stcs(reinterpret_cast<float4*>(out + b), v);",
        "*reinterpret_cast<float4*>(out + b) = v;")
    out = {name: text for name, text in out.items()
           if name == "this tree" or text != src}
    if other is not None:
        out["other checkout"] = open(os.path.join(
            other, "kaolin_tpu_torch", "utils", "csrc", "gather.cu")).read()
    return out


def launcher(lib, argtypes, entry="kaolin_gather_l2"):
    """A call of ``entry`` (table, idx, out, n_tab, n, stream) of ``lib``;
    where ``lib`` reports the shared-memory route's grid, each new (table,
    count)'s launch is printed."""
    import torch
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    grid = getattr(lib, "kaolin_gather_smem_grid", None) \
        if entry == "kaolin_gather_smem" else None
    if grid is not None:
        grid.argtypes = ([ctypes.c_int, ctypes.c_longlong]
                         + [ctypes.POINTER(ctypes.c_int)] * 3)
        grid.restype = ctypes.c_int
    seen = set()

    def run(table, idx):
        n_tab, n = table.shape[0], idx.numel()
        if grid is not None and (n_tab, n) not in seen:
            seen.add((n_tab, n))
            got = [ctypes.c_int(0) for _ in range(3)]
            status = grid(n_tab, n, *map(ctypes.byref, got))
            if status:
                raise RuntimeError(f"kaolin_gather_smem_grid: CUDA error "
                                   f"{status}")
            cluster, blocks, threads = (g.value for g in got)
            print(f"  launch: {n_tab} floats, {n} indices: clusters of "
                  f"{cluster}, {blocks} blocks of {threads} threads",
                  flush=True)
        out = torch.empty(idx.shape, dtype=torch.float32, device="cuda")
        status = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    n_tab, n, torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{entry}: CUDA error {status}")
        return out
    return run


def smem_runs(smoke, other):
    """name → a call, for every shared-memory variant and this tree's L2
    route."""
    libs = build(smoke, smem_variants(other))
    runs = {name: launcher(lib, smoke.cg._ARGTYPES, "kaolin_gather_smem")
            for name, lib in libs.items()}
    runs["L2 route (this tree)"] = launcher(libs["this tree"],
                                            smoke.cg._ARGTYPES)
    return runs


def sampled_clocks(fn):
    """``fn()`` with ``nvidia-smi`` sampling the SM clock every 100 ms →
    (fn's result, [MHz])."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
    mhz = [int(x) for x in proc.communicate()[0].split() if x.isdigit()]
    return out, mhz


def clocks(smoke, chip_smoke):
    """This tree's two routes and ``table[idx]`` cold and warm, on a card
    that has idled and then after 20 s of matrix products, the SM clock
    sampled during each reading."""
    import torch
    cases = {name: smoke.gather_case(n_tab, chip_smoke.GATHER_IDX)
             for name, n_tab in chip_smoke.GATHER_TABLES.items()}
    fns = {}
    for name, (t, i) in cases.items():
        fns[name] = (lambda f=smoke.counters()[name], t=t, i=i: f(t, i))
        fns[f"table[idx] {name}"] = lambda t=t, i=i: t[i]
    readings = {}
    for when in ("after idling", "after 20 s of load"):
        if when != "after idling":
            a = torch.randn(8192, 8192, device="cuda")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 20:
                a @ a
                torch.cuda.synchronize()
        for name, fn in fns.items():
            (cold, warm), mhz = sampled_clocks(lambda: (
                smoke.cold_ms(f"{name} cold", fn),
                smoke.device_ms(f"{name} warm", fn)))
            readings[f"{name}, {when}"] = {"cold": cold, "warm": warm,
                                           "sm_mhz": mhz}
            print(f"{name}, {when}: cold {cold:.4f}, warm {warm:.4f} "
                  f"device ms; SM clock {min(mhz, default=0)}-"
                  f"{max(mhz, default=0)} MHz [{smoke.card}]", flush=True)
    return readings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="a checkout whose gather.cu to add")
    ap.add_argument("--clocks", action="store_true",
                    help="this tree's routes on an idled and a loaded card")
    ap.add_argument("--route", choices=("l2", "smem"), default="l2",
                    help="the route whose variants to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    smoke = chip_smoke.Smoke()
    smoke.phase_card()
    if args.clocks:
        smoke.phase_build()
        summary = {"card": smoke.card, "clocks": clocks(smoke, chip_smoke)}
        os.makedirs(BUILD, exist_ok=True)
        with open(os.path.join(BUILD, "clocks.json"), "w") as fh:
            json.dump(summary, fh, indent=1)
        print(json.dumps(summary))
        return 0
    cg = smoke.cg
    case = smoke.gather_case
    big = 1 << 20
    if args.route == "smem":
        runs = smem_runs(smoke, args.other)
        top = cg.SMEM_MAX_FLOATS

        def past_end(t, i):   # every 7th index past the table's end
            return t, torch.where(i % 7 == 0, i + 3 * t.shape[0], i)
        checks = [case(1 << 14, chip_smoke.GATHER_IDX),
                  case(1, (3,), lo=-2, seed=20),
                  case(3, (1,), lo=-3, seed=21),
                  past_end(*case(5, (700,), lo=-5, seed=22)),
                  past_end(*case(1021, (4099,), lo=-1021, seed=23)),
                  case(top, (big,), seed=24), case(top, (3,), lo=-9, seed=25),
                  past_end(*case(1 << 14, (6 * 1024 + 5,), lo=-(1 << 15),
                                 seed=26))]
        timed = {"probe": checks[0],
                 "1,024 floats": case(1024, chip_smoke.GATHER_IDX, seed=27),
                 f"{top:,} floats": case(top, chip_smoke.GATHER_IDX,
                                         seed=28)}
    else:
        runs = {name: launcher(lib, cg._ARGTYPES)
                for name, lib in build(smoke, variants(args.other)).items()}
        checks = [case(big, chip_smoke.GATHER_IDX),
                  case(big, (4097,), lo=-big),
                  case(big, (1 << 22,), seed=7), case(1 << 24, (big,), seed=9),
                  case(1 << 18, (300 * 1024 + 1023,), lo=-(1 << 18),
                       seed=10),
                  case(58_113, (3,), lo=-5, seed=11),
                  case(1 << 18, (1025,), lo=-5, seed=15)]
        timed = {"probe": checks[0], "2^22 indices": checks[2],
                 "58,113 floats": case(58_113, chip_smoke.GATHER_IDX,
                                       seed=12),
                 "4,097 indices": checks[1]}
    readings = {}
    for _ in range(2):
        for name, run in runs.items():
            same = all(torch.equal(run(t, i).view(torch.int32),
                                   cg.table_gather_plain(t, i)
                                   .view(torch.int32)) for t, i in checks)
            smoke.check(same, f"{name}: bitwise equal to the plain version "
                        f"on {len(checks)} cases")
            row = {}
            for label, (t, i) in timed.items():
                row[f"{label} cold"] = smoke.cold_ms(
                    f"{name} {label} cold", lambda: run(t, i))
            t, i = timed["probe"]
            row["probe warm"] = smoke.device_ms(f"{name} warm",
                                                lambda: run(t, i))
            readings.setdefault(name, []).append(row)
            print(f"{name}: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in row.items())
                  + f" device ms [{smoke.card}]", flush=True)
    t, i = timed["probe"]
    dst = torch.empty_like(i)
    for name, fn in (("table[idx]", lambda: t[i]),
                     ("4 MB copy of the indices", lambda: dst.copy_(i))):
        row = {"probe cold": smoke.cold_ms(f"{name} cold", fn),
               "probe warm": smoke.device_ms(f"{name} warm", fn)}
        readings[name] = [row]
        print(f"{name}: probe cold {row['probe cold']:.4f}, warm "
              f"{row['probe warm']:.4f} device ms [{smoke.card}]")
    summary = {"card": smoke.card, "median": {
        name: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        for name, rows in readings.items()}, "failures": smoke.failures}
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, f"readings_{args.route}.json"),
              "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 1 if smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
