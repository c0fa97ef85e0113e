"""Run one cell of the port's benchmark once and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up (from process start to the first
timed step) makes the inputs from the seed on the card, builds the fit,
loading the port's kernels from the checkout's build cache, and runs the
fit's first steps, which the check compares, and a few more; then the fit
steps for ``--seconds``; then the reference checks what those first steps
produced. With ``--trace 1`` the window (at most ``TRACE_STEPS`` steps)
runs under ``torch.profiler`` and the per-layer metrics are reported.

The last lines on standard error give each number compared beside its
limit; the last line on standard output is the result's JSON object. With
no CUDA device, or fewer than the cell asks for, it prints no result and
exits with 3; with JAX or the JAX package loaded, with 4.
"""

import argparse
import json
import sys

from portbench import harness


def main(argv=None):
    t_start = harness.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    bench = harness.benchmark()
    wl, *_ = harness.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"no result: {args.workload} needs {wl['chips']} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start, bench)
    loaded = harness.jax_loaded()
    if loaded:
        print(f"no result: JAX or the JAX package is loaded: {loaded}",
              file=sys.stderr)
        return 4
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
