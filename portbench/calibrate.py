"""The readings that a cell's limits are set from, on the card at the
cell's own size: the numbers the check compares for the program's first
steps on many seeds (sound runs: the lower reading), for the control (the
reference in TF32, put in the program's place) and for the planted faults
(the upper reading), one JSON line each.

    python -m portbench.calibrate --workload texfit.v8 --seeds 1,2,3 \\
        [--controls 3] [--faults 3] [--out chiprun_out/calib.jsonl]

The first ``--controls`` seeds also run the control, the first
``--faults`` the faults of ``portbench.reference.<fit>_fit.FAULTS``. A
state left unchanged reads 1 on ``change`` and needs no run. All in one
process, as a run's set-up would build them.
"""

import argparse
import gc
import importlib
import json
import os
import sys
import time

import torch

from portbench import harness


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    _, _, cfg, mix = harness.cell(harness.benchmark(), args.workload)
    fit = importlib.import_module(f"portbench.fits.{cfg['fit']}")
    ref_fit = importlib.import_module(f"portbench.reference.{cfg['fit']}_fit")
    n = cfg["checked_steps"]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        inputs = fit.make_inputs(cfg, mix, seed, "cuda")
        state = fit.build(cfg, inputs, "cuda")
        record = fit.first_steps(state, n)
        del state
        gc.collect()
        t = time.perf_counter()
        ref = ref_fit.run(cfg, inputs, n)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t
        rows = [("program", record)]
        if i < args.controls:
            rows.append(("control_tf32",
                         ref_fit.run(cfg, inputs, n, tf32=True)))
        if i < args.faults:
            rows += [(f"fault_{f}", ref_fit.run(cfg, inputs, n, fault=f))
                     for f in ref_fit.FAULTS]
        for kind, rec in rows:
            line = {"workload": args.workload, "seed": seed, "kind": kind,
                    **ref_fit.numbers(rec, ref)}
            line["detail"] = ref_fit.details(rec, ref)
            if kind == "program":
                line["reference_s"] = ref_s
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
        del record, ref, rows
        gc.collect()
        torch.cuda.empty_cache()
    if out:
        out.close()
    loaded = harness.jax_loaded()
    if loaded:
        print(f"JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
