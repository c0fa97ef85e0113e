#!/usr/bin/env python3
"""Kernels #7 and #8 (``render/mesh/csrc/texture.cu``, ``regather.cu``) on
the card: their registers and spills as ptxas reports them, then phases of
``chip_smoke.py`` run alone, each reported as that script reports it:

    python3 scripts/texture_card.py [PHASE ...]

The default phases are the texture kernels' own: ``phase_card``,
``phase_build``, ``phase_texfit_parity`` (#7 against its plain version at
the benchmark cells' shapes), ``phase_texfit_path`` (100 steps of the
texture fit, #7 and #8 once each way a step) and ``texture_timing`` (its
device and event ms beside the plain version's and ``grid_sample``'s);
``phase_regather_parity`` is #8's parity and timing. Any other
phase of ``chip_smoke.Smoke`` that needs no earlier phase's state may be
named, such as ``phase_render_path``, ``phase_io_path`` or
``phase_usd_path``, which render through easy_render's ``tex_sample``.
Exits 1 if a phase failed.
"""
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from kaolin_tpu_torch.utils import cuda_build  # noqa: E402

SOURCES = ("kaolin_tpu_torch/render/mesh/csrc/texture.cu",
           "kaolin_tpu_torch/render/mesh/csrc/regather.cu")
DEFAULT = ("phase_texfit_parity", "phase_texfit_path", "texture_timing")


def registers():
    """ptxas's report of the kernels' registers and spills, built with the
    port's flags for sm_90a."""
    for source in SOURCES:
        with tempfile.TemporaryDirectory() as d:
            out = subprocess.run(
                [str(cuda_build.find_nvcc()), *cuda_build.NVCC_FLAGS,
                 "-Xptxas", "-v", "-c", "-o", os.path.join(d, "kernel.o"),
                 os.path.join(ROOT, source)], capture_output=True, text=True)
        print("ptxas:", source, out.returncode, out.stdout, out.stderr,
              flush=True)


def main(names):
    registers()
    smoke = chip_smoke.Smoke()
    for name in ("phase_card", "phase_build", *(names or DEFAULT)):
        phase = getattr(smoke, name)
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            phase()
        except Exception:   # report the phase, run the others
            traceback.print_exc()
            smoke.failures.append(name)
        print(f"   ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    print("FAILURES", smoke.failures, flush=True)
    return 1 if smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
