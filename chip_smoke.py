#!/usr/bin/env python3
"""Run the PyTorch port's DIB-R inverse-rendering step on one NVIDIA GPU and
check it.

    python3 chip_smoke.py

Imports ``kaolin_tpu_torch`` only (no jax, no ``kaolin_tpu``). Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   TF32 off for matmuls and cuDNN;
2. build the CUDA kernels from ``kaolin_tpu_torch/**/csrc/*.cu`` (sm_90a);
3. hold each kernel against its plain PyTorch version on the card: winner
   ids exactly, the soft-mask forward within 1e-5, the soft-mask backward
   within 1e-4 of the plain gradient's largest entry (atomics reorder the
   sums); at 100x72 with B = 2, and at the config-2 shapes;
4. the main path: ``config2_step`` (512², a 4992-face UV sphere, forward and
   backward, 5 steps) with every launch counter set to 0 before and read
   after, its first step held against the same step through the plain
   versions; then the 64² silhouette optimisation of
   ``examples/torch_dibr_optimization.py`` (final loss < 0.30, |shift| <
   0.05);
5. time each kernel and the whole step against the plain versions with CUDA
   events, in the order plain, kernel, kernel, plain.

Prints a JSON line with each kernel's launches, error and times, and as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, without that
line, when there is no CUDA device or any phase fails.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = 512
STEPS = 5

KERNELS = {
    "winner": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/rasterize.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_rasterize.py:37",
    },
    "soft_mask_fwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:180",
    },
    "soft_mask_bwd": {
        "route": "cuda",
        "source": "kaolin_tpu_torch/render/mesh/csrc/soft_mask.cu",
        "replaces": "kaolin_tpu/render/mesh/pallas_soft_mask.py:207",
    },
}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def load_example():
    path = os.path.join(ROOT, "examples", "torch_dibr_optimization.py")
    spec = importlib.util.spec_from_file_location("torch_dibr_optimization",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Smoke:
    def __init__(self):
        import torch

        from kaolin_tpu_torch.render.mesh import (
            cuda_rasterize,
            cuda_soft_mask,
            dibr,
            rasterization,
        )
        from kaolin_tpu_torch.utils import cuda_build, from_numpy_tree

        self.torch = torch
        self.cr, self.cs = cuda_rasterize, cuda_soft_mask
        self.dibr, self.rast = dibr, rasterization
        self.cuda_build = cuda_build
        self.from_numpy_tree = from_numpy_tree
        self.ex = load_example()
        self.failures = []
        self.results = {name: dict(meta) for name, meta in KERNELS.items()}

    # -- helpers ---------------------------------------------------------
    def counters(self):
        return {"winner": self.cr.rasterize_search_cuda,
                "soft_mask_fwd": self.cs.soft_mask_fwd_cuda,
                "soft_mask_bwd": self.cs.soft_mask_bwd_cuda}

    def check(self, ok, what):
        print(("PASS " if ok else "FAIL ") + what, flush=True)
        if not ok:
            self.failures.append(what)

    def record_err(self, name, err):
        """Keep the largest error a kernel showed over the parity cases."""
        r = self.results[name]
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)

    def random_case(self):
        """64 random faces at 72x100 (ragged), B = 2: 16 faces culled
        (face_normals_z < 0), one with face_normals_z == 0 (kept), and two
        zero-area faces, a point on a pixel centre and a segment along a
        pixel row, which cover pixels only inside their bounding boxes."""
        import numpy as np
        rng = np.random.RandomState(0)
        tri = (rng.randn(2, 64, 3, 3) * 0.4).astype(np.float32)
        fvi = tri[..., :2] * np.float32(1000.0)
        # pixel centres as _pixel_coords rounds them: fl(1000 / n) * k
        x = np.float32(1000.0 / 100) * np.float32(2 * 60 + 1 - 100)
        y = np.float32(1000.0 / 72) * np.float32(72 - 2 * 30 - 1)
        fvi[:, 17] = [[x, y]] * 3
        fvi[:, 18] = [[-300.0, y], [100.0, y], [400.0, y]]
        nz = rng.randn(2, 64).astype(np.float32)
        nz[:, :16] = -1.0
        nz[:, 16] = 0.0
        nz[:, 17:19] = 1.0
        data = self.from_numpy_tree(
            {"fvz": tri[..., 2] - 2.0, "fvi": fvi, "valid": nz >= 0}, "cuda")
        return data, 72, 100

    def sphere_case(self, res):
        d = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        return ({"fvz": d["face_vertices_z"],
                 "fvi": (d["face_vertices_image"] * 1000.0).contiguous(),
                 "valid": d["face_normals_z"] >= 0}, res, res)

    def soft_cotangent(self, d, h, w):
        """The cotangent on allprob that loss sum(soft²) gives, and
        allprob, for a case."""
        torch = self.torch
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)
            allprob = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                1000.0, h, w)
            g = torch.where(idx >= 0, 0.0, -2.0 * (1.0 - allprob))
        return g, allprob

    def time_ms(self, fn, reps):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    def compare_times(self, kernel_fn, plain_fn, reps, plain_reps):
        """Medians over plain, kernel, kernel, plain runs."""
        import statistics
        p = self.time_ms(plain_fn, plain_reps)
        k = self.time_ms(kernel_fn, reps)
        k += self.time_ms(kernel_fn, reps)
        p += self.time_ms(plain_fn, plain_reps)
        return statistics.median(k), statistics.median(p)

    # -- phases ----------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.card = card_line()
        print(f"card: {self.card}")
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, device "
              f"{torch.cuda.get_device_name(0)}, count "
              f"{torch.cuda.device_count()}", flush=True)

    def phase_build(self):
        cb = self.cuda_build
        print("building:", " ".join(cb.NVCC_FLAGS))
        for s in cb.sources():
            print("  source", os.path.relpath(s, ROOT))
        t0 = time.perf_counter()
        cb.library()
        print(f"built {os.path.relpath(cb.library_path(), ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    def phase_parity(self):
        torch = self.torch
        cases = [("random 72x100 B=2", self.random_case()),
                 (f"sphere {RES}x{RES}", self.sphere_case(RES))]
        for label, (d, h, w) in cases:
            ids_k = self.cr.rasterize_search_cuda(d["fvz"], d["fvi"],
                                                  d["valid"], 1000, 1e-8, h, w)
            ids_p = self.rast.rasterize_search_plain(d["fvz"], d["fvi"],
                                                     d["valid"], 1000, 1e-8,
                                                     h, w)
            bad = int((ids_k != ids_p).sum())
            hits = int((ids_p >= 0).sum())
            self.check(bad == 0 and hits > 0,
                       f"winner ids exact [{label}]: {bad} of {ids_p.numel()}"
                       f" differ ({hits} covered)")
            self.record_err("winner", float((ids_k - ids_p).abs().max()))
            if label.startswith("random"):
                rows = torch.nonzero(ids_k == 18)[:, 1]
                self.check(bool((ids_k[:, 30, 60] == 17).all())
                           and rows.numel() > 0 and bool((rows == 30).all()),
                           f"zero-area faces stay in their boxes [{label}]")

            ap_k = self.cs.soft_mask_fwd_cuda(d["fvi"], 7000.0, 0.02, 1000.0,
                                              h, w)
            with torch.no_grad():
                ap_p = self.dibr.soft_mask_plain(d["fvi"], 7000.0, 0.02,
                                                 1000.0, h, w)
            err = float((ap_k - ap_p).abs().max())
            self.check(err <= 1e-5 and float(ap_p.min()) < 0.99,
                       f"soft-mask forward within 1e-5 [{label}]: "
                       f"max abs err {err:.3e}")
            self.record_err("soft_mask_fwd", err)

        bwd_cases = [("random 72x100 B=2", self.random_case()),
                     ("sphere 128x128", self.sphere_case(128)),
                     (f"sphere {RES}x{RES}", self.sphere_case(RES))]
        for label, (d, h, w) in bwd_cases:
            g, allprob = self.soft_cotangent(d, h, w)
            grad_k = self.cs.soft_mask_bwd_cuda(
                d["fvi"], (g * allprob).contiguous(), 7000.0, 0.02, 1000.0,
                h, w)
            grad_p = self.dibr._soft_mask_bwd_plain(d["fvi"], g, 7000.0,
                                                    0.02, 1000.0, h, w)
            scale = float(grad_p.abs().max())
            err = float((grad_k - grad_p).abs().max())
            self.check(scale > 0 and err / scale <= 1e-4,
                       f"soft-mask backward within 1e-4 of max|grad| "
                       f"[{label}]: max abs err {err:.3e}, max|grad| "
                       f"{scale:.3e}, ratio {err / max(scale, 1e-30):.3e}")
            self.record_err("soft_mask_bwd", err)
        torch.cuda.synchronize()

    def plain_loss(self, inputs, fvi, feats, res):
        """config2_loss with the plain versions in place of the kernels."""
        torch = self.torch
        scaled = fvi * 1000
        with torch.no_grad():
            idx = self.rast.rasterize_search_plain(
                inputs["face_vertices_z"], scaled.detach(),
                inputs["face_normals_z"] >= 0, 1000, 1e-8, res, res)
        img = self.rast._interpolate_at_winners(idx, scaled, feats, 1000,
                                                1e-8)
        allprob = self.dibr.soft_mask_plain(scaled, 7000, 0.02, 1000.0, res,
                                            res)
        soft = torch.where(idx >= 0, 1.0, 1.0 - allprob)
        return torch.sum(img ** 2) + torch.sum(soft ** 2)

    def phase_main_path(self):
        torch = self.torch
        for fn in self.counters().values():
            fn.launches = 0
        out = self.ex.config2_step("cuda", res=RES, steps=STEPS)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in self.counters().items()}
        print(f"config2_step {RES}x{RES}, {STEPS} steps: losses "
              f"{out['losses']}; launches {launches}")
        for k, n in launches.items():
            self.results[k]["launches"] = n
            self.check(n > 0, f"main path launched {k} ({n} times)")
        self.check(all(map(lambda x: x == x and abs(x) != float("inf"),
                           out["losses"])), "config-2 losses finite")
        for name in ("grad_fvi", "grad_feat"):
            g = out[name]
            self.check(bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0,
                       f"config-2 {name} finite and non-zero "
                       f"(max {float(g.abs().max()):.3e})")

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        lk, gvk, gfk = self.ex.config2_grad(inputs, fvi, feats, RES)
        lp, gvp, gfp = self.ex.config2_grad(inputs, fvi, feats, RES,
                                            loss_fn=self.plain_loss)
        rel = abs(float(lk) - float(lp)) / abs(float(lp))
        self.check(rel <= 1e-5, f"config-2 loss kernels vs plain: "
                   f"{float(lk):.6f} vs {float(lp):.6f} (rel {rel:.2e})")
        for name, a, b in (("fvi", gvk, gvp), ("features", gfk, gfp)):
            ratio = float((a - b).abs().max() / b.abs().max())
            self.check(ratio <= 1e-4, f"config-2 grad {name} kernels vs "
                       f"plain within 1e-4 of max: {ratio:.2e}")

        counts0 = {k: fn.launches for k, fn in self.counters().items()}
        losses, shift = self.ex.main("cuda", res=64, iters=60)
        counts1 = {k: fn.launches - counts0[k]
                   for k, fn in self.counters().items()}
        self.check(losses[-1] < 0.30 and abs(shift) < 0.05,
                   f"64x64 optimisation: final loss {losses[-1]:.4f} "
                   f"(< 0.30), shift {shift:+.4f} (|.| < 0.05); "
                   f"launches {counts1}")
        self.check(all(n > 0 for n in counts1.values()),
                   "64x64 optimisation ran through every kernel")

    def phase_timing(self):
        torch = self.torch
        print(f"timing on {self.card}", flush=True)
        d, h, w = self.sphere_case(RES)
        g, allprob = self.soft_cotangent(d, h, w)
        ga = (g * allprob).contiguous()
        pairs = {
            "winner": (
                lambda: self.cr.rasterize_search_cuda(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w),
                lambda: self.rast.rasterize_search_plain(
                    d["fvz"], d["fvi"], d["valid"], 1000, 1e-8, h, w)),
            "soft_mask_fwd": (
                lambda: self.cs.soft_mask_fwd_cuda(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w),
                lambda: self.dibr.soft_mask_plain(
                    d["fvi"], 7000.0, 0.02, 1000.0, h, w)),
            "soft_mask_bwd": (
                lambda: self.cs.soft_mask_bwd_cuda(
                    d["fvi"], ga, 7000.0, 0.02, 1000.0, h, w),
                lambda: self.dibr._soft_mask_bwd_plain(
                    d["fvi"], g, 7000.0, 0.02, 1000.0, h, w)),
        }
        for name, (kern, plain) in pairs.items():
            with torch.no_grad():
                k_ms, p_ms = self.compare_times(kern, plain, 20, 5)
            self.results[name]["ms"] = k_ms
            self.results[name]["plain_ms"] = p_ms
            print(f"{name} at {h}x{w}, 4992 faces, B=1: kernel {k_ms:.4f} ms,"
                  f" plain {p_ms:.4f} ms", flush=True)

        inputs = self.from_numpy_tree(self.ex.config2_inputs(), "cuda")
        fvi, feats = inputs["face_vertices_image"], inputs["face_features"]
        k_ms, p_ms = self.compare_times(
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES),
            lambda: self.ex.config2_grad(inputs, fvi, feats, RES,
                                         loss_fn=self.plain_loss), 10, 3)
        print(f"config-2 step (forward + backward) at {RES}x{RES}, 4992 "
              f"faces: kernels {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"[{self.card}]", flush=True)

    def run(self):
        for phase in (self.phase_card, self.phase_build, self.phase_parity,
                      self.phase_main_path, self.phase_timing):
            print(f"== {phase.__name__}", flush=True)
            try:
                phase()
            except Exception:   # report the phase, run the others
                traceback.print_exc()
                sys.stdout.flush()
                self.failures.append(phase.__name__)
                if phase in (self.phase_card, self.phase_build):
                    break
        return not self.failures


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smoke = Smoke()
    ok = smoke.run()
    if not ok:
        print(f"chip_smoke: FAILED {smoke.failures}", file=sys.stderr)
        return 1
    kernels = [{"name": name, **r} for name, r in smoke.results.items()]
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
