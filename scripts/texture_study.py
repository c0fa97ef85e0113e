#!/usr/bin/env python3
"""The DIB-R fit's texture layer on the card, at the benchmark cells' shapes.

For each of ``texfit.v8`` and ``asset.v8`` (``portbench``'s cells: 8 views
of 512² a step, a shared 3 x 256² or 3 x 1,024² texture) the fit runs 10
steps from ``--seed``'s inputs; one more forward and backward keeps the
UVs, the texture and the output gradient that ``texture_mapping`` sees.
Then, in device ms from ``torch.profiler`` (10 calls, warm):

* the share of pixels whose output gradient is not 0: kernel #7's device
  counters (``render.mesh.texture_bwd.pixels`` and ``.pixels_added``) over
  20 profiled steps of the fit, and the share of the kept pixels at UV
  (0, 0), where the rasterizer leaves the background;
* the plain backward (``texture_mapping_plain``, four gathers and their
  scatter-adds) on the kept inputs, its scatter-adds apart: with the
  background's UVs as the rasterizer leaves them (``uv0``: every tap of
  those pixels on one texel) or spread at random over the texture
  (``spread``: the same adds of zero, on other texels), and with the
  texture expanded to the 8 views (``expanded``) or the views flattened
  into one batch of one texture (``flat``: no expanded copy);
* kernel #7's backward and forward on the kept inputs.

    python3 scripts/texture_study.py [--seed N] [--out FILE.json]

Prints one JSON line a cell, and writes both to ``--out`` where given.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

from kaolin_tpu_torch.render.mesh import cuda_texture  # noqa: E402
from kaolin_tpu_torch.render.mesh import utils as tm  # noqa: E402
from kaolin_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness  # noqa: E402
from portbench.fits import dibr  # noqa: E402

CUDA = torch.autograd.DeviceType.CUDA


def device_ms(fn, reps=10):
    """(device ms a call of ``fn``, of it in scatter kernels), warm."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
          if e.device_type == CUDA
          and not getattr(e, "is_user_annotation", False)]
    total = sum(us for _, us in ev) / reps / 1e3
    scatter = sum(us for n, us in ev if "scatter" in n) / reps / 1e3
    return total, scatter


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2147483999,
                    help="the cells' inputs (the benchmark's --seed)")
    ap.add_argument("--out")
    args = ap.parse_args()
    bench = harness.benchmark()
    out = {}
    for cell in ("texfit.v8", "asset.v8"):
        wl, _, cfg, mix = harness.cell(bench, cell)
        inputs = dibr.make_inputs(cfg, mix, args.seed, "cuda")
        state = dibr.build(cfg, inputs, "cuda")
        for _ in range(10):
            dibr.step(state)
        kept = {}
        real = dibr.texture_mapping

        def keep(uv, tex, mode):
            o = real(uv, tex, mode)
            o.retain_grad()
            kept.update(uv=uv.detach(), tex=tex.detach(), out=o)
            return o
        dibr.texture_mapping = keep
        image, soft, _, _ = dibr.render(state["scene"], state["params"])
        dibr.losses(state["scene"], state["params"], image, soft)[0] \
            .backward()
        dibr.texture_mapping = real
        state["opt"].zero_grad(set_to_none=True)
        uv, tex, cot = kept["uv"], kept["tex"], kept["out"].grad.detach()
        b = uv.shape[0]
        live = (cot != 0).any(-1)
        bg = (uv == 0).all(-1)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            for _ in range(20):
                dibr.step(state)
            torch.cuda.synchronize()
        got = profiling.counters()
        pixels, added = (got[k] for k in cuda_texture.PIXELS)
        r = {"pixels": pixels, "pixels_added": added,
             "added_share": added / pixels,
             "live_share_of_this_step": float(live.float().mean()),
             "background_uv0_share": float(bg.float().mean()),
             "live_at_uv0": int((live & bg).sum())}
        g = torch.Generator(device="cuda").manual_seed(5)
        spread = torch.where(bg[..., None], torch.rand(
            uv.shape, device="cuda", generator=g), uv)
        for name, u in (("uv0", uv), ("spread", spread)):
            for layout in ("expanded", "flat"):
                if layout == "expanded":
                    uu = u.reshape(b, -1, 2).clone().requires_grad_(True)
                    t = tex[:1].clone().requires_grad_(True)
                    batch = t.expand(b, -1, -1, -1)
                    c = cot.reshape(b, -1, 3)
                else:
                    uu = u.reshape(1, -1, 2).clone().requires_grad_(True)
                    t = tex[:1].clone().requires_grad_(True)
                    batch = t
                    c = cot.reshape(1, -1, 3)
                o = tm.texture_mapping_plain(uu, batch, "bilinear")

                def bwd(o=o, uu=uu, t=t, c=c):
                    return torch.autograd.grad(o, (uu, t), c,
                                               retain_graph=True)
                r[f"plain_bwd_{name}_{layout}_ms"] = device_ms(bwd)
        uu = uv.clone().requires_grad_(True)
        t = tex[:1].clone().requires_grad_(True)
        o = tm.texture_mapping(uu, t.expand(b, -1, -1, -1), "bilinear")
        r["kernel_bwd_uv0_ms"] = device_ms(lambda: torch.autograd.grad(
            o, (uu, t), cot, retain_graph=True))
        r["kernel_fwd_ms"] = device_ms(lambda: tm.texture_mapping(
            uu, t.expand(b, -1, -1, -1), "bilinear"))
        out[cell] = r
        print(cell, json.dumps(r), flush=True)
        del state, kept, o
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
