"""The Simplicits contact stack's check: each of the program's first frames
against one step of the plain reference (:mod:`.simplicits_contact`) from
the state the program started that frame in; the control and the planted
faults put in the program's place; and the numbers that decide
``correct``.

Why a step at a time, and why each frame's gap is taken over what float32
rounding moves there. Where the cubes strike the plate and one another,
and where the stack settles by stick and slip, kaolin's contact model can
make the step turn with the last bits of the state: the friction terms of
its contact Hessian make H indefinite where contacts press, Newton's five
iterations do not converge there, and the Armijo search's step sizes and
the contact bounds' least ratio over thousands of pairs follow the
rounding. In such a frame the reference in float32 and in float64, from
one state, part by up to a tenth of a cube's side; in most frames they
agree to a few float32 roundings. Free-running frames then part for good,
whatever computes them. So each frame is compared from the program's own
start (from rest where the traffic resets the scene), and each gap is
divided by that frame's own rounding spread: the distance between the
reference's step in float32 and in float64 from the same start, plus a
floor of a few float32 roundings (``FLOORS``). A frame whose step rounding
decides reads about 1 whatever computes it; one that rounding does not
decide reads how many of its roundings the program is off.

``run(cfg, inputs, n_steps)`` gives the reference (TF32 off, float32, and
float64 for the spread) that ``numbers`` steps. ``tf32=True`` is the
control of the nearest lower precision, ``fault`` a planted physics fault
the check must catch: ``"stiffness_half"`` (the contact stiffness halved),
``"friction_0"`` (no friction) or ``"friction_0_from_40"`` (no friction
from frame 40 on: a fault of the settling stack alone); either runs the
reference through the first ``n_steps`` frames from rest as the program
runs them (``first_steps``'s record, ``portbench.fits.simplicits_contact``):
each frame's start (the cubes' displacement and velocity), its cube points
after and the total energy (kinetic, elastic, gravity, floor and the
contact barrier) there.

The numbers (``numbers``; ``numbers_of`` reads them from ``details``), over
the frames whose start has contact pairs by the reference's detection,
each the median of a frame's gap between the program's result and the
reference's float32 step, over that frame's spread:

- ``pts``: the largest distance between a program point and the
  reference's, over a cube's side.
- ``height``: the largest gap in a cube's mean height (y, m).
- ``energy``: the gap in total energy, over the largest magnitude of the
  reference's total energy over the frames.

and, over the frames without contact (the free fall from rest, and from
rest again after a reset), ``free``: the largest of their ``pts`` ratios.
"""

import statistics

import torch

from portbench.reference.simplicits_contact import Stack, frames, steps_from

FAULTS = ("stiffness_half", "friction_0", "friction_0_from_40")
NUMBERS = ("pts", "height", "energy", "free")
# each ratio's floor: a few float32 roundings of a point over a cube's
# side (points lie within 1 m of the origin), of a cube's mean height (m)
# and of the total energy over its largest magnitude
FLOORS = {"pts": 1e-6, "height": 1e-7, "energy": 1e-6}
PLANTED = {"stiffness_half": (0, lambda cfg: {
               "collision_penalty": cfg["collision_penalty"] / 2}),
           "friction_0": (0, lambda cfg: {"friction": 0.0}),
           "friction_0_from_40": (40, lambda cfg: {"friction": 0.0})}


class _Tf32:
    """TF32 on or off inside, as it was after."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def run(cfg, inputs, n_steps, tf32=False, fault=None):
    """The reference for ``numbers``; with ``tf32`` or ``fault``, also its
    first ``n_steps`` frames as the program runs them (see the module's
    docstring)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    rec = {"stack": Stack(cfg, inputs, torch.float32),
           "stack64": Stack(cfg, inputs, torch.float64),
           "side": cfg["cube_side"], "cubes": cfg["cubes"],
           "episode_frames": inputs["episode_frames"]}
    if tf32 or fault is not None:
        first, faulty = 0, rec["stack"]
        if fault is not None:
            first, change = PLANTED[fault]
            faulty = Stack({**cfg, **change(cfg)}, inputs, torch.float32)

        def stack_of(i):
            return faulty if i >= first else rec["stack"]

        with _Tf32(tf32):
            starts, pts, energy = frames(stack_of, n_steps,
                                         inputs["episode_frames"])
        rec.update(starts=starts, pts=pts, energy=energy)
    return rec


def _steps(prog, ref_rec):
    """The reference's steps from the program's starts (TF32 off), in
    float32 and in float64, once a record: (points, energies, pairs) each."""
    key = id(prog)
    cache = ref_rec.setdefault("steps", {})
    if key not in cache:
        with _Tf32(False):
            cache[key] = (prog, [
                steps_from(ref_rec[s], prog["starts"],
                           ref_rec["episode_frames"])
                for s in ("stack", "stack64")])
    return cache[key][1]


def _gaps(p, r, k, side):
    """(largest point gap over the side, largest gap of a cube's mean
    height) of points p and r (6N, 3), in float64."""
    p, r = p.double(), r.double()
    heights = (p[:, 1].reshape(k, -1).mean(1)
               - r[:, 1].reshape(k, -1).mean(1)).abs()
    return float((p - r).norm(dim=1).max()) / side, float(heights.max())


def details(prog, ref_rec):
    """Each frame's gaps between the program and the reference's float32
    step and spreads between that step and the float64 one (points over
    the side, heights in m, energies in J), the energies' scale, and each
    frame's contact pairs at its start by the reference's detection,
    between cubes and with the plate."""
    (r32, e32, pairs), (r64, e64, _) = _steps(prog, ref_rec)
    k, side = ref_rec["cubes"], ref_rec["side"]
    out = {name: [] for name in (
        "pts_by_frame", "height_by_frame", "energy_by_frame",
        "pts_spread_by_frame", "height_spread_by_frame",
        "energy_spread_by_frame")}
    for i, (p, ep) in enumerate(zip(prog["pts"], prog["energy"],
                                    strict=True)):
        gap = _gaps(p, r32[i], k, side)
        spread = _gaps(r32[i], r64[i], k, side)
        out["pts_by_frame"].append(gap[0])
        out["height_by_frame"].append(gap[1])
        out["energy_by_frame"].append(abs(float(ep) - float(e32[i])))
        out["pts_spread_by_frame"].append(spread[0])
        out["height_spread_by_frame"].append(spread[1])
        out["energy_spread_by_frame"].append(
            abs(float(e32[i]) - float(e64[i])))
    out["energy_scale"] = float(e32.double().abs().max())
    out["cube_pairs_by_frame"] = [int(c) for c in pairs[:, 0]]
    out["plate_pairs_by_frame"] = [int(c) for c in pairs[:, 1]]
    return out


def ratios(det, name):
    """Each frame's gap over its spread plus the floor (``FLOORS``)."""
    scale = det["energy_scale"] if name == "energy" else 1.0
    return [g / scale / (s / scale + FLOORS[name])
            for g, s in zip(det[f"{name}_by_frame"],
                            det[f"{name}_spread_by_frame"], strict=True)]


def numbers_of(det):
    """{name: value} of ``NUMBERS`` from ``details``."""
    contact = [c + p > 0 for c, p in zip(det["cube_pairs_by_frame"],
                                         det["plate_pairs_by_frame"])]
    out = {}
    for name in ("pts", "height", "energy"):
        out[name] = statistics.median(
            [r for r, c in zip(ratios(det, name), contact) if c] or [0.0])
    out["free"] = max((r for r, c in zip(ratios(det, "pts"), contact)
                       if not c), default=0.0)
    return out


def numbers(prog, ref_rec):
    """{name: value} of ``NUMBERS``, in that order; nan where a side is not
    finite."""
    finite = all(bool(torch.isfinite(t).all())
                 for t in prog["pts"] + prog["energy"]
                 + [x for s in prog["starts"] for x in s])
    if not finite:
        return {k: float("nan") for k in NUMBERS}
    det = details(prog, ref_rec)
    if not all(torch.isfinite(torch.tensor(
            [det["energy_scale"]] + det["energy_spread_by_frame"]
            + det["pts_spread_by_frame"]))):
        return {k: float("nan") for k in NUMBERS}
    return numbers_of(det)
