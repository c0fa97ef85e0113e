"""The DIB-R fit's first steps by the plain reference (:mod:`.dibr`), from
the benchmark's inputs alone; the controls put in the program's place; and
the numbers that decide ``correct``.

``run`` gives what the program's first steps give
(``portbench.fits.dibr.first_steps``): the parameters before and after,
every step's loss terms, the first step's image, soft mask and face_idx,
and the first gradient. The reference turns TF32 off. ``tf32=True`` is the
control of the nearest lower precision; ``fault`` plants one of the
faults the check must catch: ``"half_batch"`` (the loss over the first
half of the step's views, the mean over the rest) or ``"image"`` (the first
step's image altered at one pixel where it is produced).

The numbers (``numbers``), program against reference:

- ``face_idx``: the share of the first step's pixels whose winning face
  differs.
- ``soft_mask``, ``image``: the largest gap of the first step's soft mask
  and image.
- ``loss``: the largest relative gap of the loss over the checked steps.
- ``grad``: by the worst leaf, the gap between the program's norm of the
  first gradient and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf.
- ``change``: the same, of the parameters' change over the checked steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (round-off alone moves the others under Adam).
"""

import math
import statistics

import torch

from portbench.reference import compare
from portbench.reference import dibr as ref

FAULTS = ("half_batch", "image")
NUMBERS = ("face_idx", "soft_mask", "image", "loss", "grad", "change")


def _render(cfg, scene, params, limit, soft=True):
    b = scene["cams"].shape[0]
    v = ref.posed_vertices(scene["template"], params)
    fvz, fvi, nz = ref.prepare_vertices(v[None], scene["faces"],
                                        scene["proj"], scene["cams"])
    uvs = scene["face_uvs"][None].expand(b, -1, -1, -1)
    feats = torch.cat([uvs, torch.ones_like(uvs[..., :1])], dim=-1)
    soft_cfg = cfg["soft_mask"]
    res = cfg["res"]
    img, soft, face_idx = ref.dibr_rasterization(
        res, res, fvz, fvi, feats, nz, soft_cfg["sigmainv"],
        soft_cfg["boxlen"], soft_cfg["multiplier"], limit, soft)
    mask = img[..., 2:3]
    tex = params["texture"][None].expand(b, -1, -1, -1)
    image = ref.texture_mapping(img[..., :2], tex) * mask
    return image, soft, mask[..., 0], face_idx


def run(cfg, inputs, n_steps, tf32=False, fault=None):
    """The reference's first ``n_steps`` steps → the record the check
    compares (see the module's docstring)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _run(cfg, inputs, n_steps, fault)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _run(cfg, inputs, n_steps, fault):
    device = inputs["template"].device
    limit = cfg["reference_pairs"]
    template, faces = inputs["template"], inputs["faces"]
    scene = {"template": template, "faces": faces,
             "face_uvs": inputs["face_uvs"],
             "cams": ref.look_at_matrices(inputs["cam_pos"],
                                          inputs["look_at"], inputs["up"]),
             "proj": ref.projection(inputs["fovy"], torch.float32, device)}
    target = {"texture": inputs["target_texture"],
              "offsets": inputs["target_shape"] - template,
              "q": ref.quat_from_angle_axis(inputs["target_angle"],
                                            inputs["target_axis"]),
              "t": inputs["target_t"], "s": torch.zeros(1, device=device)}
    with torch.no_grad():
        t_image, _, t_mask, _ = _render(cfg, scene, target, limit,
                                        soft=False)
    lap = ref.uniform_laplacian(template.shape[0], faces) \
        if cfg["laplacian_weight"] else None
    tex = cfg["texture_size"]
    start = {"texture": torch.full((3, tex, tex), 0.5, device=device),
             "offsets": torch.zeros_like(template),
             "q": torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
             "t": torch.zeros(3, device=device),
             "s": torch.zeros(1, device=device)}
    params = {k: start[k].clone().requires_grad_(True) for k in cfg["learn"]}
    p0 = {k: p.detach().clone() for k, p in params.items()}
    adam, terms = {}, []
    for i in range(n_steps):
        for p in params.values():
            p.grad = None
        image, soft, _, face_idx = _render(cfg, scene, params, limit)
        if fault == "image" and i == 0:
            image = image.clone()
            image[0, image.shape[1] // 2, image.shape[2] // 2, 0] += 0.25
        keep = slice(None)
        if fault == "half_batch":
            keep = slice(0, math.ceil(image.shape[0] / 2))
        step_terms = {"image": torch.mean(torch.abs(image[keep]
                                                    - t_image[keep])),
                      "silhouette": ref.mask_iou(soft[keep], t_mask[keep])}
        loss = step_terms["image"] + step_terms["silhouette"]
        if lap is not None:
            lv = lap @ ref.posed_vertices(template, params)
            step_terms["laplacian"] = cfg["laplacian_weight"] * torch.mean(
                torch.sum(lv * lv, dim=-1))
            loss = loss + step_terms["laplacian"]
        loss.backward()
        if i == 0:
            first = {"image": image.detach(), "soft": soft.detach(),
                     "face_idx": face_idx}
            grad = {k: p.grad.detach().clone() for k, p in params.items()}
        ref.adam_step(params, adam, cfg["lr"], i + 1)
        terms.append({"total": loss.detach(),
                      **{k: v.detach() for k, v in step_terms.items()}})
    return {"p0": p0, "terms": terms, **first, "grad": grad,
            "p_end": {k: p.detach().clone() for k, p in params.items()}}


def _changes(prog, ref_rec):
    """Each side's norm of each leaf's change over the steps, of the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's."""
    g_ref = compare.norms(ref_rec["grad"])
    floor = 1e-3 * statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= floor]
    return tuple(compare.norms({k: rec["p_end"][k] - rec["p0"][k]
                                for k in moved}) for rec in (prog, ref_rec))


def numbers(prog, ref_rec):
    """{name: value} of ``NUMBERS``, in that order; nan where a side is not
    finite."""
    out = {
        "face_idx": float((prog["face_idx"] != ref_rec["face_idx"]).double()
                          .mean()),
        "soft_mask": float((prog["soft"] - ref_rec["soft"]).abs().max()),
        "image": float((prog["image"] - ref_rec["image"]).abs().max()),
        "loss": max(compare.rel(p["total"], r["total"]) for p, r in
                    zip(prog["terms"], ref_rec["terms"], strict=True)),
        "grad": max(compare.leaf_gaps(compare.norms(prog["grad"]),
                                      compare.norms(ref_rec["grad"]))
                    .values()),
        "change": max(compare.leaf_gaps(*_changes(prog, ref_rec)).values()),
    }
    ok = all(compare.finite(rec["grad"], rec["p_end"],
                            {"i": rec["image"], "s": rec["soft"]})
             for rec in (prog, ref_rec))
    return out if ok else {k: float("nan") for k in out}


def details(prog, ref_rec):
    """The readings beside the numbers: every loss term's relative gap in
    every step, and each leaf's gap of the first gradient and of the
    change."""
    return {"loss_by_step": [{k: compare.rel(p[k], r[k]) for k in r}
                             for p, r in zip(prog["terms"], ref_rec["terms"],
                                             strict=True)],
            "grad_by_leaf": compare.leaf_gaps(compare.norms(prog["grad"]),
                                              compare.norms(ref_rec["grad"])),
            "change_by_leaf": compare.leaf_gaps(*_changes(prog, ref_rec))}
