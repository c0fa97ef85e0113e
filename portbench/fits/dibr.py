"""The DIB-R pose-and-texture fit: the loop a kaolin_tpu_torch user writes,
over the port's public API only.

A step: the pose v = R(unit q)·(exp(s)·(template [+ offsets])) + t
(``math.quat``); ``render.mesh.prepare_vertices`` with the step's cameras
(made once by ``render.camera.generate_transformation_matrix``, with
``generate_perspective_projection``); ``render.mesh.dibr_rasterization`` at
its defaults (sigmainv 7000, boxlen 0.02, multiplier 1000, faces with
camera-space normal z ≥ 0 kept) with the UVs and a mask of ones as
features; ``render.mesh.texture_mapping(..., "bilinear")`` times the mask;
the loss mean|I − I*| + ``metrics.render.mask_iou(soft, M*)`` [+ w·mean
‖L·v‖² with ``ops.mesh.uniform_laplacian`` built at set-up]; backward; and
``torch.optim.Adam``. The targets are rendered once at set-up, without
gradient, by the same pipeline.

Each layer runs inside a ``torch.profiler.record_function`` span of the
benchmark's (``SPANS``), which the per-layer metrics read.
"""

import torch
from torch.profiler import record_function

from kaolin_tpu_torch.math.quat import (
    quat_from_angle_axis,
    quat_unit,
    rot33_from_quat,
)
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.ops.mesh import uniform_laplacian
from kaolin_tpu_torch.render.camera import (
    generate_perspective_projection,
    generate_transformation_matrix,
)
from kaolin_tpu_torch.render.mesh import (
    dibr_rasterization,
    prepare_vertices,
    texture_mapping,
)

from portbench import traffic
from portbench.configs import dibr_inputs

SPANS = ("render_fwd", "texture_fwd", "loss", "backward", "optimizer")


def make_inputs(cfg, mix, seed, device):
    return dibr_inputs.make(cfg, traffic.cameras(mix, device), seed, device)


def posed_vertices(template, params):
    rot = rot33_from_quat(quat_unit(params["q"]))
    shape = template + params["offsets"] if "offsets" in params else template
    return (torch.exp(params["s"]) * shape) @ rot.T + params["t"]


def render(scene, params):
    """(image (B, H, W, 3), soft mask (B, H, W), rasterized mask
    (B, H, W), face_idx (B, H, W)) of every camera."""
    res = scene["res"]
    with record_function("render_fwd"):
        cams = scene["cams"]
        b = cams.shape[0]
        v = posed_vertices(scene["template"], params)
        fvc, fvi, normals = prepare_vertices(
            v[None], scene["faces"], scene["proj"], camera_transform=cams)
        uvs = scene["face_uvs"].expand(b, -1, -1, -1)
        (uv_image, mask), soft, face_idx = dibr_rasterization(
            res, res, fvc[..., 2], fvi,
            [uvs, torch.ones_like(uvs[..., :1])], normals[..., 2])
    with record_function("texture_fwd"):
        texture = params["texture"][None].expand(b, -1, -1, -1)
        image = texture_mapping(uv_image, texture, mode="bilinear") * mask
    return image, soft, mask[..., 0], face_idx


def build(cfg, inputs, device):
    """The fit's state: the scene (cameras, projection, Laplacian, targets
    rendered once), the parameters at their start and the optimizer."""
    scene = {
        "res": cfg["res"],
        "template": inputs["template"],
        "faces": inputs["faces"],
        "face_uvs": inputs["face_uvs"][None],
        "cams": generate_transformation_matrix(
            inputs["cam_pos"], inputs["look_at"], inputs["up"]),
        "proj": generate_perspective_projection(inputs["fovy"],
                                                device=device),
        "lap_weight": cfg["laplacian_weight"],
    }
    if scene["lap_weight"]:
        scene["laplacian"] = uniform_laplacian(
            inputs["template"].shape[0], inputs["faces"])
    target = {"texture": inputs["target_texture"],
              "offsets": inputs["target_shape"] - inputs["template"],
              "q": quat_from_angle_axis(inputs["target_angle"],
                                        inputs["target_axis"]),
              "t": inputs["target_t"],
              "s": torch.zeros(1, device=device)}
    with torch.no_grad():
        image, _, mask, _ = render(scene, target)
    scene["target_image"], scene["target_mask"] = image, mask
    tex = cfg["texture_size"]
    start = {"texture": torch.full((3, tex, tex), 0.5, device=device),
             "offsets": torch.zeros_like(inputs["template"]),
             "q": torch.tensor([0.0, 0.0, 0.0, 1.0], device=device),
             "t": torch.zeros(3, device=device),
             "s": torch.zeros(1, device=device)}
    params = {k: start[k].requires_grad_(True) for k in cfg["learn"]}
    opt = torch.optim.Adam(list(params.values()), lr=cfg["lr"])
    return {"scene": scene, "params": params, "opt": opt}


def losses(scene, params, image, soft):
    """(the loss, its terms): mean|I − I*| + mask_iou(soft, M*) [+ the
    weighted Laplacian term]."""
    terms = {"image": torch.mean(torch.abs(image - scene["target_image"])),
             "silhouette": mask_iou(soft, scene["target_mask"])}
    loss = terms["image"] + terms["silhouette"]
    if scene["lap_weight"]:
        lap = scene["laplacian"] @ posed_vertices(scene["template"], params)
        terms["laplacian"] = scene["lap_weight"] * torch.mean(
            torch.sum(lap * lap, dim=-1))
        loss = loss + terms["laplacian"]
    return loss, terms


def step(state):
    """One step of the fit → (the loss before it, the step's outputs:
    image, soft mask, face_idx and the loss terms), without a host read."""
    scene, params, opt = state["scene"], state["params"], state["opt"]
    with record_function("optimizer"):
        opt.zero_grad(set_to_none=True)
    image, soft, _, face_idx = render(scene, params)
    with record_function("loss"):
        loss, terms = losses(scene, params, image, soft)
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        opt.step()
    return loss.detach(), {"image": image.detach(), "soft": soft.detach(),
                           "face_idx": face_idx,
                           "terms": {k: v.detach() for k, v in terms.items()}}


def first_steps(state, n):
    """Run the fit's first ``n`` steps through :func:`step` and keep what
    the check compares: the parameters before them and after them, every
    step's loss terms, the first step's image, soft mask and face_idx, and
    the first gradient as Adam holds it (its first moment over 1 − β1)."""
    params, opt = state["params"], state["opt"]
    p0 = {k: p.detach().clone() for k, p in params.items()}
    terms = []
    for i in range(n):
        loss, out = step(state)
        terms.append({"total": loss, **out["terms"]})
        if i == 0:
            first = {k: out[k] for k in ("image", "soft", "face_idx")}
            beta1 = opt.param_groups[0]["betas"][0]
            grad = {k: opt.state[p]["exp_avg"] / (1 - beta1)
                    for k, p in params.items()}
    return {"p0": p0, "terms": terms, **first, "grad": grad,
            "p_end": {k: p.detach().clone() for k, p in params.items()}}


def geometry(state):
    """What the kernels' roofline counts its work from: the parameters as
    they stand (the scene it takes from the inputs)."""
    return {k: p.detach().clone() for k, p in state["params"].items()}
