"""Hand numpy data to the port, so both packages see identical inputs, and
carry the JAX package's Simplicits MLP weights, RKPM fields, physics points,
contact buffers, configured ``Collision`` objects, SPC convolution
parameters, nglod-style feature fields, the DMTet tutorial's MLP, gaussian
splat models, Bayesian-fusion 3-state SPCs, surface meshes, PBR materials,
SG lights and graph convolutions into the port."""

import numpy as np
import torch


def from_numpy_tree(tree, device):
    """Turn arrays nested in dicts, lists, tuples and namedtuples into torch
    tensors on ``device``, keeping each array's dtype and shape. The tensors
    own their memory (the arrays are copied).

    A namedtuple comes back as the same type, built field by field; its
    fields that are not arrays (a Python int such as ``RasterSPC.level``)
    stay as they are."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            from_numpy_tree(v, device)
            if hasattr(v, "__array__") or isinstance(v, (dict, list, tuple))
            else v for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_numpy_tree(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def simplicits_mlp_from_jax(params, bb_min=None, bb_max=None):
    """The port's :class:`~kaolin_tpu_torch.physics.simplicits.SimplicitsMLP`
    holding the JAX package's MLP weights: ``params`` is its list of
    ``{"w": (in, out), "b": (out,)}`` arrays (numpy, or anything
    ``np.asarray`` takes), transposed here into ``nn.Linear``'s (out, in).
    ``bb_min``/``bb_max`` are the skinning function's box."""
    from kaolin_tpu_torch.physics.simplicits.network import SimplicitsMLP

    ws = [np.array(layer["w"], np.float32) for layer in params]
    bs = [np.array(layer["b"], np.float32) for layer in params]
    mlp = SimplicitsMLP(ws[0].shape[0], ws[0].shape[1], ws[-1].shape[1] + 1,
                        len(ws) - 2, bb_min=bb_min, bb_max=bb_max)
    with torch.no_grad():
        for linear, w, b in zip(mlp.layers, ws, bs):
            if tuple(linear.weight.shape) != w.T.shape:
                raise ValueError(f"layer of shape {w.shape} does not fit "
                                 f"the architecture {mlp.layers}")
            linear.weight.copy_(torch.from_numpy(w.T.copy()))
            linear.bias.copy_(torch.from_numpy(b))
    return mlp


def simplicits_rkpm_from_jax(skin):
    """The port's :class:`~kaolin_tpu_torch.physics.simplicits.
    SimplicitsRKPM` holding a JAX ``SimplicitsRKPM``'s state: its box, its
    RKPM nodes and radii and its eigenvectors (float64, as built)."""
    from kaolin_tpu_torch.physics.simplicits.rkpm import SimplicitsRKPM

    out = SimplicitsRKPM(num_handles=skin.num_handles + 1,
                         num_nodes=skin.num_nodes,
                         radius_scale=skin.radius_scale,
                         radius_init_kNN=skin.radius_init_kNN,
                         radius_min=skin.radius_min,
                         num_points=skin.num_points,
                         bb_min=np.array(skin.bb_min),
                         bb_max=np.array(skin.bb_max))
    out.rkpm.set_kernels(np.array(skin.rkpm.nodes),
                         np.array(skin.rkpm.radius))
    out.evecs = np.array(skin.evecs)
    return out


def physics_points_from_jax(points, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.physics.simplicits.
    PhysicsPoints` holding a JAX ``PhysicsPoints``' points, per-point
    materials and volume on ``device``."""
    from kaolin_tpu_torch.physics.simplicits.training import PhysicsPoints

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return PhysicsPoints(conv(points.pts), conv(points.yms),
                         conv(points.prs), conv(points.rhos),
                         float(points.appx_vol))


def contacts_from_jax(contacts, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.physics.common.Contacts` holding
    a JAX ``Contacts`` buffer's arrays (numpy, or anything ``np.asarray``
    takes): the same values, indices as int64, fields that are None kept
    None."""
    from kaolin_tpu_torch.physics.common.collisions import Contacts

    def conv(name, value):
        if value is None:
            return None
        a = np.array(value, copy=True)
        if name.startswith("indices"):
            a = a.astype(np.int64)
        return torch.from_numpy(a).to(device)

    return Contacts(**{name: conv(name, getattr(contacts, name))
                       for name in Contacts._fields})


_COLLISION_FIELDS = (
    "dt", "collision_radius", "collision_detection_ratio",
    "collision_barrier_ratio", "ignore_self_collision_ratio",
    "collision_penalty_stiffness", "friction_reg", "friction_fluid",
    "friction", "max_contacts", "bounds", "broad_phase", "cell_capacity",
    "sweep_window", "slot_contact_capacity", "max_occupied_cells",
    "point_contact_capacity", "grid_dims", "grid_cell")


def collision_from_jax(collision):
    """The port's :class:`~kaolin_tpu_torch.physics.common.Collision` with a
    configured JAX ``Collision``'s parameters, capacities and grid geometry
    (dims, origin, cell): both then detect over the same grid."""
    from kaolin_tpu_torch.physics.common.collisions import Collision

    out = Collision(dt=1.0)
    for name in _COLLISION_FIELDS:
        value = getattr(collision, name)
        if name == "grid_dims" and value is not None:
            value = tuple(int(d) for d in value)
        elif isinstance(value, (np.generic, np.ndarray)) or hasattr(
                value, "__array__"):
            value = np.asarray(value).item()
        setattr(out, name, value)
    if collision.grid_origin is not None:
        out.grid_origin = np.array(collision.grid_origin, np.float32)
    return out


def spc_conv_params_from_jax(params):
    """The JAX package's SPC convolution parameters (``Conv3d.init``'s
    dict: ``weight`` (K, Cin, Cout), optional ``bias``) as a state dict for
    the port's ``Conv3d``/``ConvTranspose3d``: the same layout, so the
    arrays are copied as they are."""
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
            params.items()}


def nglod_params_from_jax(params, device="cpu"):
    """An nglod-style field's parameters in the JAX layout, ``{"features":
    (N, F), "decoder": [{"w": (in, out), "b": (out,)}, ...]}`` with ``x @
    w + b`` layers and a ReLU between them → ``{"features": tensor,
    "decoder": nn.Sequential}`` on ``device``, each ``nn.Linear`` holding
    the transposed (out, in) weight."""
    from torch import nn

    layers = []
    for i, layer in enumerate(params["decoder"]):
        w = np.array(layer["w"], np.float32)
        linear = nn.Linear(w.shape[0], w.shape[1], device=device)
        with torch.no_grad():
            linear.weight.copy_(torch.from_numpy(w.T.copy()))
            linear.bias.copy_(torch.from_numpy(np.array(layer["b"],
                                                        np.float32)))
        layers += [nn.ReLU(), linear] if i else [linear]
    return {"features": torch.from_numpy(np.array(
                params["features"], np.float32)).to(device),
            "decoder": nn.Sequential(*layers)}


def dmtet_mlp_from_jax(params, device="cpu"):
    """The DMTet tutorial's MLP (``examples/tutorial_dmtet.py``: a list of
    ``(w (in, out), b (out,))`` with ``x @ w + b`` layers and a ReLU
    between them, numpy or anything ``np.asarray`` takes) → the port's
    ``nn.Sequential`` of ``nn.Linear`` and ``nn.ReLU`` on ``device``
    (``examples/torch_tutorial_dmtet.py``), each Linear holding the
    transposed (out, in) weight."""
    from torch import nn

    layers = []
    for w, b in params:
        w = np.array(w, np.float32)
        linear = nn.Linear(w.shape[0], w.shape[1], device=device)
        with torch.no_grad():
            linear.weight.copy_(torch.from_numpy(w.T.copy()))
            linear.bias.copy_(torch.from_numpy(np.array(b, np.float32)))
        layers += [linear, nn.ReLU()]
    return nn.Sequential(*layers[:-1])


def gaussian_splat_model_from_jax(model, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.rep.GaussianSplatModel` holding
    a JAX ``GaussianSplatModel``'s arrays (through numpy) on ``device``:
    the same point attributes, transform and SH degree."""
    from kaolin_tpu_torch.rep.gaussians import GaussianSplatModel

    def conv(name):
        value = getattr(model, name, None)
        return None if value is None else torch.from_numpy(
            np.array(value, copy=True)).to(device)

    return GaussianSplatModel(
        positions=conv("positions"), orientations=conv("orientations"),
        scales=conv("scales"), opacities=conv("opacities"),
        sh_coeff=conv("sh_coeff"), features=conv("features"),
        transform=conv("transform"), sh_degree=model.sh_degree,
        strict_checks=False)


def bf_spc_from_jax(spc, device="cpu"):
    """A JAX 3-state SPC dict (what ``process_frame`` and ``fuse_bf``
    return: octree, empty, exsum, pyramid, probabilities, colors, normals
    and the int ``level``) as the port's: each array a tensor on
    ``device``, ``level`` an int."""
    out = {k: torch.from_numpy(np.array(v, copy=True)).to(device)
           for k, v in spc.items() if k != "level"}
    out["level"] = int(spc["level"])
    return out


def _tensor_from(value, device):
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def pbr_material_from_jax(material, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.render.materials.PBRMaterial`
    holding a JAX ``PBRMaterial``'s values and textures (through numpy) on
    ``device``, with its name, shader, workflow and colorspaces."""
    from kaolin_tpu_torch.render import materials as tm

    out = tm.PBRMaterial(material_name=material.material_name,
                         shader_name=material.shader_name,
                         is_specular_workflow=material.is_specular_workflow)
    for a in tm._VALUE_ATTRS + tm._TEXTURE_ATTRS:
        value = getattr(material, a)
        setattr(out, a, None if value is None else _tensor_from(value,
                                                                device))
    for a in tm._COLORSPACE_ATTRS:
        setattr(out, a, getattr(material, a))
    return out


def _materials_from_jax(materials, device):
    if materials is None:
        return None
    return [_materials_from_jax(m, device) if isinstance(m, (list, tuple))
            else pbr_material_from_jax(m, device) for m in materials]


def surface_mesh_from_jax(mesh, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.rep.SurfaceMesh` holding every
    tensor attribute a JAX ``SurfaceMesh`` has set (computed ones
    included), through numpy, on ``device``, with its batching, settings
    and materials."""
    from kaolin_tpu_torch.rep import SurfaceMesh

    attrs = {}
    for name in mesh.get_attributes(only_tensors=True):
        value = mesh.get_attribute(name)
        attrs[name] = ([_tensor_from(x, device) for x in value]
                       if isinstance(value, list)
                       else _tensor_from(value, device))
    return SurfaceMesh(
        batching=mesh.batching.value,
        allow_auto_compute=mesh.allow_auto_compute,
        unset_attributes_return_none=mesh.unset_attributes_return_none,
        strict_checks=False,
        materials=_materials_from_jax(mesh.materials, device), **attrs)


def sg_lighting_from_jax(lighting, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.render.lighting.
    SgLightingParameters` holding a JAX one's amplitude, direction and
    sharpness as they are (no renormalization) on ``device``."""
    from kaolin_tpu_torch.render.lighting import SgLightingParameters

    out = SgLightingParameters.__new__(SgLightingParameters)
    out.amplitude = _tensor_from(lighting.amplitude, device)
    out.direction = _tensor_from(lighting.direction, device)
    out.sharpness = _tensor_from(lighting.sharpness, device)
    return out


def graph_conv_from_jax(params, device="cpu"):
    """The port's :class:`~kaolin_tpu_torch.ops.gcn.GraphConv` on
    ``device`` holding a JAX ``GraphConv``'s parameter dict (``w``, and
    ``b``, ``w_self``, ``b_self`` where present), through numpy: the self
    layer and the bias are there when their parameters are."""
    from kaolin_tpu_torch.ops.gcn import GraphConv

    w = np.array(params["w"], np.float32)
    conv = GraphConv(w.shape[0], w.shape[1], self_layer="w_self" in params,
                     bias="b" in params, device=device)
    with torch.no_grad():
        for name in ("w", "b", "w_self", "b_self"):
            if name in params:
                getattr(conv, name).copy_(torch.from_numpy(
                    np.array(params[name], np.float32)))
    return conv
