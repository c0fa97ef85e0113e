"""Sharded Simplicits training and multi-scene simulation.

Counterpart of ``kaolin_tpu/parallel/simplicits.py``.

(a) :func:`sharded_mlp_train_step`: data-parallel loss and gradient over
    sample points. Each rank evaluates the elastic and ortho losses on its
    shard, the gradients and the loss are averaged over the ``"dp"`` axis
    by ``all_reduce``, and the replicated parameters take an SGD step.

(b) :func:`sharded_scene_batch_step`: scene-parallel implicit time
    stepping. Each rank steps its shard of a list of independent scenes as
    one batch, ``torch.func.vmap`` over the scenes' fixed-trip functional
    step. Scenes never communicate.

The scene-side tools (:func:`stack_scenes`, :func:`make_demo_scene`,
:func:`pad_skinned_physics_points`, :func:`bucket_pad_targets`) need no
process group.
"""

import copy

import numpy as np
import torch

from kaolin_tpu_torch.parallel._dist import (
    all_reduce_mean,
    axis_rank_size,
    local_shard,
    sharded,
)
from kaolin_tpu_torch.physics.common.optimization import cholesky_only
from kaolin_tpu_torch.physics.simplicits.losses import (
    loss_elastic,
    loss_ortho,
)
from kaolin_tpu_torch.physics.simplicits.network import mlp_apply

__all__ = ["sharded_mlp_train_step", "sharded_scene_batch_step",
           "pad_skinned_physics_points", "bucket_pad_targets",
           "make_demo_scene", "stack_scenes"]


def bucket_pad_targets(sizes):
    """The smallest (num_qp, num_handles) bucket for a list of
    ``(num_qp, num_handles)`` scene sizes, with the 4 phantom points per
    phantom handle that :func:`pad_skinned_physics_points` needs."""
    h_max = max(h for _, h in sizes)
    qp_max = max(nq + 4 * (h_max - nh) for nq, nh in sizes)
    return qp_max, h_max


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def pad_skinned_physics_points(baked, num_qp, num_handles=None,
                               phantom_origin=(0.0, 1.0e5, 0.0),
                               phantom_spacing=10.0):
    """Pad a ``SkinnedPhysicsPoints`` to ``num_qp`` points and
    ``num_handles`` handles, so that scenes of different sizes share one
    functional-step structure and stack (:func:`stack_scenes`). Built on
    the host in numpy, bit for bit the JAX package's arrays, and returned
    on the device of ``baked.pts``. The padding leaves the real DOFs'
    dynamics as they are, to rounding:

    * phantom points carry zero volume and mass (``num_real_qp`` marks the
      real prefix) and sit in a lattice of tetrahedra at
      ``phantom_origin``, far from the scene;
    * each phantom handle is supported on 4 non-coplanar phantom points
      only, so the LBS operator keeps full column rank (keep
      ``newton_hessian_regularizer > 0``, which keeps the system positive
      definite). The phantom points still move a little: the regularizer
      acts in the QR basis, where phantom and real columns mix (the JAX
      package's docstring says they stay at exactly 0; ROADMAP F38);
    * the constant handle stays last: the phantom handles come before it.
    """
    from kaolin_tpu_torch.physics.simplicits import SkinnedPhysicsPoints

    pts = _host(baked.pts)
    n, h = pts.shape[0], baked.num_handles
    if num_handles is None:
        num_handles = h
    if num_qp < n or num_handles < h:
        raise ValueError(f"pad target ({num_qp} qp, {num_handles} handles) "
                         f"smaller than input ({n} qp, {h} handles)")
    h_pad = num_handles - h
    q_pad = num_qp - n
    if h_pad > 0 and q_pad < 4 * h_pad:
        raise ValueError(
            f"padding {h_pad} handles needs >= {4 * h_pad} phantom points "
            f"to keep the LBS operator full rank; got {q_pad} — raise the "
            f"qp target")
    if q_pad == 0 and h_pad == 0:
        return baked

    dtype = pts.dtype
    tetra = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype)
    reps = -(-q_pad // 4)
    offsets = (np.arange(reps, dtype=dtype)[:, None]
               * np.asarray([phantom_spacing, 0, 0], dtype))
    lattice = (tetra[None] + offsets[:, None]).reshape(-1, 3)[:q_pad]
    ppts = np.asarray(phantom_origin, dtype) + lattice

    pw = np.zeros((q_pad, num_handles), dtype)
    pdw = np.zeros((q_pad, num_handles, 3), dtype)
    for k in range(h_pad):
        pw[4 * k:4 * k + 4, h - 1 + k] = 1.0  # before the constant handle

    w = _host(baked.skinning_weights)
    dw = _host(baked.dwdx)
    w_pad = np.concatenate(
        [w[:, :h - 1], np.zeros((n, h_pad), dtype), w[:, h - 1:]], axis=1)
    dw_pad = np.concatenate(
        [dw[:, :h - 1], np.zeros((n, h_pad, 3), dtype), dw[:, h - 1:]],
        axis=1)

    def per_point(v):
        v = _host(v)
        return np.concatenate([v, np.full(q_pad, v[0], dtype)])

    device = baked.pts.device
    return SkinnedPhysicsPoints(
        *(torch.from_numpy(a).to(device) for a in (
            np.concatenate([pts, ppts]), per_point(baked.yms),
            per_point(baked.prs), per_point(baked.rhos))),
        appx_vol=baked.appx_vol,
        skinning_weights=torch.from_numpy(
            np.concatenate([w_pad, pw])).to(device),
        dwdx=torch.from_numpy(np.concatenate([dw_pad, pdw])).to(device),
        renderable=baked.renderable, num_real_qp=n)


def _draw_transforms(generator, batch_size, num_handles, device):
    """The step's handle transforms 0.1·N(0, 1) (B, H−1, 3, 4), drawn from
    ``generator`` on its device and moved to ``device``."""
    return (0.1 * torch.randn((batch_size, num_handles, 3, 4),
                              generator=generator,
                              device=generator.device)).to(device)


def sharded_mlp_train_step(mesh, params, pts, yms, prs, rhos, appx_vol,
                           generator, batch_size=4, lr=1e-3, en_interp=0.5,
                           le_coeff=1e-1, lo_coeff=1e6, axis_name="dp"):
    """One data-parallel training step of the MLP of
    ``physics.simplicits.network.mlp_init``. ``pts`` (N, 3) and the
    per-point ``yms``, ``prs`` and ``rhos`` are sharded over the mesh's
    ``"dp"`` axis (``DTensor``s sharded on dim 0, or plain global
    tensors); ``params`` are replicated plain tensors, and the transforms
    are drawn from ``generator``, which every rank seeds alike. → (new
    params, loss), both replicated: the loss and the gradients are the
    means over the ranks' shards."""
    local = [local_shard(x, mesh, axis_name) for x in (pts, yms, prs, rhos)]
    leaves = [p[k].detach().requires_grad_(True) for p in params
              for k in ("w", "b")]
    p = [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
         for i in range(len(params))]
    with torch.enable_grad():
        h_learned = mlp_apply(p, local[0][:1]).shape[-1]
        tfms = _draw_transforms(generator, batch_size, h_learned,
                                local[0].device)
        le = le_coeff * loss_elastic(lambda x: mlp_apply(p, x), *local, tfms,
                                     appx_vol, en_interp)
        lo = lo_coeff * loss_ortho(mlp_apply(p, local[0]))
        loss = le + lo
        grads = torch.autograd.grad(loss, leaves)
    grads = [all_reduce_mean(g, mesh, axis_name) for g in grads]
    loss = all_reduce_mean(loss.detach(), mesh, axis_name)
    new = [(a - lr * g).detach() for a, g in zip(leaves, grads)]
    return ([{"w": new[2 * i], "b": new[2 * i + 1]}
             for i in range(len(params))], loss)


def make_demo_scene(seed, num_qp=32, num_handles=3, dt=0.03,
                    with_collision=True, with_kinematic=True,
                    kinematic_qp=16, max_contact_pairs=64,
                    broad_phase="grid", device=None, pad=None):
    """A real :class:`SimplicitsScene` for scene-batch demos and tests, on
    ``device`` (the card when None), from the JAX package's numpy draws:
    one soft body (QR, weights normalized by samples, w = sin(x·f) and the
    constant handle) above a kinematic plate, gravity, a floor at y = −1
    and contact of radius 0.15 with 32 points a cell and 512 cells; 3
    Newton and 5 line-search steps.

    Scenes of the same structural arguments share one functional-step
    structure, so a list of them stacks (:func:`stack_scenes`). ``pad`` =
    (points, handles of the soft body, points of the plate) pads both
    objects by :func:`pad_skinned_physics_points`."""
    from kaolin_tpu_torch.physics.simplicits import (
        SimplicitsScene,
        SkinnedPhysicsPoints,
    )

    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.5, 0.5, (num_qp, 3)).astype(np.float32)
    freqs = rng.randn(3, num_handles - 1).astype(np.float32)
    w = np.concatenate([np.sin(pts @ freqs), np.ones((num_qp, 1), np.float32)],
                       axis=1).astype(np.float32)
    dwdx = np.zeros((num_qp, num_handles, 3), dtype=np.float32)
    dwdx[:, :-1, :] = np.cos(pts @ freqs)[:, :, None] * freqs.T[None]
    soft = SkinnedPhysicsPoints(pts=pts, yms=1e4, prs=0.45, rhos=500.0,
                                appx_vol=1.0, skinning_weights=w, dwdx=dwdx)
    if pad is not None:
        soft = pad_skinned_physics_points(soft, pad[0], pad[1])

    scene = SimplicitsScene(timestep=dt, max_newton_steps=3, max_ls_steps=5,
                            device=device)
    scene.add_object(soft, apply_qr=True, normalize_weights_by_samples=True)

    if with_kinematic:
        # a rigid plate below the soft body: one constant handle, kinematic
        side = int(np.ceil(np.sqrt(kinematic_qp)))
        gx, gz = np.meshgrid(np.linspace(-0.6, 0.6, side),
                             np.linspace(-0.6, 0.6, side))
        kpts = np.stack([gx.ravel(), np.full(side * side, -0.85),
                         gz.ravel()], axis=1)[:kinematic_qp].astype(np.float32)
        kin = SkinnedPhysicsPoints(
            pts=kpts, yms=1e5, prs=0.45, rhos=1000.0, appx_vol=0.1,
            skinning_weights=np.ones((kinematic_qp, 1), np.float32),
            dwdx=np.zeros((kinematic_qp, 1, 3), np.float32))
        if pad is not None:
            kin = pad_skinned_physics_points(kin, pad[2], 1)
        scene.add_object(kin, is_kinematic=True, apply_qr=False,
                         normalize_weights_by_samples=False)

    scene.set_scene_gravity((0.0, 9.8, 0.0))
    scene.set_scene_floor(floor_height=-1.0)
    if with_collision:
        # explicit capacities, so that scenes of the same structural
        # arguments have the same contact shapes whatever their seed
        scene.enable_collisions(collision_particle_radius=0.15,
                                max_contact_pairs=max_contact_pairs,
                                broad_phase=broad_phase,
                                cell_capacity=32,
                                max_occupied_cells=512)
    return scene


# -- the functional step's constants as a tree of tensors --------------------
# A scene's step constants are dicts and lists of tensors and of force
# objects holding tensors. ``_flatten`` walks them (an object through its
# attributes) into the list of tensors and a spec of everything else;
# ``_unflatten`` rebuilds the structure from a spec and tensors, an object
# as a shallow copy with the tensors set.

def _flatten(x, leaves):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return ("dict", tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return (type(x).__name__,
                tuple(_flatten(v, leaves) for v in x))
    if hasattr(x, "__dict__") and not callable(x):
        return ("object", type(x), x, tuple(
            (k, _flatten(v, leaves)) for k, v in vars(x).items()))
    return ("static", x)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    if kind in ("list", "tuple"):
        out = [_unflatten(s, leaves) for s in spec[1]]
        return out if kind == "list" else tuple(out)
    if kind == "object":
        obj = copy.copy(spec[2])
        for k, s in spec[3]:
            setattr(obj, k, _unflatten(s, leaves))
        return obj
    return spec[1]


def _signature(spec):
    """The spec with objects by type and static values compared as numpy
    arrays where they are arrays: what scenes must share to stack."""
    kind = spec[0]
    if kind == "tensor":
        return spec
    if kind == "dict":
        return ("dict", tuple((k, _signature(s)) for k, s in spec[1]))
    if kind in ("list", "tuple"):
        return (kind, tuple(_signature(s) for s in spec[1]))
    if kind == "object":
        return ("object", spec[1], tuple((k, _signature(s))
                                         for k, s in spec[3]))
    v = spec[1]
    if isinstance(v, np.ndarray):
        return ("array", v.shape, v.tobytes())
    return ("static", v if isinstance(v, (int, float, bool, str, type(None),
                                          torch.device, torch.dtype))
            else id(v) if callable(v) else repr(v))


def _flat_steps(scenes):
    """Each scene's fixed-trip step constants flattened → (step of the
    first, [(leaves, spec)]); ValueError where the scenes' structures or
    shapes differ."""
    pairs = [s.build_functional_step(fixed_trip=True) for s in scenes]
    flat = []
    for _, c in pairs:
        leaves = []
        flat.append((leaves, _flatten(c, leaves)))
    sigs = [_signature(spec) for _, spec in flat]
    if any(sig != sigs[0] for sig in sigs[1:]):
        raise ValueError(
            "scenes have different operator shapes (different qp/handle "
            "counts) — pad each object to the bucket maxima with "
            "kaolin_tpu_torch.parallel.simplicits.pad_skinned_physics_points "
            "before add_object, then stack")
    return pairs[0][0], flat


def _stack(flat, scenes, lo, hi):
    """The stacked constants and state of scenes[lo:hi]."""
    stacked = [torch.stack(xs) for xs in zip(*(lv for lv, _ in flat[lo:hi]))]
    state = tuple(torch.stack([getattr(s, k) for s in scenes[lo:hi]])
                  for k in ("sim_z", "sim_z_prev", "sim_z_dot"))
    return _unflatten(flat[0][1], iter(stacked)), state


def stack_scenes(scenes):
    """Stack the functional-step constants of structurally identical
    scenes → ``(step_fn, stacked_consts, (z, z_prev, z_dot))``:
    ``step_fn`` is the scenes' own step of
    :meth:`SimplicitsScene.build_functional_step` in its fixed-trip form
    (Newton's loop runs its set trip, which ``torch.func.vmap`` needs and
    which gives the early-exit loop's z), and every tensor of
    ``stacked_consts`` and of the state gains a leading scene axis."""
    step, flat = _flat_steps(scenes)
    return (step, *_stack(flat, scenes, 0, len(scenes)))


def batch_step(step, consts, z, z_prev, z_dot):
    """One step of every scene of a stack (:func:`stack_scenes`), by
    ``torch.func.vmap`` over the scene axis → stacked (z, z_prev, z_dot).
    The dense solves take the LU solution where a scene's Cholesky failed,
    as its eager step does, with no read back to the host."""
    leaves = []
    spec = _flatten(consts, leaves)

    def one(leaves_i, z_i, zp_i, zd_i):
        return step(_unflatten(spec, iter(leaves_i)), z_i, zp_i, zd_i)

    with cholesky_only(None, with_lu=True):
        return torch.func.vmap(one)(leaves, z, z_prev, z_dot)


def sharded_scene_batch_step(mesh, scenes, state=None, axis_name="dp"):
    """One implicit time step of a batch of independent scenes, the scene
    axis sharded over the mesh. Each rank stacks its shard of ``scenes``
    (every rank is given the whole list, of a length the axis divides) and
    steps it as one batch (:func:`batch_step`): the product simulator with
    contact, kinematic DOFs, the QR basis and Newton with its line search,
    the step of ``run_sim_step``. Scenes never communicate.

    ``state``: an optional stacked ``(z, z_prev, z_dot)``, ``DTensor``s
    sharded on dim 0 or plain global tensors; the scenes' own state when
    None. → the new ``(z, z_prev, z_dot)``, ``DTensor``s sharded on dim
    0."""
    rank, size = axis_rank_size(mesh, axis_name)
    if len(scenes) % size:
        raise ValueError(f"{len(scenes)} scenes do not divide over the "
                         f"{size} ranks of axis {axis_name!r}")
    k = len(scenes) // size
    # every scene's shapes are checked, the rank's own scenes stacked
    step, flat = _flat_steps(scenes)
    consts, local = _stack(flat, scenes, rank * k, (rank + 1) * k)
    if state is not None:
        local = tuple(local_shard(x, mesh, axis_name) for x in state)
    with torch.no_grad():
        out = batch_step(step, consts, *local)
    return tuple(sharded(x, mesh) for x in out)
