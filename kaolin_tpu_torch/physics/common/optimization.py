"""Projected Newton with a backtracking Armijo line search, in PyTorch.

Counterpart of ``kaolin_tpu/physics/common/optimization.py``. The line
search evaluates every step size it could visit in one batch and replays
the sequential search's grow/shrink/accept automaton in closed form over the
sufficiency bits, so a Newton iteration reads nothing back to the host. The
linear solve is a dense Cholesky with an LU fallback (or a Jacobi-
preconditioned CG); ``torch.linalg``'s ``*_ex`` forms keep their error
checks on the device. A CUDA graph captures the Cholesky alone
(:func:`cholesky_only`) and is run again eagerly where it failed, or, where
failures are common (contact), both solves, taking the LU where the
Cholesky failed.

Two loops:
- ``differentiable=True``: a fixed trip of ``nm_max_iters`` iterations;
  an iteration after convergence leaves x as it is. A CUDA graph can
  capture it.
- otherwise: the same iterations, stopping after the first one that
  converges, which costs one host read an iteration. Both give the same x
  bit for bit.

:func:`newton_iteration` is the loops' set-up and iteration on their own,
for a caller that runs the iterations one at a time over buffers of its
own: the Simplicits scene's CUDA graphs replay an iteration until the
device's convergence flag is set, and so run the early-exit loop's
iterations.

Kinematic DOFs are removed by a static index list (``dyn_idx``).

Spans (:mod:`kaolin_tpu_torch.utils.profiling`, while ``torch.profiler``
runs): each iteration's ``physics.newton.assemble`` (gradient and Hessian),
``physics.newton.solve`` (the reduced solve and the convergence test) and
``physics.newton.line_search`` (the bounds, the search and the update). They
mark host calls: a CUDA graph's replay runs none, so they fire on eager
steps and at a capture.
"""

import contextlib
import contextvars

import numpy as np
import torch

from kaolin_tpu_torch.utils import profiling

__all__ = ["newton_iteration", "newtons_method"]


def _apply_bounds(direction, bounds, ts, qr_tfm, qr_tfm_inv):
    """The step for each size in ``ts`` (K,): the direction (R,) clamped
    elementwise by min(bounds, t), in the pre-QR basis when the QR rotation
    is given → (K, R)."""
    min_bounds = torch.minimum(bounds[None], ts[:, None])
    if qr_tfm is None or qr_tfm_inv is None:
        return direction[None] * min_bounds
    direction_old = qr_tfm @ direction
    return (direction_old[None] * min_bounds) @ qr_tfm_inv.T


_STEP_SIZES = {}


def _step_sizes(beta, m, dtype, device):
    """The grid t = β^k the sequential search can visit, as its chain of
    float32 multiplies and divides makes them: index m is t = 1, indices
    m−1..0 grow by 1/β each, m+1..2m shrink by β each → (2m + 1,).

    Kept once made, so that a CUDA graph capture (which may not copy from
    the host) finds it on the device."""
    key = (float(beta), int(m), dtype, torch.device(device))
    if key not in _STEP_SIZES:
        grow = np.cumprod(np.full(m, 1.0 / beta, np.float32))[::-1]
        shrink = np.cumprod(np.full(m, beta, np.float32))
        ts = np.concatenate([grow, np.ones(1, np.float32), shrink])
        _STEP_SIZES[key] = torch.from_numpy(ts).to(device=device,
                                                   dtype=dtype)
    return _STEP_SIZES[key]


def _line_search(energy_red_fn, x, direction, gradient, bounds,
                 alpha, beta, max_steps, qr_tfm, qr_tfm_inv):
    """Backtracking Armijo line search → the accepted bounded update (R,).

    ``energy_red_fn`` maps a batch of reduced DOF vectors (K, R) to their
    energies (K,): the energy at x and at every step on the grid of
    :func:`_step_sizes` are one call. The sequential search is replayed over
    their sufficiency bits by :func:`_resolve_ls_automaton`."""
    m = max_steps
    ts = _step_sizes(beta, m, x.dtype, x.device)
    bounded_k = _apply_bounds(direction, bounds, ts, qr_tfm, qr_tfm_inv)
    energies = energy_red_fn(
        x + torch.cat([torch.zeros_like(bounded_k[:1]), bounded_k]))
    f, f_k = energies[0], energies[1:]
    suff = f_k <= f + alpha * (bounded_k @ gradient)
    idx = _resolve_ls_automaton(suff, m)
    return bounded_k.index_select(0, idx.reshape(1))[0]


def _resolve_ls_automaton(suff, m):
    """The index the sequential line search accepts, from its sufficiency
    bits ``suff`` (..., 2m + 1) over the step grid → (...) int64.

    The sequential automaton (start at t = 1; on success set can_break and
    grow t/β; on a success with can_break set, accept; on failure shrink
    t·β; after max_steps return the current step) only ever ends at:

    * ``suff[m]``: index m−1 if ``suff[m−1]`` (or m == 1, where the budget
      runs out right after the grow), else back at m;
    * otherwise: the first sufficient index k in [m+1, 2m−1], capped at
      2m−2 by the budget, or 2m if there is none."""
    idx_grid = torch.arange(2 * m + 1, device=suff.device)
    at_m = torch.full_like(suff[..., m], m, dtype=torch.int64)
    if m == 1:
        grow_res = at_m - 1
    else:
        grow_res = torch.where(suff[..., m - 1], at_m - 1, at_m)
    shrink_hits = suff & (idx_grid > m) & (idx_grid <= 2 * m - 1)
    k = torch.argmax(shrink_hits.to(torch.int8), dim=-1)
    found = shrink_hits.any(dim=-1)
    shrink_res = torch.where(found, torch.clamp(k, max=2 * m - 2), 2 * at_m)
    return torch.where(suff[..., m], grow_res, shrink_res)


_FAILED = contextvars.ContextVar("cholesky_failed", default=None)


@contextlib.contextmanager
def cholesky_only(failed, with_lu=False):
    """Inside, :func:`_direct_solve` reads nothing back to the host: it ORs a
    Cholesky failure into ``failed`` (a 0-dim bool tensor) and keeps the
    Cholesky solution, for a CUDA graph whose caller reads ``failed`` after
    a replay and runs the step again eagerly where it is set. With
    ``with_lu`` it also solves by LU every time and takes that solution
    where the Cholesky failed, as the eager solve would: the graph needs
    no step run again, at the LU's cost in every iteration. ``failed``
    None records nothing: with ``with_lu``, the solve of a batch of scenes
    under ``torch.func.vmap``, which reads nothing back either."""
    token = _FAILED.set((failed, with_lu))
    try:
        yield failed
    finally:
        _FAILED.reset(token)


def _direct_solve(red_H, red_g):
    """H⁻¹g by Cholesky; where the factorization fails or its solution is not
    finite (an indefinite H far from a minimum), by LU. The choice reads
    one flag back to the host, unless inside :func:`cholesky_only`.

    The Cholesky reads H's upper triangle, as ``jax.scipy.linalg.cho_factor``
    does: with contact, friction makes H not symmetric, and the two
    triangles give two other systems. It factors Hᵀ's lower triangle (the
    same numbers), which cuSOLVER factors faster than an upper one."""
    L, info = torch.linalg.cholesky_ex(red_H.mT)
    dx = torch.cholesky_solve(red_g[:, None], L)[:, 0]
    failed = (info != 0) | ~torch.isfinite(dx).all()
    deferred = _FAILED.get()
    if deferred is not None:
        flag, with_lu = deferred
        if flag is not None:
            flag.logical_or_(failed)
        if with_lu:
            dx = torch.where(failed, torch.linalg.solve_ex(red_H, red_g)[0],
                             dx)
    elif bool(failed):
        dx = torch.linalg.solve_ex(red_H, red_g)[0]
    return dx


def _cg_solve(red_H, red_g, tol, maxiter):
    """Jacobi-preconditioned CG from 0, with the stopping rule of
    ``jax.scipy.sparse.linalg.cg``: stop when r·r ≤ tol²·g·g or after
    ``maxiter`` iterations. It runs ``maxiter`` iterations; those after the
    stop leave its state as it is."""
    diag = torch.clamp(torch.diagonal(red_H), min=1e-8)
    atol2 = tol * tol * (red_g @ red_g)
    x = torch.zeros_like(red_g)
    r = red_g
    z = r / diag
    p = z
    gamma = r @ z
    for _ in range(maxiter):
        live = (r @ r) > atol2
        Ap = red_H @ p
        alpha = gamma / (p @ Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = r_ / diag
        gamma_ = r_ @ z_
        p_ = z_ + (gamma_ / gamma) * p
        x, r, gamma, p = (torch.where(live, a, b) for a, b in
                          ((x_, x), (r_, r), (gamma_, gamma), (p_, p)))
    return x


def newton_iteration(x,
                     energy_fcn,
                     gradient_fcn,
                     hessian_fcn,
                     bounds_fcn=None,
                     dyn_idx=None,
                     cg_tol=1e-4,
                     cg_iters=100,
                     conv_tol=1e-4,
                     direct_solve=True,
                     ls_alpha=1e-3,
                     ls_beta=0.6,
                     max_ls_steps=10,
                     bounds_qr_tfm=None,
                     bounds_qr_tfm_inv=None):
    """Newton's set-up at the start point x → ``newton_iter(x_cur,
    converged) -> (x_new, converged)``, one iteration of
    :func:`newtons_method` (the arguments are its own): the assembly, the
    solve, the convergence test on the Newton decrement at ``x_cur`` and
    the line search; where ``converged`` (a 0-dim bool tensor) is or
    becomes set, x_new is ``x_cur``. The kinematic DOFs keep their values
    at x. Nothing is read back to the host, but for the solve's fallback
    outside :func:`cholesky_only`."""
    d = x.shape[0]
    all_dynamic = dyn_idx is None or len(dyn_idx) == d
    if all_dynamic:
        def red_to_full(red):
            return red

        def full_to_red(full):
            return full
        x_kinematic = None
    else:
        dyn = torch.as_tensor(dyn_idx, dtype=torch.int64, device=x.device)

        def red_to_full(red):
            return red.new_zeros(red.shape[:-1] + (d,)).index_copy(-1, dyn,
                                                                    red)

        def full_to_red(full):
            return full.index_select(-1, dyn)
        x_kinematic = x - red_to_full(full_to_red(x))
    batched_energy = torch.func.vmap(energy_fcn)

    def energy_red(red):
        full = red_to_full(red)
        return batched_energy(full if x_kinematic is None
                              else full + x_kinematic)

    def newton_iter(x_cur, converged):
        with profiling.span("physics.newton.assemble"):
            g = gradient_fcn(x_cur)
            H = hessian_fcn(x_cur)
            red_H = H if all_dynamic else H.index_select(0, dyn).index_select(
                1, dyn)
            red_g = full_to_red(g)
            red_x = full_to_red(x_cur)
        with profiling.span("physics.newton.solve"):
            if direct_solve:
                red_dx = -_direct_solve(red_H, red_g)
            else:
                red_dx = -_cg_solve(red_H, red_g, cg_tol, cg_iters)
            converged = converged | (torch.abs(red_dx @ red_g) < conv_tol)
        with profiling.span("physics.newton.line_search"):
            if bounds_fcn is None:
                # unit bounds clamp every DOF alike, which the rotation
                # leaves as it is; a nearly singular one would lose the
                # step to float32 cancellation
                bounds, qr, qr_inv = torch.ones_like(red_x), None, None
            else:
                bounds = full_to_red(bounds_fcn(red_to_full(red_dx), x_cur))
                qr, qr_inv = bounds_qr_tfm, bounds_qr_tfm_inv
            update = _line_search(energy_red, red_x, red_dx, red_g, bounds,
                                  ls_alpha, ls_beta, max_ls_steps, qr,
                                  qr_inv)
            red_x = torch.where(converged, red_x, red_x + update)
        x_new = red_to_full(red_x)
        if x_kinematic is not None:
            x_new = x_new + x_kinematic
        return x_new, converged

    return newton_iter


def newtons_method(x,
                   energy_fcn,
                   gradient_fcn,
                   hessian_fcn,
                   bounds_fcn=None,
                   dyn_idx=None,
                   nm_max_iters=5,
                   cg_tol=1e-4,
                   cg_iters=100,
                   conv_tol=1e-4,
                   direct_solve=True,
                   ls_alpha=1e-3,
                   ls_beta=0.6,
                   max_ls_steps=10,
                   bounds_qr_tfm=None,
                   bounds_qr_tfm_inv=None,
                   differentiable=False):
    """Minimize an implicit-integration energy over the DOFs x.

    Args:
        x: (D,) initial guess (full DOF vector).
        energy_fcn: x → scalar; the line search calls it through
            ``torch.func.vmap``.
        gradient_fcn: x → (D,).
        hessian_fcn: x → (D, D) dense.
        bounds_fcn: (dx_full, x) → (D,) per-DOF step bounds, or None.
        dyn_idx: the dynamic (non-kinematic) DOFs, an int array or an
            int64 tensor, or None for all. A tensor on x's device is used as
            it is: nothing is copied from the host, which a CUDA graph
            capture needs.
        direct_solve: dense Cholesky (LU where it fails) vs CG.
        bounds_qr_tfm / bounds_qr_tfm_inv: (R, R) reduced-basis rotation for
            clamping bounds in the raw pre-QR basis (with ``bounds_fcn``
            only).
        differentiable: run the fixed trip of ``nm_max_iters`` iterations
            with no host read (see the module docstring).

    Returns:
        (D,) optimized DOFs. ``newtons_method.iterations`` counts the
        iterations run on the host, over all calls.
    """
    newton_iter = newton_iteration(
        x, energy_fcn, gradient_fcn, hessian_fcn, bounds_fcn=bounds_fcn,
        dyn_idx=dyn_idx, cg_tol=cg_tol, cg_iters=cg_iters, conv_tol=conv_tol,
        direct_solve=direct_solve, ls_alpha=ls_alpha, ls_beta=ls_beta,
        max_ls_steps=max_ls_steps, bounds_qr_tfm=bounds_qr_tfm,
        bounds_qr_tfm_inv=bounds_qr_tfm_inv)
    converged = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(nm_max_iters):
        x, converged = newton_iter(x, converged)
        newtons_method.iterations += 1
        if not differentiable and bool(converged):
            break
    return x


newtons_method.iterations = 0
