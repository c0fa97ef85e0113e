"""The port's recipes (``examples/recipes/torch_*.py``) against the JAX
recipes, on the CPU.

Each JAX recipe runs as a script and each torch recipe's ``main("cpu")``
as a function, their standard output captured: every printed integer
equal, every printed float within 1e-5, the words between them the same.
The inputs are the same numpy; where the JAX recipe draws from a key
(``mesh_sampling``'s face choices), the port's draw is patched to return
JAX's, and the sparse ``Conv3d`` of ``spc_basics`` takes the weights of
JAX's ``conv.init``; the values behind the printed shapes (the conv's
output, the camera's projection and pose gradient) are held within 1e-5
too.
"""

import contextlib
import io
import os
import re
import runpy

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    ROOT,
    jax_unoptimized,
    torch_threads_per_worker,
    warm_torch_exp,
)

NUMBER = re.compile(r"-?\d+(?:\.\d*)?(?:e[-+]?\d+)?")

pytestmark = pytest.mark.usefixtures("jax_unoptimized")


def run_jax(name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        env = runpy.run_path(os.path.join(ROOT, "examples", "recipes",
                                          f"{name}.py"))
    return out.getvalue(), env


def run_port(name, **kw):
    mod = runpy.run_path(os.path.join(ROOT, "examples", "recipes",
                                      f"torch_{name}.py"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        values = mod["main"]("cpu", **kw)
    return out.getvalue(), values


def same_print(got, want):
    # numpy widens a column for a sign: the words between the numbers are
    # compared with their spacing aside
    assert " ".join(NUMBER.sub("#", got).split()) == \
        " ".join(NUMBER.sub("#", want).split()), (got, want)
    for g, w in zip(NUMBER.findall(got), NUMBER.findall(want)):
        if re.fullmatch(r"-?\d+", w):
            assert int(g) == int(w), (g, w)
        else:
            tol = 1e-5 * max(1.0, abs(float(w)))
            assert abs(float(g) - float(w)) <= tol, (g, w)


def host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("name", ["quaternions", "spc_from_pointcloud"])
def test_recipe_prints_as_jax(name):
    want, _ = run_jax(name)
    got, _ = run_port(name)
    same_print(got, want)


def test_mesh_sampling_prints_as_jax(monkeypatch):
    from kaolin_tpu_torch.ops.mesh import trianglemesh
    want, env = run_jax("mesh_sampling")
    choices = torch.from_numpy(np.array(env["choices"]))
    monkeypatch.setattr(trianglemesh, "_choose_faces",
                        lambda gen, areas, n: choices.to(areas.device))
    got, values = run_port("mesh_sampling")
    same_print(got, want)
    np.testing.assert_array_equal(host(values["inside"]),
                                  host(env["inside"]))


def test_spc_basics_prints_as_jax():
    want, env = run_jax("spc_basics")
    got, values = run_port("spc_basics",
                           conv_weight=np.asarray(env["params"]["weight"]))
    same_print(got, want)
    np.testing.assert_array_equal(host(values["octree"]), host(env["octree"]))
    np.testing.assert_allclose(host(values["y"]), host(env["y"]), rtol=0,
                               atol=1e-5)


def test_camera_recipes_print_as_jax():
    want, env = run_jax("camera_recipes")
    got, values = run_port("camera_recipes")
    same_print(got, want)
    np.testing.assert_allclose(host(values["clip"]), host(env["clip"]),
                               rtol=0, atol=1e-5)
    g_want = host(env["g"])
    np.testing.assert_allclose(host(values["grad"]), g_want, rtol=0,
                               atol=1e-5 * np.abs(g_want).max())


def test_recipes_on_the_card_without_one():
    """Without ``cpu`` named a recipe runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mod = runpy.run_path(os.path.join(ROOT, "examples", "recipes",
                                      "torch_quaternions.py"))
    with pytest.raises(RuntimeError, match="CUDA"):
        mod["main"]()
