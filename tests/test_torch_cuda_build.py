"""Every C entry that a wrapper binds through ``cuda_build.function`` is
declared to ctypes as its ``extern "C"`` prototype in
``kaolin_tpu_torch/**/csrc/*.cu`` declares it: the same number of
arguments, each of the same type.

ctypes trusts the list it is given. A list that no longer matches its
prototype passes the wrong registers and faults, or silently misreads, only
on the card; this holds the lists to the sources on the CPU.
"""

import ast
import ctypes
import importlib
import re
from pathlib import Path

import pytest

from tests.torch_parity import ROOT
from tests.torch_parity import torch_threads_per_worker  # noqa: F401

# the modules that bind the library's entries
WRAPPERS = ("kaolin_tpu_torch.render.mesh.cuda_rasterize",
            "kaolin_tpu_torch.render.mesh.cuda_soft_mask",
            "kaolin_tpu_torch.render.mesh.cuda_texture",
            "kaolin_tpu_torch.render.mesh.cuda_regather",
            "kaolin_tpu_torch.render.spc.cuda_raster",
            "kaolin_tpu_torch.utils.cuda_gather")
# a C parameter's type → its ctypes type
C_TYPES = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong,
           "int*": ctypes.POINTER(ctypes.c_int)}
PROTOTYPE = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def c_prototypes():
    """Every ``extern "C" int`` entry of the port's CUDA sources → [its
    parameters' C types, the name left out]."""
    out = {}
    for path in sorted(Path(ROOT, "kaolin_tpu_torch").glob("**/csrc/*.cu")):
        for name, params in PROTOTYPE.findall(path.read_text()):
            types = []
            for param in params.split(","):
                words = param.replace("*", "* ").split()
                types.append(" ".join(words[:-1]).replace(" *", "*"))
            out[name] = types
    return out


def _string_args(tree, func, position):
    """The string constants passed at ``position`` to calls of ``func``
    in ``tree``."""
    return [c.args[position].value for c in ast.walk(tree)
            if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
            and c.func.id == func and len(c.args) > position
            and isinstance(c.args[position], ast.Constant)]


def bound_entries():
    """Each ``cuda_build.function(name, argtypes)`` call of the wrappers
    → [(C entry, wrapper module, argtypes expression)]. A name given as a
    parameter of the enclosing function is taken from that function's
    callers in the same module."""
    out = []
    for module in WRAPPERS:
        path = Path(ROOT, *module.split(".")).with_suffix(".py")
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            params = [a.arg for a in fn.args.args]
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "function"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "cuda_build"):
                    continue
                first, argtypes = call.args
                names = ([first.value] if isinstance(first, ast.Constant)
                         else _string_args(tree, fn.name,
                                           params.index(first.id)))
                out += [(name, module, ast.unparse(argtypes))
                        for name in names]
    return out


BOUND = bound_entries()


def test_every_entry_is_bound_once():
    """Each wrapper binds an entry, each ``extern "C" int`` entry of the
    sources is bound, and none twice."""
    names = [name for name, _, _ in BOUND]
    assert {module for _, module, _ in BOUND} == set(WRAPPERS)
    assert sorted(names) == sorted(set(names)) == sorted(c_prototypes())


@pytest.mark.parametrize("name,module,argtypes", BOUND,
                         ids=[name for name, _, _ in BOUND])
def test_argtypes_match_c_prototype(name, module, argtypes):
    want = c_prototypes()[name]
    unknown = [t for t in want if t not in C_TYPES]
    assert not unknown, f"{name}: no ctypes type for {unknown}"
    got = eval(argtypes, vars(importlib.import_module(module)))
    assert got == [C_TYPES[t] for t in want], (
        f"{module} binds {name} with {len(got)} arguments {got}; its "
        f"prototype takes {len(want)}: {want}")
